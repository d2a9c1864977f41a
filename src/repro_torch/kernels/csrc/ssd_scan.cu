// Mamba2 SSD chunk scan, emitting the output and the final state, for sm_90a.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel
// _ssd_kernel).  Same function: for each (batch b, head h) and chunk of CL
// steps, with la = dt * A[h], cum = cumsum(la) and xdt = x * dt,
//   y     = (C.B^T o L) . xdt + exp(cum) * (C . state^T),  L[l,s] = exp(cum_l - cum_s) for l >= s
//   state = state * exp(cum_last) + (exp(cum_last - cum) * xdt)^T . B
// with x [b, l, h, p], dt [b, l, h] fp32, A [h] fp32 and B, C [b, l, n]
// shared by every head.  The Pallas kernel keeps the state in VMEM across a
// sequential chunk grid and drops it at the end; here it is written out as
// final_state [b, h, p, n] fp32, which the LM prefill hands to decode.  Both
// kernels below run one block per (b, h, tile of PT rows of the state over
// p): the state's rows are independent, and a loop over chunks inside the
// block replaces the Pallas kernel's sequential grid axis.
//
// Bound on the H100 SXM: bytes.  At the mamba2-130m prefill shape (b 4,
// l 512, 24 heads of 64, state 128, chunk 64, bf16) the function needs 1.73
// GFLOP (1.75 us at the 989 TFLOP/s bf16 peak, 25.8 us at the 67 TFLOP/s
// fp32 FMA peak) over 17.0 MB (5.07 us at 3.35 TB/s): only the tensor cores
// bring the arithmetic under the bytes.
//
// bf16: ssd_scan_mma_bf16_kernel<N, PT>, on the tensor cores (chunk 16, 32
// or 64; state width N 64 or 128; p a multiple of 16; 16-byte-aligned rows
// of x, B and C).  What held the SIMT kernel below at 134x its bound, and
// what this one does about each:
// - Every FMA read both operands from shared memory.  Here the four chunk
//   products run on mma.sync m16n8k16 (bf16 operands, fp32 accumulators):
//   G = C.B^T, Y = exp(cum) * (C . S^T) + (G o L o dt) . x and
//   dS = x^T . (w o B), w[s] = exp(cum_last - cum_s) dt_s.  C, B and x are
//   bf16 as stored, so they enter as they are.  The other operands, G o L
//   o dt (G's accumulator fragments scaled and masked in registers), w o B
//   (B's fragments scaled in registers) and the state, are fp32 and go in
//   as TERMS bf16 terms each (split_pair), one product a term: with one
//   term (a rounding to bf16) a third of the bf16 outputs came out a
//   rounding away from the plain version's, and mamba2-130m's random-weight
//   bf16 logits, which carry such differences through 24 layers, moved by
//   0.11 of max |logit| (PERF.md); three terms carry fp32's 24 bits.  The
//   carried state stays in fp32 registers, as accumulator fragments of dS,
//   decayed there.
// - C.B^T was recomputed per head on the SIMT pipes.  It still is, once per
//   block, on the tensor cores and only on and below the diagonal: the
//   R(R+1)/2 16 x 16 tiles (10 at chunk 64) are spread over all 8 warps and
//   kept in fp32 in shared memory.  The tiles and the state go there in the
//   order of the fragments that read them, so a lane reads its own float4s
//   and no ldmatrix or bank conflict is needed.
// - 96 blocks on 132 SMs.  The p tile PT is 16, 32 or 64 rows, picked per
//   shape by the wrapper's plan so that at least a block per SM launches
//   (mamba2: PT 32, 192 blocks, two an SM).
// - One thread's cumulative sum and five barriers a chunk.  Each warp scans
//   the chunk's log decays with shuffles into its own shared-memory row
//   (cum, exp(cum), w); two barriers a chunk remain, one for the ring stage
//   and the state, one for C.B^T.
// - Element-wise loads with a division each.  x, B, C and dt stream through
//   a 2-stage cp.async ring (16-byte copies of x, B and C rows, 4-byte
//   copies of dt), the next chunk's copies issued before this chunk's
//   products.  Rows are padded by 16 bytes, so the eight rows an ldmatrix
//   phase reads fall in distinct banks.
// Warps specialise after C.B^T: warps 0-3 compute the output in 16 x 16
// tiles (Y, the (row tile, column block) pairs of the chunk and p tile);
// warps 4-7 carry the state, N / 4 columns each over every row of the p
// tile, and store it for the next chunk's C.S^T between its two barriers,
// when no warp reads it.  Each role runs its own chunk loop with the same
// barriers, so the state's registers are live only in the state warps'
// loop and no variant spills at the blocks an SM its shared memory allows.
// What bounds it now (scripts/ssd_probe.py's parts, PERF.md): the
// products, about four fifths of the time at mamba2, most of them the
// output warps' (C.S^T over the whole state width, three terms each); the
// output warps are the longer role, so a warp's two row tiles share each
// split of S at state width 128.  mma.sync's rate on the H100 is far
// below wgmma's, and C.B^T is recomputed by every block.  Then the copies:
// every block reads its batch's B and C (32 of the 37 KB a chunk), 57 MB
// through L2 a call.
//
// fp32 (and bf16 outside the shapes above): ssd_scan_kernel<T>, fp32 FMA on
// the SIMT pipes over shared memory (TF32 would break the reference's 2e-3),
// one block of 256 threads per (b, h, <= 64-row p tile).  Each chunk stages
// B, C and x*dt as fp32 in shared memory (rows padded to n + 1), forms the
// masked decay matrix C.B^T o L once, then the output tile and the state
// update; the fp32 state tile stays in shared memory across chunks.
//
// The backward (no Pallas kernel of the reference has one: the reference
// trains through XLA's gradient of blocks.ssd_chunked): dx, ddt, dA, dB and
// dC from x, dt, A, B, C, dy and the final state's gradient, the formulas of
// kernels/ssd_scan.py::ssd_scan_bwd_plain.  Bound on the H100 SXM: bytes.
// At mamba2-130m's training shape (the prefill's, bf16) it needs 5.3 GFLOP
// with the states recomputed (5.3 us at the bf16 peak, 79 us at the fp32
// FMA peak) over 21 MB (6.4 us).  ssd_scan_bwd_kernel<T> is correct first
// and simple, fp32 FMA on the SIMT pipes over shared memory, one block of
// 256 threads per (b, h, <= 64-row p tile) as the forward's SIMT kernel:
// - the chunks run in order twice: forward, to rebuild the state entering
//   each chunk into a scratch buffer (the block's own rows; the forward
//   runs twice a layer under remat, so it keeps no copy for the backward),
//   then in reverse, carrying the state's gradient dH in shared memory;
// - per chunk, the two [CL, CL] panels C.B^T and dy.xdt (and from them
//   C.B^T o L, (dy.xdt) o L and their product), then dx (the block's own
//   rows over p), dC, dB and the chunk's log-decay gradient; every product
//   in register tiles, a warp 8 rows, a lane 2 columns (tile_product): the
//   first version, an output a thread, read 2-3 operands from shared
//   memory an FMA and took 1.77 ms at mamba2, this one 8 broadcasts and 2
//   loads for 16 FMAs (PERF.md);
// - dB and dC sum over heads and p tiles, ddt over p tiles, dA over
//   batches and positions: each block writes its partials (fp32, [b, l,
//   h * p tiles, n] for dB and dC) and ssd_scan_bwd_sum_kernel adds them
//   in index order.  No atomics: two calls give the same bits.
// What bounds it: shared-memory loads and their latency at one block of 8
// warps an SM (217 KB of shared memory at state 128, 210 registers), and
// 96 blocks on 132 SMs at mamba2; next, the products on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct SsdShape {
  int b, l, h, p, n, chunk, pt;  // pt: state rows (over p) per block
  long long sxb, sxl, sxh;       // element strides of x (p is unit)
  long long sdb, sdl, sdh;       // of dt
  long long sBb, sBl, sCb, sCl;  // of B and C (n is unit)
};

// ---------------------------------------------------------------------------
// fp32: FMA on the SIMT pipes
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ inline int smem_floats(int cl, int n, int pt) {
  return 2 * cl * (n + 1) + pt * (n + 1) + cl * pt + cl * cl + 3 * cl;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, SsdShape s) {
  extern __shared__ __align__(16) float smem[];
  const int CL = s.chunk, N = s.n, PT = s.pt, LDN = s.n + 1;
  float* Bs = smem;             // [CL][LDN]
  float* Cs = Bs + CL * LDN;    // [CL][LDN]
  float* St = Cs + CL * LDN;    // [PT][LDN] the carried state, fp32
  float* Xs = St + PT * LDN;    // [CL][PT]  x * dt
  float* G = Xs + CL * PT;      // [CL][CL]  C.B^T o L, zero above the diagonal
  float* cum = G + CL * CL;     // [CL]      cumulative log decay
  float* wend = cum + CL;       // [CL]      exp(cum_last - cum)
  float* dts = wend + CL;       // [CL]

  const int tid = threadIdx.x;
  const int n_pt = (s.p + PT - 1) / PT;
  const int bh = blockIdx.x / n_pt;
  const int bi = bh / s.h, hi = bh % s.h;
  const int p0 = (blockIdx.x % n_pt) * PT;
  const float a_h = A[hi];

  for (int e = tid; e < PT * LDN; e += THREADS) St[e] = 0.f;

  const int n_chunks = s.l / CL;
  for (int c = 0; c < n_chunks; ++c) {
    const long long l0 = (long long)c * CL;
    for (int e = tid; e < CL * N; e += THREADS) {
      const int r = e / N, col = e % N;
      Bs[r * LDN + col] = to_f(Bm[bi * s.sBb + (l0 + r) * s.sBl + col]);
      Cs[r * LDN + col] = to_f(Cm[bi * s.sCb + (l0 + r) * s.sCl + col]);
    }
    for (int e = tid; e < CL; e += THREADS) dts[e] = dt[bi * s.sdb + (l0 + e) * s.sdl + hi * s.sdh];
    __syncthreads();  // dts ready; also orders this chunk's stores after the last chunk's reads

    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < CL; ++r) {
        run += dts[r] * a_h;
        cum[r] = run;
      }
    }
    for (int e = tid; e < CL * PT; e += THREADS) {
      const int r = e / PT, pp = e % PT;
      float xv = 0.f;
      if (p0 + pp < s.p) xv = to_f(x[bi * s.sxb + (l0 + r) * s.sxl + hi * s.sxh + p0 + pp]);
      Xs[e] = xv * dts[r];
    }
    __syncthreads();

    for (int e = tid; e < CL; e += THREADS) wend[e] = expf(cum[CL - 1] - cum[e]);
    for (int e = tid; e < CL * CL; e += THREADS) {
      const int r = e / CL, sc = e % CL;
      float g = 0.f;
      if (sc <= r) {
        for (int nn = 0; nn < N; ++nn) g = fmaf(Cs[r * LDN + nn], Bs[sc * LDN + nn], g);
        g *= expf(cum[r] - cum[sc]);
      }
      G[e] = g;
    }
    __syncthreads();

    for (int e = tid; e < CL * PT; e += THREADS) {
      const int r = e / PT, pp = e % PT;
      if (p0 + pp >= s.p) continue;
      float intra = 0.f;
      for (int sc = 0; sc <= r; ++sc) intra = fmaf(G[r * CL + sc], Xs[sc * PT + pp], intra);
      float inter = 0.f;
      for (int nn = 0; nn < N; ++nn) inter = fmaf(Cs[r * LDN + nn], St[pp * LDN + nn], inter);
      const long long off = ((bi * (long long)s.l + l0 + r) * s.h + hi) * s.p + p0 + pp;
      put(y + off, intra + expf(cum[r]) * inter);
    }
    __syncthreads();  // every read of the old state is done

    const float dec = expf(cum[CL - 1]);
    for (int e = tid; e < PT * N; e += THREADS) {
      const int pp = e / N, nn = e % N;
      float add = 0.f;
      for (int r = 0; r < CL; ++r) add = fmaf(wend[r] * Xs[r * PT + pp], Bs[r * LDN + nn], add);
      St[pp * LDN + nn] = St[pp * LDN + nn] * dec + add;
    }
    __syncthreads();
  }

  for (int e = tid; e < PT * N; e += THREADS) {
    const int pp = e / N, nn = e % N;
    if (p0 + pp < s.p) state_out[((bi * (long long)s.h + hi) * s.p + p0 + pp) * N + nn] = St[pp * LDN + nn];
  }
}

template <typename T>
int launch_simt(const void* x, const float* dt, const float* A, const void* B, const void* C, void* y,
                float* state, const SsdShape& s, cudaStream_t stream) {
  const int smem = smem_floats(s.chunk, s.n, s.pt) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_pt = (s.p + s.pt - 1) / s.pt;
  ssd_scan_kernel<T><<<(unsigned)(s.b * s.h * n_pt), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      state, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

// scripts/ssd_probe.py builds copies with -DSSD_PROBE=1 (the loads alone: no
// products), 2 (the products alone: no loads), 3 (no state update) and 4 (no
// output rows), to show which part bounds the kernel; 0 ships.
#ifndef SSD_PROBE
#define SSD_PROBE 0
#endif
// The bf16 terms each product operand that is not exact in bf16 is split
// into (C.B^T o L o dt, w o B, the state): each term is the rounding of
// what the earlier ones left, so K terms carry 8K bits of the fp32 value.
// scripts/ssd_probe.py and scripts/ssd_lm_sensitivity.py build 1 and 2 to
// compare; 3 ships.
#ifndef SSD_TERMS
#define SSD_TERMS 3
#endif
static_assert(SSD_TERMS >= 1 && SSD_TERMS <= 3, "1 to 3 bf16 terms");

constexpr int TERMS = SSD_TERMS;
constexpr int MMA_WARPS = 8;
constexpr int OUT_WARPS = 4;  // warps 0-3 compute the output, 4-7 carry the state
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int STAGES = 2;            // the copy ring: chunk c is read while chunk c + 1 lands
constexpr int MAX_CL = 64;           // chunks of 16, 32 or 64
constexpr int MAX_TILES = (MAX_CL / 16) * (MAX_CL / 16 + 1) / 2;  // 16 x 16 tiles on and below the diagonal
constexpr int PAD = 8;               // row padding in elements (16 bytes)

// Bytes of one ring stage: x [CL][PT + PAD], B and C [CL][N + PAD] bf16, dt [CL] fp32.
__host__ __device__ constexpr int stage_bytes(int cl, int n, int pt) {
  return cl * ((pt + PAD) + 2 * (n + PAD)) * 2 + cl * 4;
}

// The ring, the state [PT][N] and the tiles of C.B^T o L o dt in fp32 (both
// in fragment order), and each warp's factors (cum, exp(cum), w) over the chunk.
__host__ __device__ constexpr int mma_smem_bytes(int cl, int n, int pt) {
  return STAGES * stage_bytes(cl, n, pt) + pt * n * 4 + MAX_TILES * 256 * 4 + MMA_WARPS * 3 * MAX_CL * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// (a, b) as TERMS packed bf16 pairs whose sum is (a, b) to 8 * TERMS bits:
// each pair is the rounding of what the earlier ones left, which fp32 holds exactly.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&out)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    a -= f.x;
    b -= f.y;
  }
}

// One chunk in shared memory, as the warps of a block read it.
struct Chunk {
  const bf16 *Xs, *Bs, *Cs;  // x [CL][PT + PAD], B and C [CL][N + PAD]
  const float* Ds;           // dt [CL]
  const float *cum, *ecum;   // this warp's cum and exp(cum) over the chunk
};

// Tile (r, q) of C.B^T o L o dt (rows 16r.., columns 16q.., q <= r) into Gf
// in fp32, masked above the diagonal, in the order of an A fragment: lane l
// writes its two float4 (columns 2t, 2t + 1 of rows g, g + 8; then 8 columns
// on) at [tile][half][l], which the lane of the same number reads back.
// Each step's fragments are loaded while the step before is multiplied.
template <int N>
__device__ __forceinline__ void g_tile(const Chunk& k, int r, int q, float4* Gf, int lane) {
  constexpr int LDN = N + PAD;
  const int g = lane / 4, t = lane % 4;
  float acc[2][4] = {};
  uint32_t cf[2][4], bf[2][4];
  auto fetch = [&](int kk, int buf) {
    ldmatrix_x4(cf[buf], k.Cs + (r * 16 + lane % 16) * LDN + kk * 16 + (lane / 16) * 8);
    ldmatrix_x4(bf[buf], k.Bs + (q * 16 + (lane / 16) * 8 + lane % 8) * LDN + kk * 16 + ((lane / 8) % 2) * 8);
  };
  fetch(0, 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    if (kk + 1 < N / 16) fetch(kk + 1, (kk + 1) % 2);
    mma_bf16(acc[0], cf[kk % 2], bf[kk % 2][0], bf[kk % 2][1]);
    mma_bf16(acc[1], cf[kk % 2], bf[kk % 2][2], bf[kk % 2][3]);
  }
  const int i0 = r * 16 + g, i1 = i0 + 8;
  const float ci0 = k.cum[i0], ci1 = k.cum[i1];
  float4* out = Gf + (r * (r + 1) / 2 + q) * 64 + lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = q * 16 + h * 8 + 2 * t;
    const float cj0 = k.cum[j], cj1 = k.cum[j + 1], d0 = k.Ds[j], d1 = k.Ds[j + 1];
    out[h * 32] = make_float4(j <= i0 ? acc[h][0] * expf(ci0 - cj0) * d0 : 0.f,
                              j + 1 <= i0 ? acc[h][1] * expf(ci0 - cj1) * d1 : 0.f,
                              j <= i1 ? acc[h][2] * expf(ci1 - cj0) * d0 : 0.f,
                              j + 1 <= i1 ? acc[h][3] * expf(ci1 - cj1) * d1 : 0.f);
  }
}

// Output rows 16r .. 16r + 15 for each r of rs, columns 16cb .. 16cb + 15
// of the p tile:
//   y = exp(cum) * (C . S^T) + (C.B^T o L o dt) . x
// with S the fp32 state before the chunk (Sf, skipped for the first chunk,
// whose state is zero) and the tiles of Gf up to the diagonal, each split
// into TERMS bf16 fragments; the M row tiles share each split of S.  Each
// term has its own accumulators, so the products of one step do not wait
// on each other, and each step's fragments are loaded while the step
// before is multiplied.  yg: this lane's output row g of row tile 0 at
// the tile's column 0, ld: elements from one step's row to the next's;
// cols: valid columns (p - p0).
template <int N, int PT, int M>
__device__ __forceinline__ void y_tiles(const Chunk& k, const int (&rs)[M], int cb, const float4* Sf, bool has_state,
                                        const float4* Gf, bf16* yg, long long ld, int cols, int lane) {
  constexpr int LDX = PT + PAD, LDN = N + PAD;
  const int g = lane / 4, t = lane % 4;
  float acc[M][TERMS][2][4] = {};  // C.S^T first, then from term 0 on y
  if (has_state) {
    uint32_t cf[2][M][4];
    float4 sv[2][2];  // state rows (p) 16cb + g and 16cb + 8 + g
    auto fetch = [&](int kk, int buf) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        ldmatrix_x4(cf[buf][m], k.Cs + (rs[m] * 16 + lane % 16) * LDN + kk * 16 + (lane / 16) * 8);
      sv[buf][0] = Sf[(cb * 2 * (N / 16) + kk) * 32 + lane];
      sv[buf][1] = Sf[((cb * 2 + 1) * (N / 16) + kk) * 32 + lane];
    };
    fetch(0, 0);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      if (kk + 1 < N / 16) fetch(kk + 1, (kk + 1) % 2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 v = sv[kk % 2][hh];
        uint32_t s0[TERMS], s1[TERMS];
        split_pair(v.x, v.y, s0);
        split_pair(v.z, v.w, s1);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int i = 0; i < TERMS; ++i) mma_bf16(acc[m][i][hh], cf[kk % 2][m], s0[i], s1[i]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float e0 = k.ecum[rs[m] * 16 + g], e1 = k.ecum[rs[m] * 16 + g + 8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int i = TERMS - 1; i >= 0; --i) {
            sum += acc[m][i][h][e];
            acc[m][i][h][e] = 0.f;
          }
          acc[m][0][h][e] = sum * (e < 2 ? e0 : e1);
        }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = rs[m];
    float4 gv[2][2];
    uint32_t xf[2][4];
    auto fetch = [&](int q, int buf) {
      const float4* tile = Gf + (r * (r + 1) / 2 + q) * 64 + lane;
      gv[buf][0] = tile[0];   // rows g, g + 8 at columns 2t, 2t + 1
      gv[buf][1] = tile[32];  // ... at columns 8 + 2t, 9 + 2t
      ldmatrix_x4_trans(xf[buf], k.Xs + (q * 16 + lane % 16) * LDX + cb * 16 + (lane / 16) * 8);
    };
    fetch(0, 0);
#pragma unroll
    for (int q = 0; q < MAX_CL / 16; ++q) {
      if (q > r) break;
      if (q + 1 <= r) fetch(q + 1, (q + 1) % 2);
      uint32_t a0[TERMS], a1[TERMS], a2[TERMS], a3[TERMS];
      split_pair(gv[q % 2][0].x, gv[q % 2][0].y, a0);  // row g, columns 2t, 2t + 1
      split_pair(gv[q % 2][0].z, gv[q % 2][0].w, a1);  // row g + 8
      split_pair(gv[q % 2][1].x, gv[q % 2][1].y, a2);  // row g, columns 8 + 2t, 9 + 2t
      split_pair(gv[q % 2][1].z, gv[q % 2][1].w, a3);  // row g + 8
#pragma unroll
      for (int i = 0; i < TERMS; ++i) {
        const uint32_t gf[4] = {a0[i], a1[i], a2[i], a3[i]};
        mma_bf16(acc[m][i][0], gf, xf[q % 2][0], xf[q % 2][1]);
        mma_bf16(acc[m][i][1], gf, xf[q % 2][2], xf[q % 2][3]);
      }
    }
    bf16* y0 = yg + 16LL * r * ld;
    bf16* y1 = y0 + 8 * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int i = TERMS - 1; i >= 0; --i) sum += acc[m][i][h][e];
        v[e] = sum;
      }
      const int col = cb * 16 + h * 8 + 2 * t;
      if (col < cols) {
        *reinterpret_cast<__nv_bfloat162*>(y0 + col) = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(y1 + col) = __floats2bfloat162_rn(v[2], v[3]);
      }
    }
  }
}

// state += x^T . (w o B) over a chunk of ks 16-step slices, on this warp's
// CPW 16-column blocks (from column c0) and every m16 tile of the p tile:
// the decay and dt, w[s] = exp(cum_last - cum_s) dt_s, scale B's fragments
// in fp32, split into TERMS bf16 fragments, so x enters as stored.
template <int N, int PT>
__device__ __forceinline__ void state_update(float (&sacc)[N / 64][PT / 16][2][4], const Chunk& k, const float* w,
                                             int ks, int c0, int lane) {
  constexpr int LDN = N + PAD, LDX = PT + PAD;
  const int t = lane % 4;
  for (int kk = 0; kk < ks; ++kk) {
    const int s0 = kk * 16 + 2 * t;
    const float w0 = w[s0], w1 = w[s0 + 1], w8 = w[s0 + 8], w9 = w[s0 + 9];
    uint32_t af[PT / 16][4];
#pragma unroll
    for (int mt = 0; mt < PT / 16; ++mt)
      ldmatrix_x4_trans(af[mt], k.Xs + (kk * 16 + lane % 8 + (lane / 16) * 8) * LDX + mt * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, k.Bs + (kk * 16 + lane % 16) * LDN + c0 + j * 16 + (lane / 16) * 8);
      uint32_t b[4][TERMS];  // k rows s0, s0 + 1 and s0 + 8, s0 + 9 of columns g and 8 + g
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[e]));
        split_pair(f.x * (e % 2 ? w8 : w0), f.y * (e % 2 ? w9 : w1), b[e]);
      }
#pragma unroll
      for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
        for (int i = TERMS - 1; i >= 0; --i) {
          mma_bf16(sacc[j][mt][0], af[mt], b[0][i], b[1][i]);
          mma_bf16(sacc[j][mt][1], af[mt], b[2][i], b[3][i]);
        }
    }
  }
}

// Blocks of <N, PT> one SM holds at chunk 64 by shared memory (228 KB, 1 KB
// of it reserved a block): two, or one for <128, 64>, which may then use
// twice the registers.
__host__ __device__ constexpr int mma_min_blocks(int n, int pt) {
  return 2 * (mma_smem_bytes(MAX_CL, n, pt) + 1024) <= 228 * 1024 ? 2 : 1;
}

template <int N, int PT>
__global__ void __launch_bounds__(MMA_THREADS, mma_min_blocks(N, PT))
ssd_scan_mma_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                         const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, bf16* __restrict__ y,
                         float* __restrict__ state_out, SsdShape s) {
  constexpr int LDN = N + PAD, LDX = PT + PAD;
  constexpr int CPW = N / 64;  // 16-column blocks of the state a warp owns
  static_assert(N % 64 == 0 && PT % 16 == 0 && OUT_WARPS % (PT / 16) == 0, "whole fragments");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CL = s.chunk, R = CL / 16;  // R: 16-row tiles of a chunk
  const int sbytes = stage_bytes(CL, N, PT);
  float4* Sf = reinterpret_cast<float4*>(smem_raw + STAGES * sbytes);  // [PT / 8][N / 16][32 lanes]
  float4* Gf = Sf + PT * N / 4;                                        // [MAX_TILES][2][32 lanes]
  float* fac = reinterpret_cast<float*>(Gf + MAX_TILES * 64);          // [WARPS][3][MAX_CL]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4;
  const int n_pt = (s.p + PT - 1) / PT;
  const int bh = blockIdx.x / n_pt;
  const int bi = bh / s.h, hi = bh % s.h;
  const int p0 = (blockIdx.x % n_pt) * PT;
  const float a_h = A[hi];
  const int n_chunks = s.l / CL;
  const bf16* xb = x + bi * s.sxb + hi * s.sxh + p0;
  const bf16* Bb = Bm + bi * s.sBb;
  const bf16* Cb = Cm + bi * s.sCb;
  const float* db = dt + bi * s.sdb + hi * s.sdh;

  auto load_chunk = [&](int c, int stage) {
    if (SSD_PROBE == 2) return;
    bf16* Xs = reinterpret_cast<bf16*>(smem_raw + stage * sbytes);
    bf16* Bs = Xs + CL * LDX;
    bf16* Cs = Bs + CL * LDN;
    float* Ds = reinterpret_cast<float*>(Cs + CL * LDN);
    const long long l0 = (long long)c * CL;
    for (int e = tid; e < CL * (PT / 8); e += MMA_THREADS) {
      const int r = e / (PT / 8), col = (e % (PT / 8)) * 8;
      const bool ok = p0 + col < s.p;  // a ragged p tile: zero-filled past p
      cp_async16(Xs + r * LDX + col, ok ? xb + (l0 + r) * s.sxl + col : x, ok ? 16 : 0);
    }
#pragma unroll 1
    for (int e = tid; e < CL * (N / 8); e += MMA_THREADS) {
      const int r = e / (N / 8), col = (e % (N / 8)) * 8;
      cp_async16(Bs + r * LDN + col, Bb + (l0 + r) * s.sBl + col, 16);
      cp_async16(Cs + r * LDN + col, Cb + (l0 + r) * s.sCl + col, 16);
    }
    for (int e = tid; e < CL; e += MMA_THREADS) cp_async4(Ds + e, db + (l0 + e) * s.sdl);
  };

  load_chunk(0, 0);
  cp_async_commit();
  for (int e = tid; e < PT * N / 4; e += MMA_THREADS) Sf[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  float* cumw = fac + warp * 3 * MAX_CL;  // this warp's cum, exp(cum) and w over the chunk
  float* ecw = cumw + MAX_CL;
  float* wfw = ecw + MAX_CL;

  // What every warp does in chunk c before its role's part: wait for the
  // chunk and issue the copies of the next one, run `between` (the state
  // warps store the state after chunk c - 1 there: no warp reads Sf until
  // the second barrier, and none reads it for chunk c - 1 after the first),
  // scan the chunk's log decays into its own factors, compute its tiles of
  // C.B^T o L o dt into Gf, and wait for the whole of Gf and Sf.  Returns
  // the chunk and cum's last value.
  auto front = [&](int c, Chunk& k, auto&& between) -> float {
    const int stage = c % STAGES;
    cp_async_wait<0>();  // chunk c has landed (this thread's copies)
    __syncthreads();     // ... everyone's; chunk c - 1 is no longer read
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) % STAGES);
    cp_async_commit();
    between();

    const bf16* Xs = reinterpret_cast<const bf16*>(smem_raw + stage * sbytes);
    const bf16* Bs = Xs + CL * LDX;
    const bf16* Cs = Bs + CL * LDN;
    const float* Ds = reinterpret_cast<const float*>(Cs + CL * LDN);
    k = Chunk{Xs, Bs, Cs, Ds, cumw, ecw};

    // cum over the chunk, every warp its own copy: lane holds steps lane and lane + 32
    float v0 = lane < CL ? Ds[lane] * a_h : 0.f;
    float v1 = lane + 32 < CL ? Ds[lane + 32] * a_h : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, off), u1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float last = __shfl_sync(0xffffffffu, CL > 32 ? v1 : v0, (CL - 1) % 32);
    if (lane < CL) {
      cumw[lane] = v0;
      ecw[lane] = expf(v0);
      wfw[lane] = expf(last - v0) * Ds[lane];
    }
    if (lane + 32 < CL) {
      cumw[lane + 32] = v1;
      ecw[lane + 32] = expf(v1);
      wfw[lane + 32] = expf(last - v1) * Ds[lane + 32];
    }
    __syncwarp();

    // the R(R+1)/2 tiles of C.B^T o L o dt on and below the diagonal, over all warps
    if (SSD_PROBE != 1 && SSD_PROBE != 4) {
      for (int tile = warp; tile < R * (R + 1) / 2; tile += MMA_WARPS) {
        int r = 0;
        while ((r + 1) * (r + 2) / 2 <= tile) ++r;
        g_tile<N>(k, r, tile - r * (r + 1) / 2, Gf, lane);
      }
    }
    __syncthreads();  // Gf and Sf are whole
    return last;
  };

  if (warp < OUT_WARPS) {
    // the output's (16-row tile, 16-column block) tiles of every chunk, over warps 0 .. OUT_WARPS - 1
    for (int c = 0; c < n_chunks; ++c) {
      Chunk k;
      front(c, k, [] {});
      if (SSD_PROBE == 1 || SSD_PROBE == 4) continue;
      // this warp's column block and row tiles r0, r0 + RSTEP, ...; at state width 128, in
      // pairs that share S's splits (at 64 the pairs' registers would spill)
      constexpr int CBS = PT / 16, RSTEP = OUT_WARPS / CBS, PAIR = N >= 128 ? 2 : 1;
      const int cb = warp % CBS, r0 = warp / CBS;
      bf16* yg = y + (((long long)bi * s.l + (long long)c * CL + g) * s.h + hi) * s.p + p0;
      const long long ld = (long long)s.h * s.p;
      for (int r = r0; r < R; r += PAIR * RSTEP) {
        if constexpr (PAIR == 2) {
          if (r + RSTEP < R) {
            const int rs[2] = {r, r + RSTEP};
            y_tiles<N, PT, 2>(k, rs, cb, Sf, c > 0, Gf, yg, ld, s.p - p0, lane);
            continue;
          }
        }
        const int rs[1] = {r};
        y_tiles<N, PT, 1>(k, rs, cb, Sf, c > 0, Gf, yg, ld, s.p - p0, lane);
      }
    }
  } else {
    // the carried state, fp32 in registers over warps OUT_WARPS .. MMA_WARPS - 1: rows
    // mt*16 + g (+ 8), columns c0 + j*16 + h*8 + 2t (+ 1), each warp N / 4 columns from c0
    const int c0 = (warp - OUT_WARPS) * (N / 4);
    float sacc[CPW][PT / 16][2][4] = {};
    // the state into Sf in the order of C.S^T's B fragments: lane l of 8-row block pb and
    // 16-column block nb holds rows 8pb + g, columns 16nb + 2t, 2t + 1, 8 + 2t, 9 + 2t
    auto store_state = [&] {
#pragma unroll
      for (int j = 0; j < CPW; ++j)
#pragma unroll
        for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            Sf[((mt * 2 + half) * (N / 16) + c0 / 16 + j) * 32 + lane] =
                make_float4(sacc[j][mt][0][2 * half], sacc[j][mt][0][2 * half + 1], sacc[j][mt][1][2 * half],
                            sacc[j][mt][1][2 * half + 1]);
    };
    for (int c = 0; c < n_chunks; ++c) {
      Chunk k;
      const float dec = expf(front(c, k, [&] {
        if (c > 0) store_state();  // the state after chunk c - 1
      }));
#pragma unroll
      for (int j = 0; j < CPW; ++j)
#pragma unroll
        for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[j][mt][h][e] *= dec;
      if (SSD_PROBE != 1 && SSD_PROBE != 3) state_update<N, PT>(sacc, k, wfw, R, c0, lane);
    }
    float* so = state_out + ((long long)bi * s.h + hi) * s.p * N;
    const int t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = p0 + mt * 16 + g + half * 8;
        if (row >= s.p) continue;
#pragma unroll
        for (int j = 0; j < CPW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(so + (long long)row * N + c0 + j * 16 + h * 8 + 2 * t) =
                make_float2(sacc[j][mt][h][half * 2], sacc[j][mt][h][half * 2 + 1]);
      }
  }
  cp_async_wait<0>();
}

template <int N, int PT>
cudaError_t allow_smem(int cl, int* smem) {
  *smem = mma_smem_bytes(cl, N, PT);
  return cudaFuncSetAttribute(ssd_scan_mma_bf16_kernel<N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int N, int PT>
int launch_mma(const void* x, const float* dt, const float* A, const void* B, const void* C, void* y, float* state,
               const SsdShape& s, cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err = allow_smem<N, PT>(s.chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  const int n_pt = (s.p + PT - 1) / PT;
  ssd_scan_mma_bf16_kernel<N, PT><<<(unsigned)(s.b * s.h * n_pt), MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<bf16*>(y), state, s);
  return (int)cudaGetLastError();
}

template <int N, int PT>
int occupancy_mma(int cl) {
  int smem = 0;
  const cudaError_t attr = allow_smem<N, PT>(cl, &smem);
  if (attr != cudaSuccess) return -(int)attr;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_scan_mma_bf16_kernel<N, PT>, MMA_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Calls F<N, PT>(...) for the compiled variants; cudaErrorInvalidValue otherwise.
#define SSD_MMA_VARIANTS(F, ...)                      \
  switch (n * 1000 + pt) {                            \
    case 64016: return F<64, 16>(__VA_ARGS__);        \
    case 64032: return F<64, 32>(__VA_ARGS__);        \
    case 64064: return F<64, 64>(__VA_ARGS__);        \
    case 128016: return F<128, 16>(__VA_ARGS__);      \
    case 128032: return F<128, 32>(__VA_ARGS__);      \
    case 128064: return F<128, 64>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;       \
  }

// ---------------------------------------------------------------------------
// The backward: fp32 FMA on the SIMT pipes
// ---------------------------------------------------------------------------

// Shared memory of one ssd_scan_bwd_kernel block, in floats: B, C, x and dy
// of a chunk, the state entering it and its gradient, three [CL][CL] panels,
// seven per-step vectors and the reduction's scratch.  Rows are padded by one
// float, so a warp reading a column touches 32 banks.
__host__ __device__ inline int bwd_smem_floats(int cl, int n, int pt) {
  return 2 * cl * (n + 1) + 2 * cl * (pt + 1) + 2 * pt * (n + 1) + 3 * cl * (cl + 1) + 7 * cl + 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);  // every lane the same bits
  return v;
}

// Every thread gets the block's sum of v, in one fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Chunk c's B (and with GRADS C), dt, x (and dy) of one backward block into
// shared memory as fp32 (x and dy 0 past p), then cum, exp(cum) and
// exp(cum_last - cum); ends on a barrier.
template <typename T, bool GRADS>
__device__ __forceinline__ void bwd_load_chunk(const T* __restrict__ x, const float* __restrict__ dt,
                                               const T* __restrict__ Bm, const T* __restrict__ Cm,
                                               const T* __restrict__ dy, const SsdShape& s, long long sdyb,
                                               long long sdyl, long long sdyh, int c, int bi, int hi, int p0,
                                               float a_h, float* Bs, float* Cs, float* Xs, float* Ys, float* dts,
                                               float* cum, float* ecum, float* wend) {
  const int CL = s.chunk, N = s.n, PT = s.pt, LDN = N + 1, LDP = PT + 1, tid = threadIdx.x;
  const long long l0 = (long long)c * CL;
  for (int e = tid; e < CL * N; e += THREADS) {
    const int r = e / N, col = e % N;
    Bs[r * LDN + col] = to_f(Bm[bi * s.sBb + (l0 + r) * s.sBl + col]);
    if (GRADS) Cs[r * LDN + col] = to_f(Cm[bi * s.sCb + (l0 + r) * s.sCl + col]);
  }
  for (int e = tid; e < CL; e += THREADS) dts[e] = dt[bi * s.sdb + (l0 + e) * s.sdl + hi * s.sdh];
  for (int e = tid; e < CL * PT; e += THREADS) {
    const int r = e / PT, pp = e % PT;
    const bool in = p0 + pp < s.p;
    Xs[r * LDP + pp] = in ? to_f(x[bi * s.sxb + (l0 + r) * s.sxl + hi * s.sxh + p0 + pp]) : 0.f;
    if (GRADS) Ys[r * LDP + pp] = in ? to_f(dy[bi * sdyb + (l0 + r) * sdyl + hi * sdyh + p0 + pp]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int r = 0; r < CL; ++r) {
      run += dts[r] * a_h;
      cum[r] = run;
    }
  }
  __syncthreads();
  for (int e = tid; e < CL; e += THREADS) {
    ecum[e] = expf(cum[e]);
    wend[e] = expf(cum[CL - 1] - cum[e]);
  }
  __syncthreads();
}

// Thread (warp w, lane q) of a backward block holds rows w + 8 i (i < 8) and
// columns c0 + q + 32 j (j < 2) of an [M, NC] product over K, M <= 64, a
// tile of 64 columns from c0: acc[i][j] += sum_k a(row_i, k) b(k, col_j).
// Each k loads 8 values of a (the same for the whole warp: a broadcast) and
// 2 of b (neighbouring lanes on neighbouring columns) for 16 FMAs.  Rows and
// columns past M and NC repeat the last one; their results are dropped.  A
// product over 128 columns (state width 128) takes two tiles: with 4
// columns a thread, ptxas held the kernel to 255 registers and spilled.
constexpr int TROWS = 8, TCOLS = 2;
static_assert(THREADS / 32 * TROWS == 64 && 32 * TCOLS == 64, "8 warps of 8 rows, 32 lanes of 2 columns");

template <class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[TROWS][TCOLS], int M, int NC, int c0, int K, FA a, FB b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int rows[TROWS], cols[TCOLS];
#pragma unroll
  for (int i = 0; i < TROWS; ++i) rows[i] = min(warp + 8 * i, M - 1);
#pragma unroll
  for (int j = 0; j < TCOLS; ++j) cols[j] = min(c0 + lane + 32 * j, NC - 1);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[TROWS], bv[TCOLS];
#pragma unroll
    for (int i = 0; i < TROWS; ++i) av[i] = a(rows[i], k);
#pragma unroll
    for (int j = 0; j < TCOLS; ++j) bv[j] = b(k, cols[j]);
#pragma unroll
    for (int i = 0; i < TROWS; ++i)
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[TROWS][TCOLS]) {
#pragma unroll
  for (int i = 0; i < TROWS; ++i)
#pragma unroll
    for (int j = 0; j < TCOLS; ++j) acc[i][j] = 0.f;
}

// One block per (b, h, tile of PT rows over p), as the forward.  Pass 1 runs
// the forward's state recurrence and writes the state entering each chunk to
// `hs` (this block's [nc][PT][n] slice).  Pass 2 walks the chunks in reverse
// with the state's gradient dH in shared memory.  dx is the block's own; dB,
// dC (summed over heads and p tiles), ddt (over p tiles) and dA (over b and
// p tiles) are written as this block's partials, which ssd_scan_bwd_sum_kernel
// adds in a fixed order: no atomics, so two calls give the same bits.  Every
// product is in register tiles (tile_product): chunk and PT are at most 64,
// the state width at most 128.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)  // with no minimum, ptxas holds it to 80 registers and spills
ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ dstate, T* __restrict__ dx, float* __restrict__ hs,
                    float* __restrict__ pdB, float* __restrict__ pdC, float* __restrict__ pddt,
                    float* __restrict__ pdA, SsdShape s, long long sdyb, long long sdyl, long long sdyh) {
  extern __shared__ __align__(16) float smem[];
  const int CL = s.chunk, N = s.n, PT = s.pt, LDN = N + 1, LDP = PT + 1, LDC = CL + 1;
  float* Bs = smem;              // [CL][LDN]
  float* Cs = Bs + CL * LDN;     // [CL][LDN]
  float* Xs = Cs + CL * LDN;     // [CL][LDP] x (0 past p)
  float* Ys = Xs + CL * LDP;     // [CL][LDP] dy (0 past p)
  float* Hs = Ys + CL * LDP;     // [PT][LDN] the state entering the chunk
  float* dH = Hs + PT * LDN;     // [PT][LDN] the gradient of the state leaving it
  float* Gd = dH + PT * LDN;     // [CL][LDC] (C_l.B_s) L[l,s], L[l,s] = exp(cum_l - cum_s), 0 above the diagonal
  float* Wm = Gd + CL * LDC;     // [CL][LDC] (dy_l.xdt_s) L[l,s]
  float* Mm = Wm + CL * LDC;     // [CL][LDC] (C_l.B_s) (dy_l.xdt_s) L[l,s]
  float* dts = Mm + CL * LDC;    // [CL]
  float* cum = dts + CL;         // [CL] the in-chunk cumulative log decay
  float* ecum = cum + CL;        // [CL] exp(cum)
  float* wend = ecum + CL;       // [CL] exp(cum_last - cum)
  float* ddir = wend + CL;       // [CL] dxdt_s . x_s
  float* yoff = ddir + CL;       // [CL] d(cum_l) from the carried state's output
  float* supd = yoff + CL;       // [CL] d(cum_s) lost to the state update's weight
  float* red = supd + CL;        // [32]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_pt = (s.p + PT - 1) / PT;
  const int t = blockIdx.x % n_pt, bh = blockIdx.x / n_pt;
  const int bi = bh / s.h, hi = bh % s.h;
  const int p0 = t * PT;
  const float a_h = A[hi];
  const int nc = s.l / CL;
  const int J = s.h * n_pt;  // partial rows of dB and dC per position
  float* hsb = hs + (long long)blockIdx.x * nc * PT * N;
  float acc[TROWS][TCOLS], acc2[TROWS][TCOLS];  // acc2: the second of two [CL, CL] or [CL, PT] products
  // the row and the column of a tile's element (i, j), its columns from c0
#define BWD_ROW(i) (warp + 8 * (i))
#define BWD_COL(j) (c0 + lane + 32 * (j))

  // pass 1: the state entering each chunk, as the forward carries it
  for (int e = tid; e < PT * LDN; e += THREADS) Hs[e] = 0.f;
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    for (int e = tid; e < PT * N; e += THREADS) hsb[(long long)c * PT * N + e] = Hs[(e / N) * LDN + e % N];
    bwd_load_chunk<T, false>(x, dt, Bm, Cm, dy, s, sdyb, sdyl, sdyh, c, bi, hi, p0, a_h, Bs, Cs, Xs, Ys, dts, cum, ecum,
                             wend);
    const float dec = ecum[CL - 1];
    for (int c0 = 0; c0 < N; c0 += 64) {
      zero(acc);  // [PT, N] += (x wend dt)^T . B
      tile_product(acc, PT, N, c0, CL, [=](int pp, int r) { return Xs[r * LDP + pp] * (wend[r] * dts[r]); },
                   [=](int r, int nn) { return Bs[r * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < TCOLS; ++j)
          if (BWD_ROW(i) < PT && BWD_COL(j) < N) {
            float& h = Hs[BWD_ROW(i) * LDN + BWD_COL(j)];
            h = h * dec + acc[i][j];
          }
    }
    __syncthreads();
  }

  // the final state's gradient, and <dH, H> of the state leaving the last chunk
  float part = 0.f;
  for (int e = tid; e < PT * N; e += THREADS) {
    const int pp = e / N, nn = e % N;
    float g = 0.f;
    if (dstate != nullptr && p0 + pp < s.p) g = dstate[((bi * (long long)s.h + hi) * s.p + p0 + pp) * N + nn];
    dH[pp * LDN + nn] = g;
    part = fmaf(g, Hs[pp * LDN + nn], part);
  }
  float carry = block_sum(part, red);  // d(cum_last) of the chunk below from the state leaving it
  float dA_acc = 0.f;

  // pass 2: the chunks in reverse
  for (int c = nc - 1; c >= 0; --c) {
    const long long l0 = (long long)c * CL;
    for (int e = tid; e < PT * N; e += THREADS) Hs[(e / N) * LDN + e % N] = hsb[(long long)c * PT * N + e];
    bwd_load_chunk<T, true>(x, dt, Bm, Cm, dy, s, sdyb, sdyl, sdyh, c, bi, hi, p0, a_h, Bs, Cs, Xs, Ys, dts, cum, ecum,
                            wend);
    // the [CL, CL] panels: C.B^T and dy.x, then Gd, Wm and Mm from both, each thread its own elements
    int c0 = 0;  // the [CL, CL] and [CL, PT] products are one tile of columns
    zero(acc);
    zero(acc2);
    tile_product(acc, CL, CL, 0, N, [=](int r, int nn) { return Cs[r * LDN + nn]; },
                 [=](int nn, int sc) { return Bs[sc * LDN + nn]; });
    tile_product(acc2, CL, CL, 0, PT, [=](int r, int pp) { return Ys[r * LDP + pp]; },
                 [=](int pp, int sc) { return Xs[sc * LDP + pp]; });
#pragma unroll
    for (int i = 0; i < TROWS; ++i)
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) {
        const int r = BWD_ROW(i), sc = BWD_COL(j);
        if (r >= CL || sc >= CL) continue;
        float g = 0.f, w = 0.f, m = 0.f;
        if (sc <= r) {
          const float dec = expf(cum[r] - cum[sc]), d = acc2[i][j] * dts[sc];
          g = acc[i][j] * dec;
          w = d * dec;
          m = d * g;
        }
        Gd[r * LDC + sc] = g;
        Wm[r * LDC + sc] = w;
        Mm[r * LDC + sc] = m;
      }
    __syncthreads();

    // dxdt_s = sum_{l>=s} Gd[l,s] dy_l + wend_s (dH.B_s); dx = dxdt dt; rows s, columns over p
    zero(acc);
    zero(acc2);
    tile_product(acc, CL, PT, 0, N, [=](int sr, int nn) { return Bs[sr * LDN + nn]; },
                 [=](int nn, int pp) { return dH[pp * LDN + nn]; });
    tile_product(acc2, CL, PT, 0, CL, [=](int sr, int r) { return Gd[r * LDC + sr]; },
                 [=](int r, int pp) { return Ys[r * LDP + pp]; });
#pragma unroll
    for (int i = 0; i < TROWS; ++i) {
      const int sr = min(BWD_ROW(i), CL - 1);
      float dd = 0.f, su = 0.f;
#pragma unroll
      for (int j = 0; j < TCOLS; ++j) {
        const int pp = BWD_COL(j);
        if (pp >= PT) continue;
        const float dxdt = acc2[i][j] + wend[sr] * acc[i][j], xv = Xs[sr * LDP + pp];
        if (BWD_ROW(i) < CL && p0 + pp < s.p)
          put(dx + ((bi * (long long)s.l + l0 + sr) * s.h + hi) * s.p + p0 + pp, dxdt * dts[sr]);
        dd = fmaf(dxdt, xv, dd);
        su = fmaf(xv * dts[sr], acc[i][j], su);
      }
      dd = warp_sum(dd);
      su = warp_sum(su);
      if (lane == 0 && BWD_ROW(i) < CL) {
        ddir[sr] = dd;
        supd[sr] = wend[sr] * su;
      }
    }
    // dC_l = sum_{s<=l} Wm[l,s] B_s + exp(cum_l) dy_l.H; rows l, columns over n, 64 at a time
    float yo[TROWS] = {};
    for (c0 = 0; c0 < N; c0 += 64) {
      zero(acc);
      tile_product(acc, CL, N, c0, PT, [=](int r, int pp) { return Ys[r * LDP + pp]; },
                   [=](int pp, int nn) { return Hs[pp * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i) {
        const int r = min(BWD_ROW(i), CL - 1);
#pragma unroll
        for (int j = 0; j < TCOLS; ++j) {
          acc[i][j] *= ecum[r];
          if (BWD_COL(j) < N) yo[i] = fmaf(Cs[r * LDN + BWD_COL(j)], acc[i][j], yo[i]);
        }
      }
      tile_product(acc, CL, N, c0, CL, [=](int r, int sc) { return Wm[r * LDC + sc]; },
                   [=](int sc, int nn) { return Bs[sc * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < TCOLS; ++j)
          if (BWD_ROW(i) < CL && BWD_COL(j) < N)
            pdC[((bi * (long long)s.l + l0 + BWD_ROW(i)) * J + hi * n_pt + t) * N + BWD_COL(j)] = acc[i][j];
    }
#pragma unroll
    for (int i = 0; i < TROWS; ++i) {
      const float v = warp_sum(yo[i]);
      if (lane == 0 && BWD_ROW(i) < CL) yoff[BWD_ROW(i)] = v;
    }
    // dB_s = sum_{l>=s} Wm[l,s] C_l + wend_s dt_s x_s.dH; rows s, columns over n, 64 at a time
    for (c0 = 0; c0 < N; c0 += 64) {
      zero(acc);
      tile_product(acc, CL, N, c0, PT, [=](int sr, int pp) { return Xs[sr * LDP + pp]; },
                   [=](int pp, int nn) { return dH[pp * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i) {
        const int sr = min(BWD_ROW(i), CL - 1);
#pragma unroll
        for (int j = 0; j < TCOLS; ++j) acc[i][j] *= wend[sr] * dts[sr];
      }
      tile_product(acc, CL, N, c0, CL, [=](int sr, int r) { return Wm[r * LDC + sr]; },
                   [=](int r, int nn) { return Cs[r * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < TCOLS; ++j)
          if (BWD_ROW(i) < CL && BWD_COL(j) < N)
            pdB[((bi * (long long)s.l + l0 + BWD_ROW(i)) * J + hi * n_pt + t) * N + BWD_COL(j)] = acc[i][j];
    }
    __syncthreads();  // every read of dH, Gd and the per-step vectors is done

    // d(cum): the masked decay's row minus its column, the carried state's output, the state update's
    // weight, and at the last step <dH, H> of the state leaving the chunk
    float* dcum = Gd;  // Gd is no longer read
    if (tid < CL) {
      float row = 0.f, col = 0.f;
      for (int sc = 0; sc <= tid; ++sc) row += Mm[tid * LDC + sc];
      for (int r = tid; r < CL; ++r) col += Mm[r * LDC + tid];
      dcum[tid] = row - col + yoff[tid] - supd[tid] + (tid == CL - 1 ? carry : 0.f);
    }
    // dH of the state entering this chunk, and <dH, H> of it for the chunk below
    const float dec = ecum[CL - 1];
    part = 0.f;
    for (c0 = 0; c0 < N; c0 += 64) {
      zero(acc);  // [PT, N] += (dy exp(cum))^T . C
      tile_product(acc, PT, N, c0, CL, [=](int pp, int r) { return Ys[r * LDP + pp] * ecum[r]; },
                   [=](int r, int nn) { return Cs[r * LDN + nn]; });
#pragma unroll
      for (int i = 0; i < TROWS; ++i)
#pragma unroll
        for (int j = 0; j < TCOLS; ++j)
          if (BWD_ROW(i) < PT && BWD_COL(j) < N) {
            float& g = dH[BWD_ROW(i) * LDN + BWD_COL(j)];
            g = g * dec + acc[i][j];
            part = fmaf(g, Hs[BWD_ROW(i) * LDN + BWD_COL(j)], part);
          }
    }
    carry = block_sum(part, red);  // its barriers also publish dcum
    if (tid == 0) {  // ddt = (reverse cumulative sum of d(cum)) A + dxdt.x; dA gets that sum times dt
      float run = 0.f;
      for (int r = CL - 1; r >= 0; --r) {
        run += dcum[r];
        pddt[((bi * (long long)s.l + l0 + r) * s.h + hi) * n_pt + t] = run * a_h + ddir[r];
        dA_acc = fmaf(run, dts[r], dA_acc);
      }
    }
    __syncthreads();
  }
  if (tid == 0) pdA[(bi * (long long)s.h + hi) * n_pt + t] = dA_acc;
#undef BWD_ROW
#undef BWD_COL
}

// dB, dC [b, l, n] (T): the partials over heads and p tiles; ddt [b, l, h]: over p tiles; dA [h]: over
// batches and p tiles; each summed in index order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_bwd_sum_kernel(const float* __restrict__ pdB, const float* __restrict__ pdC,
                        const float* __restrict__ pddt, const float* __restrict__ pdA, T* __restrict__ dB,
                        T* __restrict__ dC, float* __restrict__ ddt, float* __restrict__ dA, int b, int l, int h,
                        int n, int n_pt) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nbl = (long long)b * l * n, ndt = (long long)b * l * h;
  const int J = h * n_pt;
  if (i < nbl) {
    const long long bl = i / n, nn = i % n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < J; ++j) {
      sb += pdB[(bl * J + j) * n + nn];
      sc += pdC[(bl * J + j) * n + nn];
    }
    put(dB + i, sb);
    put(dC + i, sc);
  } else if (i < nbl + ndt) {
    const long long k = i - nbl;
    float v = 0.f;
    for (int j = 0; j < n_pt; ++j) v += pddt[k * n_pt + j];
    ddt[k] = v;
  } else if (i < nbl + ndt + h) {
    const int hh = (int)(i - nbl - ndt);
    float v = 0.f;
    for (int bb = 0; bb < b; ++bb)
      for (int j = 0; j < n_pt; ++j) v += pdA[((long long)bb * h + hh) * n_pt + j];
    dA[hh] = v;
  }
}

template <typename T>
int launch_bwd(const void* x, const float* dt, const float* A, const void* B, const void* C, const void* dy,
               const float* dstate, void* dx, float* ddt, float* dA, void* dB, void* dC, float* hs, float* pdB,
               float* pdC, float* pddt, float* pdA, const SsdShape& s, long long sdyb, long long sdyl,
               long long sdyh, cudaStream_t stream) {
  if (s.chunk > 64 || s.pt > 64 || s.n > 128) return (int)cudaErrorInvalidValue;  // a tile's rows and columns
  const int smem = bwd_smem_floats(s.chunk, s.n, s.pt) * (int)sizeof(float);
  auto kernel = ssd_scan_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_pt = (s.p + s.pt - 1) / s.pt;
  kernel<<<(unsigned)(s.b * s.h * n_pt), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const T*>(dy),
      dstate, static_cast<T*>(dx), hs, pdB, pdC, pddt, pdA, s, sdyb, sdyl, sdyh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)s.b * s.l * s.n + (long long)s.b * s.l * s.h + s.h;
  ssd_scan_bwd_sum_kernel<T><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      pdB, pdC, pddt, pdA, static_cast<T*>(dB), static_cast<T*>(dC), ddt, dA, s.b, s.l, s.h, s.n, n_pt);
  return (int)cudaGetLastError();
}

int launch_mma_variant(int n, int pt, const void* x, const float* dt, const float* A, const void* B, const void* C,
                       void* y, float* state, const SsdShape& s, cudaStream_t stream) {
  SSD_MMA_VARIANTS(launch_mma, x, dt, A, B, C, y, state, s, stream)
}

int occupancy_mma_variant(int n, int pt, int cl) { SSD_MMA_VARIANTS(occupancy_mma, cl) }

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted).  route 0 runs ssd_scan_kernel<float>, 1 ssd_scan_kernel<bf16>, 2
// ssd_scan_mma_bf16_kernel<n, pt> (x, B, C and y bf16 there); dt, A and
// state are float32.  y is contiguous [b, l, h, p], state contiguous
// [b, h, p, n].  Shapes, routes and the shared-memory size are validated by
// the Python wrapper.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B, const void* C,
                            void* y, float* state, int route, int b, int l, int h, int p, int n, int chunk,
                            int pt, long long sxb, long long sxl, long long sxh, long long sdb, long long sdl,
                            long long sdh, long long sBb, long long sBl, long long sCb, long long sCl,
                            void* stream) {
  const SsdShape s{b, l, h, p, n, chunk, pt, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) return launch_simt<float>(x, dt, A, B, C, y, state, s, st);
  if (route == 1) return launch_simt<bf16>(x, dt, A, B, C, y, state, s, st);
  if (route == 2 && chunk % 16 == 0 && chunk <= MAX_CL)
    return launch_mma_variant(n, pt, x, dt, A, B, C, y, state, s, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dx [b, l, h, p] (x's type), ddt [b, l, h] and dA [h] (fp32), dB and dC [b, l, n] (B's type),
// all contiguous, from the forward's inputs (strided as ssd_scan_fwd takes them), dy (unit stride over p) and
// dstate (contiguous fp32 [b, h, p, n], or null: no gradient of the final state).  is_bf16: x, B, C, dy, dx,
// dB and dC are bf16, else fp32.  Scratch, all fp32: hs [b h n_pt][l / chunk][pt][n] (the states), pdB and pdC
// [b, l, h n_pt, n], pddt [b, l, h, n_pt], pdA [b, h, n_pt], n_pt = ceil(p / pt).  Launches
// ssd_scan_bwd_kernel and ssd_scan_bwd_sum_kernel on `stream`; returns the first launch's CUDA error, or 0.
// Shapes and the shared-memory size are validated by the Python wrapper.
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* B, const void* C,
                            const void* dy, const float* dstate, void* dx, float* ddt, float* dA, void* dB,
                            void* dC, float* hs, float* pdB, float* pdC, float* pddt, float* pdA, int is_bf16, int b,
                            int l, int h, int p, int n, int chunk, int pt, long long sxb, long long sxl,
                            long long sxh, long long sdb, long long sdl, long long sdh, long long sBb,
                            long long sBl, long long sCb, long long sCl, long long sdyb, long long sdyl,
                            long long sdyh, void* stream) {
  const SsdShape s{b, l, h, p, n, chunk, pt, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<bf16>(x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC, hs, pdB, pdC, pddt, pdA, s, sdyb,
                            sdyl, sdyh, st);
  return launch_bwd<float>(x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC, hs, pdB, pdC, pddt, pdA, s, sdyb,
                           sdyl, sdyh, st);
}

// Blocks of ssd_scan_mma_bf16_kernel<n, pt> at `chunk` one SM holds at once
// on the current device, or minus a cudaError.
extern "C" int ssd_scan_mma_occupancy(int n, int pt, int chunk) { return occupancy_mma_variant(n, pt, chunk); }

// Dynamic shared memory of one ssd_scan_mma_bf16_kernel block, in bytes.
extern "C" int ssd_scan_mma_smem_bytes(int n, int pt, int chunk) { return mma_smem_bytes(chunk, n, pt); }

// The bf16 terms this build splits each inexact product operand into (SSD_TERMS).
extern "C" int ssd_scan_mma_terms() { return TERMS; }
