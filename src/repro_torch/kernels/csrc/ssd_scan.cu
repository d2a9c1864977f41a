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
// final_state [b, h, p, n] fp32, which the LM prefill hands to decode.  The
// SIMT and mma.sync kernels below run one block per (b, h, tile of PT rows
// of the state over p): the state's rows are independent, and a loop over
// chunks inside the block replaces the Pallas kernel's sequential grid axis.
// The wgmma route (further below) is parallel over chunks.
//
// Bound on the H100 SXM: bytes.  At the mamba2-130m prefill shape (b 4,
// l 512, 24 heads of 64, state 128, chunk 64, bf16) the function needs 1.73
// GFLOP (1.75 us at the 989 TFLOP/s bf16 peak, 25.8 us at the 67 TFLOP/s
// fp32 FMA peak) over 17.0 MB (5.07 us at 3.35 TB/s): only the tensor cores
// bring the arithmetic under the bytes.
//
// bf16 outside the wgmma route's shapes (below): ssd_scan_mma_bf16_kernel<N,
// PT>, on the tensor cores (chunk 16, 32 or 64; state width N 64 or 128; p a
// multiple of 16; 16-byte-aligned rows of x, B and C).  What held the SIMT
// kernel below at 134x its bound, and what this one does about each:
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
// bf16 at chunk 64, p a multiple of 64, state width 64 or 128 and rows TMA
// can address (every served prefill, training forward and mesh-rank scan)
// takes the wgmma route, parallel over chunks, two launches:
// - ssd_scan_fwd_states_kernel<N>, one warpgroup per (b, h, 64 rows of p, 64
//   state columns), carries the state along the chunks in fp32 accumulators:
//   each chunk's own part (x exp(cum_last - cum) dt)^T . B on wgmma
//   m64n64k16 (x as stored; the scaled B in 3 bf16 planes), x and B through
//   a 2-stage TMA ring; it writes the state entering every chunk but the
//   first (fp32 [b, h, nc, p, n]) and the last.  It runs the backward's
//   states body (states_mma) in direction 0 over tiles of p, loading by TMA
//   where the backward's uses cp.async (5-9% faster here).  A form parallel
//   over chunks whose states a kernel of its own passed along them moved
//   them twice more and lost (scripts/ssd_probe.py, PERF.md).
// - ssd_scan_fwd_chunk_kernel<N>, one warpgroup per (b, chunk, group of
//   bwd_head_group heads): G = C.B^T once on wgmma, kept in fp32 registers;
//   per head, Y = exp(cum) o (C . H^T) + (G o L o dt) . x on wgmma, H split
//   into 3 bf16 planes in shared memory, G o L o dt into 3 bf16 A fragments
//   in registers, each term in accumulators of its own, summed smallest
//   first as the mma.sync kernel sums them (one accumulator for all moved
//   more outputs a rounding off plain's than that kernel); y through a
//   swizzled tile and a TMA store.
// Bound on the H100 SXM: bytes (5.07 us at mamba2, 14.4 at zamba2).  What
// holds it (scripts/ssd_probe.py's parts): the fp32 states' trip through
// device memory (written by the first kernel, read by the second: 22 MB at
// mamba2, 37 MB at zamba2, beside 17 MB of the scan's own bytes), x read by
// both kernels, and at these shapes the latency of each (b, h) chain and of
// each head's steps at two blocks an SM; the products are a fifth to a
// third of the chunk kernel.
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
// 96 blocks on 132 SMs at mamba2.  It now serves fp32, the smoke configs'
// chunk 8 and every shape outside the tensor-core route (the wrapper's
// bwd_route).
//
// bf16 at chunk 64, p 64 and state width 64 or 128 with 16-byte-aligned
// rows (every training and mesh-rank shape) takes the wgmma route, three
// launches, parallel over chunks; the mma route below is the same with the
// chunk kernel on mma.sync, kept to be timed beside it (and described first,
// since the wgmma route runs its states and sum kernels).  Given the state
// entering a chunk, H_in, and the
// gradient of the one leaving it, dH_out, a chunk's backward needs nothing
// else of the other chunks: even <dH_out, H_out> at its last step is
// exp(cum_last) <dH_out, H_in> + Sum (wend dt o (x . dH_out)) o B, from
// products the chunk computes anyway.  So:
// - ssd_scan_bwd_states_mma_kernel<N>, one warpgroup per (b, h, 64 state
//   columns, direction), carries the states forward and their gradients
//   backward over the 8 chunks, 8 scaled adds of a [64, 64] tile in fp32
//   accumulators, each chunk's own part on wgmma m64n64k16 (x or dy as
//   stored, B or C scaled and split into 3 bf16 planes once a chunk by the
//   block; its body, states_mma, is the forward's states kernel's too), and
//   writes them for the chunk kernel (2 x 25 MB fp32 at mamba2,
//   2 x 42 MB at zamba2).  With mma.sync and 32 columns a block it took
//   0.057 / 0.081 ms (PERF.md): the chain over chunks ran each step's
//   products and every warp split the same operand; wgmma and 64 columns,
//   0.028 / 0.053, against 17 / 28 us for its 57 / 95 MB at the HBM rate.
// - ssd_scan_bwd_chunk_mma_kernel<N>, one block of 8 warps per (b, chunk,
//   group of bwd_head_group heads: 3 at mamba2, 10 at zamba2, 256 blocks
//   both): C.B^T once a block for all its heads; per head the chunk's
//   products on mma.sync m16n8k16, the fp32 operands ((C.B^T) o L, H, dH,
//   Sum W) as 3 bf16 terms as in the forward (split_pair), dx and ddt
//   written, dB's and dC's within-chunk parts summed over the group's heads
//   as Sum W before two products a block, their inter-chunk parts in fp32
//   registers; d(cum)'s reverse sum by one warp while the others start the
//   next head.  A wgmma version (two warpgroups, H and dH as register A
//   fragments, every other operand in swizzled tiles) was right but slower,
//   0.150 / 0.223 against 0.089 / 0.159 ms, and still 0.115 / 0.179 with
//   its products taken out: at these 64 x 64 tiles the elementwise
//   epilogues (the decays' exps, the row and column sums, the planes) and
//   not the products set the pace, and a warpgroup runs them on 4 warps
//   where mma.sync's layout spreads every phase over all 8 (PERF.md).
// - ssd_scan_bwd_mma_sum_kernel sums the groups' parts of dB and dC (fp32
//   [b, l, h / group, n]) and the chunks' of dA in index order.  No
//   atomics: two calls give the same bits.
// What bounds the route (its part probes, PERF.md): the chunk kernel, 70% of it;
// without its products it takes 57-59% of its time, without its loads 87%:
// latency at one block of 8 warps an SM, shared memory allowing no second
// (182,336 / 195,648 B at state 64 / 128).
//
// The wgmma route keeps the states and sum kernels and replaces the chunk
// kernel by ssd_scan_bwd_chunk_kernel<N, TMA> (see its note below): every
// product on wgmma from swizzled shared memory, two warpgroups each taking
// half the columns of every product, the fp32 operands split into bf16
// planes once a head by the whole block, products issued ahead of the
// epilogues that wait on them.  Where the forward ran on its wgmma route
// (the recomputed forward of a checkpointed layer), the backward reads the
// forward's H_in (hbuf) instead of rebuilding it: the same states body on
// the same inputs gives the same bits, and the states kernel then runs the
// gradients' direction alone, half its blocks (ops.keeping_scan_states).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The backward on the tensor cores: bf16, chunk 64, p 64, state width 64 or 128
// ---------------------------------------------------------------------------

constexpr int BCL = 64;                   // the chunk
constexpr int BP = 64;                    // p, the head dim
constexpr int LDT = 64 + PAD;             // a row of a [64][64] bf16 tile in shared memory
constexpr int TILE_BYTES = 64 * LDT * 2;
constexpr int SLICE = 64;                 // state columns one block of the states kernel carries
constexpr int ST_THREADS = 128;           // the states kernel: one warpgroup, warp w on rows 16w.. of p
constexpr int ST_TILE = 64 * 128;         // its 64 x 64 bf16 tiles, rows of 128 bytes
constexpr int ST_STAGE = 2 * ST_TILE + 1024;  // x or dy (swizzled), the B or C slice, dt: 1024-byte aligned
constexpr int CH_THREADS = 256;           // the chunk kernel: 8 warps
constexpr int CH_STAGE = 2 * TILE_BYTES + 64 * 4;  // x, dy, dt of one head
constexpr int CH_TILES = 10;              // 16 x 16 tiles of a chunk on and below its diagonal

struct BwdShape {
  int b, l, h, n, hg;  // hg: heads one block of the chunk kernel takes
  long long sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl, syb, syl, syh;  // element strides of x, dt, B, C, dy
};

// The states kernel's shared memory: alignment slack, a 2-stage ring, 3 planes and each warp's factors.
__host__ __device__ constexpr int bwd_states_smem() {
  return 1024 + 2 * ST_STAGE + 3 * ST_TILE + (ST_THREADS / 32) * 3 * 64 * 4;
}

// The chunk kernel's H and dH buffers: two at state width 64 (the next head's land during this one's
// work), one at 128, where two do not fit.
__host__ __device__ constexpr int state_stages(int n) { return n <= 64 ? 2 : 1; }
constexpr int CH_PARTS = 2 * CH_TILES * 16 + 3 * 4 * 64 + 8;  // one head's per-step partials, in floats

// The chunk kernel's: B and C [64][n + 8] (bf16), the x, dy, dt ring, H [64][n + 4] and dH [64][n + 8]
// (fp32, state_stages of each), 3 bf16 planes [64][LDT], the tiles of C.B^T (fp32, in fragment order),
// each warp's factors (cum, exp(cum), exp(cum_last - cum), dt), and two heads' per-step partials (M's
// row and column sums per tile; yoff, supd and ddir per column quarter; the carry per warp).
__host__ __device__ constexpr int bwd_chunk_smem(int n) {
  return 2 * 64 * (n + PAD) * 2 + 2 * CH_STAGE + state_stages(n) * (64 * (n + 4) * 4 + 64 * (n + 8) * 4) +
         3 * TILE_BYTES + CH_TILES * 256 * 4 + (CH_THREADS / 32) * 4 * 64 * 4 + 2 * CH_PARTS * 4;
}

// Fragments of mma.sync m16n8k16 from bf16 tiles in shared memory (rows of `ld` elements).
// A (m16 x k16) at (m0, k0) of M[m][k]:
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* M, int ld, int m0, int k0, int lane) {
  ldmatrix_x4(r, M + (m0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// ... of the transpose, A[m][k] = M[k][m]:
__device__ __forceinline__ void frag_at(uint32_t (&r)[4], const bf16* M, int ld, int m0, int k0, int lane) {
  ldmatrix_x4_trans(r, M + (k0 + lane % 8 + (lane / 16) * 8) * ld + m0 + ((lane / 8) % 2) * 8);
}
// B of two n8 tiles (k16 x n16) at (k0, n0), r[0], r[1] the first's and r[2], r[3] the second's, of B[k][n] = M[n][k]:
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* M, int ld, int k0, int n0, int lane) {
  ldmatrix_x4(r, M + (n0 + (lane / 16) * 8 + lane % 8) * ld + k0 + ((lane / 8) % 2) * 8);
}
// ... of B[k][n] = M[k][n]:
__device__ __forceinline__ void frag_bt(uint32_t (&r)[4], const bf16* M, int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, M + (k0 + lane % 16) * ld + n0 + (lane / 16) * 8);
}

// One warp's scan of a 64-step chunk's log decays, cum = cumsum(dt * a) (a lane holds steps lane and
// lane + 32), into its rows cum, exp(cum) and exp(cum_last - cum); returns cum_last.
__device__ __forceinline__ float scan_chunk64(const float* Ds, float a, float* cum, float* ecum, float* wend,
                                              int lane) {
  float v0 = Ds[lane] * a, v1 = Ds[lane + 32] * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, off), u1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float last = __shfl_sync(0xffffffffu, v1, 31);
  cum[lane] = v0;
  cum[lane + 32] = v1;
  ecum[lane] = expf(v0);
  ecum[lane + 32] = expf(v1);
  wend[lane] = expf(last - v0);
  wend[lane + 32] = expf(last - v1);
  __syncwarp();
  return last;
}

// Tile `tile` of the 10 on and below a chunk's diagonal: rows 16r.., columns 16q.., q <= r, row by row.
__device__ __forceinline__ void tile_rq(int tile, int& r, int& q) {
  r = 0;
  while ((r + 1) * (r + 2) / 2 <= tile) ++r;
  q = tile - r * (r + 1) / 2;
}
__device__ __forceinline__ int tile_of(int r, int q) { return r * (r + 1) / 2 + q; }

// The fp32 accumulators of the 16 x 16 tile (r, q) (two n8 tiles) as TERMS bf16 planes [64][LDT].
__device__ __forceinline__ void store_planes(bf16* planes, int r, int q, const float (&v)[2][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    uint32_t lo[TERMS], hi[TERMS];
    split_pair(v[hh][0], v[hh][1], lo);
    split_pair(v[hh][2], v[hh][3], hi);
    bf16* at = planes + (16 * r + g) * LDT + 16 * q + 8 * hh + 2 * t;
#pragma unroll
    for (int i = 0; i < TERMS; ++i) {
      *reinterpret_cast<uint32_t*>(at + i * 64 * LDT) = lo[i];
      *reinterpret_cast<uint32_t*>(at + i * 64 * LDT + 8 * LDT) = hi[i];
    }
  }
}

// The states and their gradients, one warpgroup per (b, h, 64 rows of p from 64 pt, SLICE columns of the
// state from n0, direction): direction 0 carries the state forward, writing the state entering each chunk
// but the first to hbuf and, where `last` is not null, the state leaving the last chunk to `last`;
// direction 1 carries the gradient of the state leaving each chunk backward from dstate (0 where null),
// writing it for each chunk but the last to dhbuf (hbuf and dhbuf [b, h, nc, p, n], dstate and `last`
// [b, h, p, n], all fp32):
//   state += (x exp(cum_last - cum) dt)^T . B,   gradient += (dy exp(cum))^T . C
// after scaling by exp(cum_last).  The product is wgmma m64n64k16 with both operands MN-major from shared
// memory in the 128-byte swizzle: x or dy as stored, B or C scaled per step in fp32 and split into TERMS
// bf16 planes once a chunk by the whole block; both land in a 2-stage ring, swizzled, by cp.async or
// (TMA) by TMA from map_x and map_B (direction 0 only: the forward's rows, which TMA can address; the
// backward's rows may have zero strides).  The state stays in the fp32 accumulators: warp w holds rows
// 16w.. of the block's 64.  The backward's states kernel and the forward's run this body.
template <int N, bool TMA>
__device__ __forceinline__ void states_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                                           const float* __restrict__ A, const bf16* __restrict__ Bm,
                                           const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                                           const float* __restrict__ dstate, float* __restrict__ hbuf,
                                           float* __restrict__ dhbuf, float* __restrict__ last,
                                           const CUtensorMap* map_x, const CUtensorMap* map_B, const BwdShape& s,
                                           int p, int grads, int n0, int pt, int bh) {
  static_assert(N % SLICE == 0 && SLICE == 64 && BP == 64, "64 x 64 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* planes = base + 2 * ST_STAGE;  // TERMS swizzled tiles of the scaled B or C
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int bi = bh / s.h, hi = bh % s.h;
  const int nc = s.l / BCL, p0 = 16 * warp;
  const long long slot = (long long)p * N, rows = (long long)pt * BP * N + n0 + 2 * t;  // a chunk's state; ours
  const float a_h = A[hi];
  const bf16* X = TMA ? nullptr : (grads ? dy + bi * s.syb + hi * s.syh : x + bi * s.sxb + hi * s.sxh) + pt * BP;
  const long long sXl = grads ? s.syl : s.sxl;
  const bf16* Y = TMA ? nullptr : (grads ? Cm + bi * s.sCb : Bm + bi * s.sBb) + n0;
  const long long sYl = grads ? s.sCl : s.sBl;
  const float* db = dt + bi * s.sdb + hi * s.sdh;
  float* out = (grads ? dhbuf : hbuf) + bh * nc * slot + rows;
  float* cum = reinterpret_cast<float*>(planes + 3 * ST_TILE) + warp * 3 * 64;
  float* ecum = cum + 64;
  float* wend = ecum + 64;

  // a stage's TMA barrier, after its dt
  auto bar = [&](int stage) { return reinterpret_cast<uint64_t*>(base + stage * ST_STAGE + 2 * ST_TILE + 64 * 4); };
  if (TMA) {
    if (tid == 0) {
      mbar_init(bar(0), 1);
      mbar_init(bar(1), 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  // stage: X and Y (swizzled: row s of 64 elements, its 16-byte pieces XOR-ed with s % 8, as TMA lays them), dt
  auto load = [&](int c, int stage) {
    unsigned char* Xs = base + stage * ST_STAGE;
    unsigned char* Ys = Xs + ST_TILE;
    float* Ds = reinterpret_cast<float*>(Ys + ST_TILE);
    const int l0 = c * BCL;
    if (TMA) {
      if (tid == 0) {
        mbar_arrive_expect_tx(bar(stage), 2 * ST_TILE);
        tma_load_4d(Xs, map_x, bar(stage), pt * BP, hi, l0, bi);
        tma_load_4d(Ys, map_B, bar(stage), n0, 0, l0, bi);
      }
    } else {
      for (int e = tid; e < 64 * 8; e += ST_THREADS) {
        const int r = e / 8, off = r * 128 + (((e % 8) ^ (r % 8)) << 4);
        cp_async16(Xs + off, X + (l0 + r) * sXl + e % 8 * 8, 16);
        cp_async16(Ys + off, Y + (l0 + r) * sYl + e % 8 * 8, 16);
      }
    }
    if (tid < 64) cp_async4(Ds + tid, db + (long long)(l0 + tid) * s.sdl);
  };
  // this thread's rows p0 + g and p0 + g + 8 of the state, from chunk slot `o`
  auto store = [&](float* o, const float (&v)[SLICE / 2]) {
#pragma unroll
    for (int j = 0; j < SLICE / 8; ++j) {
      *reinterpret_cast<float2*>(o + (p0 + g) * N + 8 * j) = make_float2(v[4 * j], v[4 * j + 1]);
      *reinterpret_cast<float2*>(o + (p0 + g + 8) * N + 8 * j) = make_float2(v[4 * j + 2], v[4 * j + 3]);
    }
  };

  // rows p0 + g (registers 4j, 4j + 1) and p0 + g + 8 (4j + 2, 4j + 3), columns n0 + 8j + 2t (+ 1)
  float acc[SLICE / 2];
#pragma unroll
  for (int j = 0; j < SLICE / 8; ++j) {
    float2 lo = make_float2(0.f, 0.f), up = lo;
    if (grads && dstate != nullptr) {
      const float* ds = dstate + bh * slot + rows + 8 * j;
      lo = *reinterpret_cast<const float2*>(ds + (p0 + g) * N);
      up = *reinterpret_cast<const float2*>(ds + (p0 + g + 8) * N);
    }
    acc[4 * j] = lo.x;
    acc[4 * j + 1] = lo.y;
    acc[4 * j + 2] = up.x;
    acc[4 * j + 3] = up.y;
  }

  load(grads ? nc - 1 : 0, 0);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const int c = grads ? nc - 1 - i : i;
    cp_async_wait<0>();
    if (TMA) mbar_wait(bar(i % 2), (i / 2) & 1);
    __syncthreads();  // chunk c has landed; the last chunk's wgmma are done with the planes and the other stage
    if (i + 1 < nc) load(grads ? c - 1 : c + 1, (i + 1) % 2);
    cp_async_commit();
    const unsigned char* Xs = base + (i % 2) * ST_STAGE;
    const unsigned char* Ys = Xs + ST_TILE;
    const float* Ds = reinterpret_cast<const float*>(Ys + ST_TILE);
    const float dec = expf(scan_chunk64(Ds, a_h, cum, ecum, wend, lane));
    if (grads ? c < nc - 1 : c > 0) store(out + c * slot, acc);  // where the chunk kernel reads it
#pragma unroll
    for (int e = 0; e < SLICE / 2; ++e) acc[e] *= dec;
    // f o Y into the planes, f = exp(cum_last - cum) dt (the states) or exp(cum) (their gradients)
    for (int e = tid; e < 64 * 8; e += ST_THREADS) {
      const int r = e / 8, off = r * 128 + (((e % 8) ^ (r % 8)) << 4);
      const float f = grads ? ecum[r] : wend[r] * Ds[r];
      const uint4 y = *reinterpret_cast<const uint4*>(Ys + off);
      const uint32_t yv[4] = {y.x, y.y, y.z, y.w};
      uint32_t split[4][TERMS];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yv[k]));
        split_pair(v.x * f, v.y * f, split[k]);
      }
#pragma unroll
      for (int k = 0; k < TERMS; ++k)
        *reinterpret_cast<uint4*>(planes + k * ST_TILE + off) =
            make_uint4(split[0][k], split[1][k], split[2][k], split[3][k]);
    }
    fence_proxy_async_shared();  // the planes, and X from cp.async, to the async proxy the wgmma read through
    __syncthreads();
    wgmma_fence();
    wgmma_fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < BCL / 16; ++kk)
#pragma unroll
      for (int k = TERMS - 1; k >= 0; --k)
        wgmma_m64n64k16_bf16<1, 1>(acc, wgmma_desc_sw128(Xs + 2048 * kk, ST_TILE, 1024),
                                   wgmma_desc_sw128(planes + k * ST_TILE + 2048 * kk, ST_TILE, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
  }
  cp_async_wait<0>();
  if (!grads && last != nullptr) store(last + bh * slot + rows, acc);
}

// The backward's states, one block per (b, h, SLICE state columns, direction) (p is 64); with dirs 1, the
// gradients' direction alone (the wgmma route given the forward's states in hbuf).
template <int N>
__global__ void __launch_bounds__(ST_THREADS)
ssd_scan_bwd_states_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                               const float* __restrict__ dstate, float* __restrict__ hbuf, float* __restrict__ dhbuf,
                               BwdShape s, int dirs) {
  const int u = blockIdx.x / dirs;
  states_mma<N, false>(x, dt, A, Bm, Cm, dy, dstate, hbuf, dhbuf, nullptr, nullptr, nullptr, s, BP,
                       dirs == 2 ? blockIdx.x % 2 : 1, u % (N / SLICE) * SLICE, 0, u / (N / SLICE));
}

// Each chunk's backward, one block per (b, chunk c, group of s.hg heads), given the state entering the
// chunk (hbuf; zero for the first) and the gradient of the one leaving it (dhbuf; dstate, or zero, for the
// last).  B, C and C.B^T (10 tiles over the 8 warps, each lane's fragments in shared memory: in
// registers they spilled at state width 128) once a block; per head, with L[l, s] =
// exp(cum_l - cum_s) for l >= s:
//   S = dy.x^T on the 10 tiles; W = S o L o dt_s summed over the heads in registers; the row and column
//     sums of M = (C.B^T) o W; (C.B^T) o L into 3 bf16 planes;
//   dxdt = ((C.B^T) o L)^T . dy + wend o (B . dH^T) -> dx, and per step dxdt.x and x dt.(B.dH^T);
//   dC += exp(cum) o (dy . H), and per step its dot with C;  dB += wend dt o (x . dH), and its dot with B;
//   <dH, H_out> = exp(cum_last) <dH, H> + that dot: the state leaving the chunk without rebuilding it;
//   warp 7 (one tile of S where warps 0 and 1 have two), while the others start the next head: d(cum),
//   its reverse cumulative sum, ddt (written) and dA's part (pdA [b, nc, h]); the per-step partials
//   alternate between two buffers by head for it.
// Then dC += (Sum W).B and dB += (Sum W)^T.C within the chunk, and the group's parts to pdB and pdC
// [b, l, groups, n] (fp32).  The [64, x] products: warp w takes row tiles (0, 3) (w < 4) or (1, 2), which
// even out the triangles, and a quarter of the columns.  Every fp32 operand (the planes, H, dH) enters as
// TERMS bf16 terms; x, dy, B and C as stored.
template <int N>
__global__ void __launch_bounds__(CH_THREADS, 1)
ssd_scan_bwd_chunk_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                              const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                              const float* __restrict__ dstate, const float* __restrict__ hbuf,
                              const float* __restrict__ dhbuf, bf16* __restrict__ dx, float* __restrict__ ddt,
                              float* __restrict__ pdB, float* __restrict__ pdC, float* __restrict__ pdA, BwdShape s) {
  constexpr int LDN = N + PAD, LDH = N + 4, LDD = N + 8;  // H's rows are read down columns, dH's also along rows
  constexpr int NQ = N / 4, NT = NQ / 8;  // a warp's columns of a [64, N] product, and their n8 tiles
  constexpr int SST = state_stages(N), CW = 7;  // H and dH buffers; the warp that sums d(cum)
  static_assert(NT % 2 == 0 && TERMS <= 3, "n16 pieces; 3 planes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Cs = Bs + 64 * LDN;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Cs + 64 * LDN);
  float* Hbufs = reinterpret_cast<float*>(ring + 2 * CH_STAGE);  // [SST][64][LDH]
  float* dHbufs = Hbufs + SST * 64 * LDH;                          // [SST][64][LDD]
  bf16* planes = reinterpret_cast<bf16*>(dHbufs + SST * 64 * LDD);
  float4* Gf = reinterpret_cast<float4*>(planes + 3 * 64 * LDT);  // [tile][n8 half][lane]
  float* fac = reinterpret_cast<float*>(Gf + CH_TILES * 64);
  float* parts = fac + (CH_THREADS / 32) * 4 * 64;  // two heads' partials, by parity

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int groups = s.h / s.hg, nc = s.l / BCL;
  const int grp = blockIdx.x % groups, c = blockIdx.x / groups % nc, bi = blockIdx.x / (groups * nc);
  const long long l0 = (long long)c * BCL;
  const bool has_h = c > 0, has_dh = c < nc - 1 || dstate != nullptr;
  const int rg = warp / 4, cq = warp % 4;
  const int rt[2] = {rg, 3 - rg};
  float* cum = fac + warp * 4 * 64;
  float* ecum = cum + 64;
  float* wend = ecum + 64;
  float* dtw = wend + 64;  // dt, for the d(cum) sum after the ring's stage is refilled
  // one head's partials: M's row and column sums [tile][16]; per column quarter [4][64] Sum_n exp(cum)
  // (dy.H) o C, Sum_p x o (B.dH^T) and Sum_p dxdt o x; the carry [warp]
  auto partials = [&](int j, float*& rowM, float*& colM, float*& yoffp, float*& supdp, float*& ddirp,
                      float*& carryp) {
    rowM = parts + (j % 2) * CH_PARTS;
    colM = rowM + CH_TILES * 16;
    yoffp = colM + CH_TILES * 16;
    supdp = yoffp + 4 * 64;
    ddirp = supdp + 4 * 64;
    carryp = ddirp + 4 * 64;
  };

  auto load_x = [&](int j, int stage) {
    const int hi = grp * s.hg + j;
    bf16* Xs = reinterpret_cast<bf16*>(ring + stage * CH_STAGE);
    bf16* Ys = Xs + 64 * LDT;
    float* Ds = reinterpret_cast<float*>(Ys + 64 * LDT);
    const bf16* xs = x + bi * s.sxb + l0 * s.sxl + hi * s.sxh;
    const bf16* ys = dy + bi * s.syb + l0 * s.syl + hi * s.syh;
    for (int e = tid; e < 64 * (BP / 8); e += CH_THREADS) {
      const int r = e / (BP / 8), col = (e % (BP / 8)) * 8;
      cp_async16(Xs + r * LDT + col, xs + r * s.sxl + col, 16);
      cp_async16(Ys + r * LDT + col, ys + r * s.syl + col, 16);
    }
    if (tid < 64) cp_async4(Ds + tid, dt + bi * s.sdb + (l0 + tid) * s.sdl + hi * s.sdh);
  };
  auto load_states = [&](int hi, int buf) {
    const long long slot = (long long)bi * s.h + hi;
    const float* hsrc = hbuf + (slot * nc + c) * BP * N;
    const float* dsrc = c < nc - 1 ? dhbuf + (slot * nc + c) * BP * N : dstate + slot * BP * N;
    float* Hd = Hbufs + buf * 64 * LDH;
    float* dHd = dHbufs + buf * 64 * LDD;
    for (int e = tid; e < 64 * (N / 4); e += CH_THREADS) {
      const int r = e / (N / 4), col = (e % (N / 4)) * 4;
      if (has_h) cp_async16(Hd + r * LDH + col, hsrc + r * N + col, 16);
      if (has_dh) cp_async16(dHd + r * LDD + col, dsrc + r * N + col, 16);
    }
  };
  // d(cum) of head j's steps lane and lane + 32 by warp CW from the head's partials and its own factors,
  // its reverse cumulative sum, ddt and dA's part
  auto dcum = [&](int j) {
    const int hi = grp * s.hg + j;
    float *rowM, *colM, *yoffp, *supdp, *ddirp, *carryp;
    partials(j, rowM, colM, yoffp, supdp, ddirp, carryp);
    float dc[2], di[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int l = lane + 32 * v, r = l / 16, i = l % 16;
      float rows = 0.f, cols = 0.f, yo = 0.f, su = 0.f, dd = 0.f;
      for (int q = 0; q <= r; ++q) rows += rowM[tile_of(r, q) * 16 + i];
      for (int rr = r; rr < BCL / 16; ++rr) cols += colM[tile_of(rr, r) * 16 + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (has_h) yo += yoffp[k * 64 + l];
        su += supdp[k * 64 + l];
        dd += ddirp[k * 64 + l];
      }
      dc[v] = rows - cols + yo - wend[l] * dtw[l] * su;
      di[v] = dd;
    }
    float carry_all = 0.f;
    for (int w = 0; w < CH_THREADS / 32; ++w) carry_all += carryp[w];
    if (lane == 31) dc[1] += carry_all;  // the chunk's last step
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_down_sync(0xffffffffu, dc[0], off), u1 = __shfl_down_sync(0xffffffffu, dc[1], off);
      if (lane + off < 32) {
        dc[0] += u0;
        dc[1] += u1;
      }
    }
    dc[0] += __shfl_sync(0xffffffffu, dc[1], 0);
    const float a_h = A[hi];
    float* drow = ddt + (bi * (long long)s.l + l0 + lane) * s.h + hi;
    drow[0] = dc[0] * a_h + di[0];
    drow[32LL * s.h] = dc[1] * a_h + di[1];
    const float da = warp_sum(dc[0] * dtw[lane] + dc[1] * dtw[lane + 32]);
    if (lane == 0) pdA[(bi * (long long)nc + c) * s.h + hi] = da;
  };

  for (int e = tid; e < 64 * (N / 8); e += CH_THREADS) {
    const int r = e / (N / 8), col = (e % (N / 8)) * 8;
    cp_async16(Bs + r * LDN + col, Bm + bi * s.sBb + (l0 + r) * s.sBl + col, 16);
    cp_async16(Cs + r * LDN + col, Cm + bi * s.sCb + (l0 + r) * s.sCl + col, 16);
  }
  load_x(0, 0);
  if (SST == 2) load_states(grp * s.hg, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's tiles of C.B^T (tile warp, and warp + 8 for warps 0 and 1), each lane's own fragments
  // (read back by the same lane only), and of Sum W over the heads
  float Wsum[2][2][4] = {};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tile = warp + 8 * u;
    if (tile >= CH_TILES) break;
    int r, q;
    tile_rq(tile, r, q);
    float G[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4], bf[4];
      frag_a(af, Cs, LDN, 16 * r, 16 * kk, lane);
      frag_b(bf, Bs, LDN, 16 * kk, 16 * q, lane);
      mma_bf16(G[0], af, bf[0], bf[1]);
      mma_bf16(G[1], af, bf[2], bf[3]);
    }
    Gf[tile * 64 + lane] = make_float4(G[0][0], G[0][1], G[0][2], G[0][3]);
    Gf[tile * 64 + 32 + lane] = make_float4(G[1][0], G[1][1], G[1][2], G[1][3]);
  }
  // the group's dC and dB on this warp's rows 16 rt[i] + g (+ 8), columns NQ cq + 8j + 2t (+ 1)
  float dCt[2][NT][4] = {}, dBt[2][NT][4] = {};

  for (int j = 0; j < s.hg; ++j) {
    const int hi = grp * s.hg + j, stage = j % 2;
    const float a_h = A[hi];
    if (j > 0) {
      cp_async_wait<0>();
      __syncthreads();  // head j's x, dy and dt (and, with two buffers, H and dH) have landed; every warp is
                        // done with head j - 1 but for warp CW's d(cum)
    }
    if (SST == 1) load_states(hi, 0);
    cp_async_commit();
    if (j + 1 < s.hg) {
      load_x(j + 1, stage ^ 1);
      if (SST == 2) load_states(hi + 1, (j + 1) % 2);
    }
    cp_async_commit();
    if (warp == CW && j > 0) dcum(j - 1);  // before its scan of head j replaces the factors
    const bf16* Xs = reinterpret_cast<const bf16*>(ring + stage * CH_STAGE);
    const bf16* Ys = Xs + 64 * LDT;
    const float* Ds = reinterpret_cast<const float*>(Ys + 64 * LDT);
    const float* Hs = Hbufs + (SST == 2 ? j % 2 : 0) * 64 * LDH;
    const float* dHs = dHbufs + (SST == 2 ? j % 2 : 0) * 64 * LDD;
    float *rowM, *colM, *yoffp, *supdp, *ddirp, *carryp;
    partials(j, rowM, colM, yoffp, supdp, ddirp, carryp);
    const float last = scan_chunk64(Ds, a_h, cum, ecum, wend, lane);
    dtw[lane] = Ds[lane];
    dtw[lane + 32] = Ds[lane + 32];

    // S = dy.x^T on this warp's tiles, then W, M's sums and (C.B^T) o L
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tile = warp + 8 * u;
      if (tile >= CH_TILES) break;
      int r, q;
      tile_rq(tile, r, q);
      float S[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < BP / 16; ++kk) {
        uint32_t af[4], bf[4];
        frag_a(af, Ys, LDT, 16 * r, 16 * kk, lane);
        frag_b(bf, Xs, LDT, 16 * kk, 16 * q, lane);
        mma_bf16(S[0], af, bf[0], bf[1]);
        mma_bf16(S[1], af, bf[2], bf[3]);
      }
      const float4 g0 = Gf[tile * 64 + lane], g1 = Gf[tile * 64 + 32 + lane];
      const float G[2][4] = {{g0.x, g0.y, g0.z, g0.w}, {g1.x, g1.y, g1.z, g1.w}};
      float gl[2][4], rows[2] = {0.f, 0.f}, cols[2][2] = {};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * r + g + (e / 2) * 8, col = 16 * q + 8 * hh + 2 * t + e % 2;
          const float L = col <= row ? expf(cum[row] - cum[col]) : 0.f;  // masked before the exp
          const float w = S[hh][e] * L * Ds[col];
          const float m = G[hh][e] * w;
          Wsum[u][hh][e] += w;
          rows[e / 2] += m;
          cols[hh][e % 2] += m;
          gl[hh][e] = G[hh][e] * L;
        }
      store_planes(planes, r, q, gl, lane);
#pragma unroll
      for (int v = 0; v < 2; ++v) {  // over the tile's 16 columns: the 4 lanes of a row
        rows[v] += __shfl_xor_sync(0xffffffffu, rows[v], 1);
        rows[v] += __shfl_xor_sync(0xffffffffu, rows[v], 2);
      }
      if (t == 0) {
        rowM[tile * 16 + g] = rows[0];
        rowM[tile * 16 + g + 8] = rows[1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // over its 16 rows: the 8 lanes of a column pair
          float v = cols[hh][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colM[tile * 16 + 8 * hh + 2 * t + e] = v;
        }
    }
    __syncthreads();  // the planes and M's sums are whole

    // dxdt [s, p] on this warp's row tiles and 16 columns of p: first ((C.B^T) o L)^T . dy (l >= s) ...
    float Dc[2][2][4] = {}, Dd[2][2][4] = {};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int kk = 0; kk < BCL / 16; ++kk) {
        if (kk < rt[ri]) continue;
        uint32_t yb[4];
        frag_bt(yb, Ys, LDT, 16 * kk, 16 * cq, lane);
#pragma unroll
        for (int i = TERMS - 1; i >= 0; --i) {
          uint32_t af[4];
          frag_at(af, planes + i * 64 * LDT, LDT, 16 * rt[ri], 16 * kk, lane);
          mma_bf16(Dc[ri][0], af, yb[0], yb[1]);
          mma_bf16(Dc[ri][1], af, yb[2], yb[3]);
        }
      }
    if (SST == 1) {
      cp_async_wait<1>();
      __syncthreads();  // H and dH of this head have landed
    }

    // ... then B . dH^T
    if (has_dh) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t bd[2][2][TERMS];  // B[n][p] = dH[p][n]: k rows 2t, 2t + 1 (and + 8) of column g
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* at = dHs + (16 * cq + 8 * nt + g) * LDD + 16 * kk + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(at), v1 = *reinterpret_cast<const float2*>(at + 8);
          split_pair(v0.x, v0.y, bd[nt][0]);
          split_pair(v1.x, v1.y, bd[nt][1]);
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          uint32_t af[4];
          frag_a(af, Bs, LDN, 16 * rt[ri], 16 * kk, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = TERMS - 1; i >= 0; --i) mma_bf16(Dd[ri][nt], af, bd[nt][0][i], bd[nt][1][i]);
        }
      }
    }
    // dx = dxdt dt; per step dxdt.x and x.(B.dH^T) over this warp's columns
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sr = 16 * rt[ri] + g + 8 * half;
        const float we = wend[sr], d = Ds[sr];
        float dd = 0.f, su = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int pc = 16 * cq + 8 * nt + 2 * t;
          const float v0 = Dc[ri][nt][2 * half] + we * Dd[ri][nt][2 * half];
          const float v1 = Dc[ri][nt][2 * half + 1] + we * Dd[ri][nt][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(dx + ((bi * (long long)s.l + l0 + sr) * s.h + hi) * BP + pc) =
              __floats2bfloat162_rn(v0 * d, v1 * d);
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + sr * LDT + pc));
          dd += v0 * xv.x + v1 * xv.y;
          su += Dd[ri][nt][2 * half] * xv.x + Dd[ri][nt][2 * half + 1] * xv.y;
        }
        dd += __shfl_xor_sync(0xffffffffu, dd, 1);
        dd += __shfl_xor_sync(0xffffffffu, dd, 2);
        su += __shfl_xor_sync(0xffffffffu, su, 1);
        su += __shfl_xor_sync(0xffffffffu, su, 2);
        if (t == 0) {
          ddirp[cq * 64 + sr] = dd;
          supdp[cq * 64 + sr] = su;
        }
      }

    // dC += exp(cum) o (dy . H) on this warp's rows and columns of the state, and per step its dot with C
    if (has_h) {
      float E[2][NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < BP / 16; ++kk) {
        uint32_t bh[NT][2][TERMS];  // B[p][n] = H[p][n]: k rows 2t, 2t + 1 (and + 8) of column g
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* at = Hs + (16 * kk + 2 * t) * LDH + NQ * cq + 8 * nt + g;
          split_pair(at[0], at[LDH], bh[nt][0]);
          split_pair(at[8 * LDH], at[9 * LDH], bh[nt][1]);
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          uint32_t af[4];
          frag_a(af, Ys, LDT, 16 * rt[ri], 16 * kk, lane);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = TERMS - 1; i >= 0; --i) mma_bf16(E[ri][nt], af, bh[nt][0][i], bh[nt][1][i]);
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int lr = 16 * rt[ri] + g + 8 * half;
          const float ec = ecum[lr];
          float yo = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = NQ * cq + 8 * nt + 2 * t;
            const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Cs + lr * LDN + col));
            const float v0 = E[ri][nt][2 * half] * ec, v1 = E[ri][nt][2 * half + 1] * ec;
            dCt[ri][nt][2 * half] += v0;
            dCt[ri][nt][2 * half + 1] += v1;
            yo += v0 * cv.x + v1 * cv.y;
          }
          yo += __shfl_xor_sync(0xffffffffu, yo, 1);
          yo += __shfl_xor_sync(0xffffffffu, yo, 2);
          if (t == 0) yoffp[cq * 64 + lr] = yo;
        }
    }

    // dB += wend dt o (x . dH), and <dH, H_out> = exp(cum_last) <dH, H> + Sum of that product o B
    float carry = 0.f;
    if (has_dh) {
      float F[2][NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < BP / 16; ++kk) {
        uint32_t bh[NT][2][TERMS];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* at = dHs + (16 * kk + 2 * t) * LDD + NQ * cq + 8 * nt + g;
          split_pair(at[0], at[LDD], bh[nt][0]);
          split_pair(at[8 * LDD], at[9 * LDD], bh[nt][1]);
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          uint32_t af[4];
          frag_a(af, Xs, LDT, 16 * rt[ri], 16 * kk, lane);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = TERMS - 1; i >= 0; --i) mma_bf16(F[ri][nt], af, bh[nt][0][i], bh[nt][1][i]);
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int sr = 16 * rt[ri] + g + 8 * half;
          const float f = wend[sr] * Ds[sr];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = NQ * cq + 8 * nt + 2 * t;
            const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Bs + sr * LDN + col));
            const float v0 = F[ri][nt][2 * half] * f, v1 = F[ri][nt][2 * half + 1] * f;
            dBt[ri][nt][2 * half] += v0;
            dBt[ri][nt][2 * half + 1] += v1;
            carry += v0 * bv.x + v1 * bv.y;
          }
        }
      if (has_h) {
        float hh = 0.f;
        for (int e = tid; e < 64 * N / 4; e += CH_THREADS) {
          const float4 u = *reinterpret_cast<const float4*>(dHs + (e / (N / 4)) * LDD + (e % (N / 4)) * 4);
          const float4 v = *reinterpret_cast<const float4*>(Hs + (e / (N / 4)) * LDH + (e % (N / 4)) * 4);
          hh += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
        }
        carry += expf(last) * hh;
      }
    }
    carry = warp_sum(carry);
    if (lane == 0) carryp[warp] = carry;
  }
  __syncthreads();  // the last head's partials are whole, and no warp reads the planes
  if (warp == CW) dcum(s.hg - 1);

  // Sum W into the planes, then within the chunk dC += (Sum W).B (s <= l) and dB += (Sum W)^T.C (l >= s)
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tile = warp + 8 * u;
    if (tile >= CH_TILES) break;
    int r, q;
    tile_rq(tile, r, q);
    store_planes(planes, r, q, Wsum[u], lane);
  }
  __syncthreads();
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int kk = 0; kk < BCL / 16; ++kk) {
      const int i = rt[ri];
      uint32_t af[TERMS][4], bb[4];
      if (kk <= i) {
#pragma unroll
        for (int pl = 0; pl < TERMS; ++pl) frag_a(af[pl], planes + pl * 64 * LDT, LDT, 16 * i, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          frag_bt(bb, Bs, LDN, 16 * kk, NQ * cq + 16 * np, lane);
#pragma unroll
          for (int pl = TERMS - 1; pl >= 0; --pl) {
            mma_bf16(dCt[ri][2 * np], af[pl], bb[0], bb[1]);
            mma_bf16(dCt[ri][2 * np + 1], af[pl], bb[2], bb[3]);
          }
        }
      }
      if (kk >= i) {
#pragma unroll
        for (int pl = 0; pl < TERMS; ++pl) frag_at(af[pl], planes + pl * 64 * LDT, LDT, 16 * i, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          frag_bt(bb, Cs, LDN, 16 * kk, NQ * cq + 16 * np, lane);
#pragma unroll
          for (int pl = TERMS - 1; pl >= 0; --pl) {
            mma_bf16(dBt[ri][2 * np], af[pl], bb[0], bb[1]);
            mma_bf16(dBt[ri][2 * np + 1], af[pl], bb[2], bb[3]);
          }
        }
      }
    }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = 16 * rt[ri] + g + 8 * half, col = NQ * cq + 8 * nt + 2 * t;
        const long long at = ((bi * (long long)s.l + l0 + row) * groups + grp) * N + col;
        *reinterpret_cast<float2*>(pdC + at) = make_float2(dCt[ri][nt][2 * half], dCt[ri][nt][2 * half + 1]);
        *reinterpret_cast<float2*>(pdB + at) = make_float2(dBt[ri][nt][2 * half], dBt[ri][nt][2 * half + 1]);
      }
  cp_async_wait<0>();
}

// dB, dC [b, l, n] (T): the groups' parts [b, l, groups, n] summed in group order; dA [h]: the parts
// [b, nc, h] summed over batches and chunks in index order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_bwd_mma_sum_kernel(const float* __restrict__ pdB, const float* __restrict__ pdC,
                            const float* __restrict__ pdA, T* __restrict__ dB, T* __restrict__ dC,
                            float* __restrict__ dA, int b, int l, int h, int n, int groups, int nc) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nbl = (long long)b * l * n;
  if (i < nbl) {
    const long long bl = i / n, nn = i % n;
    float sb = 0.f, sc = 0.f;
    for (int grp = 0; grp < groups; ++grp) {
      sb += pdB[(bl * groups + grp) * n + nn];
      sc += pdC[(bl * groups + grp) * n + nn];
    }
    put(dB + i, sb);
    put(dC + i, sc);
  } else if (i < nbl + h) {
    const int hh = (int)(i - nbl);
    float v = 0.f;
    for (long long k = 0; k < (long long)b * nc; ++k) v += pdA[k * h + hh];
    dA[hh] = v;
  }
}

template <int N>
int launch_bwd_mma(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C, const bf16* dy,
                   const float* dstate, bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC, float* hbuf,
                   float* dhbuf, float* pdB, float* pdC, float* pdA, const BwdShape& s, cudaStream_t stream) {
  const int nc = s.l / BCL, groups = s.h / s.hg;
  const int st_smem = bwd_states_smem(), ch_smem = bwd_chunk_smem(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_states_mma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_bwd_chunk_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, ch_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_bwd_states_mma_kernel<N><<<(unsigned)(s.b * s.h * (N / SLICE) * 2), ST_THREADS, st_smem, stream>>>(
      x, dt, A, B, C, dy, dstate, hbuf, dhbuf, s, 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_bwd_chunk_mma_kernel<N><<<(unsigned)(s.b * nc * groups), CH_THREADS, ch_smem, stream>>>(
      x, dt, A, B, C, dy, dstate, hbuf, dhbuf, dx, ddt, pdB, pdC, pdA, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)s.b * s.l * s.n + s.h;
  ssd_scan_bwd_mma_sum_kernel<bf16><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      pdB, pdC, pdA, dB, dC, dA, s.b, s.l, s.h, s.n, groups, nc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 forward on wgmma: chunk 64, p a multiple of 64, state width 64 or 128, TMA rows
// ---------------------------------------------------------------------------

constexpr int WG = 128;         // one warpgroup
constexpr int FBOX = 64 * 128;  // one TMA box: 64 rows of 64 bf16, 128-byte swizzled

struct FwdShape {
  int b, l, h, p, n, hg;    // hg: heads one block of the chunk kernel takes
  long long sdb, sdl, sdh;  // element strides of dt
};

// The chunk kernel's shared memory: alignment slack, C and B (n / 64 boxes each), a 2-stage ring of x
// tiles, TERMS planes of the state (n / 64 boxes each), the output's tile, three barriers and a pad, dt
// of the group's heads and each warp's factors.
__host__ __device__ constexpr int fwd_chunk_smem(int n, int hg) {
  return 1024 + (2 * (n / 64) + 3 + 3 * (n / 64)) * FBOX + 4 * 8 + hg * 64 * 4 + 4 * 3 * 64 * 4;
}

// wgmma descriptors of a tile of 128-byte-swizzled boxes: K-major (k16 step kk in box kk / 4, 32 bytes
// a step within its rows), and MN-major 64 wide (a k16 step 16 rows on).
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk) {
  return wgmma_desc_sw128(tile + (kk / 4) * FBOX + 32 * (kk % 4), 16, 1024);
}
__device__ __forceinline__ uint64_t mndesc(const unsigned char* tile, int kk) {
  return wgmma_desc_sw128(tile + 2048 * kk, FBOX, 1024);
}

// The forward's states: the backward's states body in direction 0 alone, x and B by TMA, one block per
// (b, h, 64 rows of p, SLICE state columns), p a multiple of 64; writes the state entering each chunk but
// the first to hbuf and the last state to `last`.
template <int N>
__global__ void __launch_bounds__(ST_THREADS)
ssd_scan_fwd_states_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_B,
                           const float* __restrict__ dt, const float* __restrict__ A, float* __restrict__ hbuf,
                           float* __restrict__ last, BwdShape s, int p) {
  const int u = blockIdx.x / (N / SLICE), npt = p / BP;
  states_mma<N, true>(nullptr, dt, A, nullptr, nullptr, nullptr, nullptr, hbuf, nullptr, last, &map_x, &map_B, s, p,
                      0, blockIdx.x % (N / SLICE) * SLICE, u % npt, u / npt);
}

// The chunk outputs, one warpgroup per (b, chunk c, group of s.hg heads): C and B arrive by TMA once,
// and G = C.B^T on wgmma (both K-major) stays in the fp32 accumulators for the group.  Per head and 64
// columns of p, with the state entering the chunk H (hbuf; zero for the first chunk, which skips it):
//   Y = exp(cum) o (C . H^T) + (G o L o dt) . x,   L[l, s] = exp(cum_l - cum_s) for l >= s, else 0
// H is read from hbuf (fp32) and split into TERMS bf16 planes in C's swizzled K-major layout (B of the
// first product); the first product runs while G o L o dt is formed and split into TERMS bf16 A
// fragments in registers; each term has accumulators of its own, summed smallest first into term 0's
// and scaled there by exp(cum); the second product (A from registers, x from a 2-stage TMA ring,
// MN-major) adds each term to its own again, and y, their sum, leaves in bf16 through a swizzled tile
// and a TMA store.
template <int N>
__global__ void __launch_bounds__(WG, 1)
ssd_scan_fwd_chunk_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_B,
                          const __grid_constant__ CUtensorMap map_C, const __grid_constant__ CUtensorMap map_y,
                          const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ hbuf,
                          FwdShape s) {
  constexpr int NB = N / 64, PIECES = 64 * N / 8 / WG;  // boxes of a row; 8-float pieces of H a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Cs = base;
  unsigned char* Bs = Cs + NB * FBOX;
  unsigned char* Xring = Bs + NB * FBOX;
  unsigned char* planes = Xring + 2 * FBOX;
  unsigned char* Ys = planes + 3 * NB * FBOX;              // the output's tile, swizzled
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ys + FBOX);  // C and B; the x ring's two
  float* Dall = reinterpret_cast<float*>(bars + 4);         // [hg][64] dt of the group's heads
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  float* cum = Dall + s.hg * 64 + warp * 3 * 64;
  float* ecum = cum + 64;
  float* wend = ecum + 64;
  const int groups = s.h / s.hg, nc = s.l / 64, npt = s.p / 64, items = s.hg * npt;
  const int grp = blockIdx.x % groups, c = blockIdx.x / groups % nc, bi = blockIdx.x / (groups * nc);
  const int h0 = grp * s.hg, l0 = c * 64, row = 16 * warp + g;  // this thread's rows row and row + 8
  const bool has_h = c > 0;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_x = [&](int it) {  // item it: head h0 + it / npt, columns 64 (it % npt) of p
    mbar_arrive_expect_tx(&bars[1 + it % 2], FBOX);
    tma_load_4d(Xring + it % 2 * FBOX, &map_x, &bars[1 + it % 2], it % npt * 64, h0 + it / npt, l0, bi);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * NB * FBOX);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Cs + nb * FBOX, &map_C, &bars[0], 64 * nb, 0, l0, bi);
      tma_load_4d(Bs + nb * FBOX, &map_B, &bars[0], 64 * nb, 0, l0, bi);
    }
    load_x(0);
  }
  for (int e = tid; e < s.hg * 64; e += WG)
    cp_async4(Dall + e, dt + bi * s.sdb + (long long)(l0 + e % 64) * s.sdl + (long long)(h0 + e / 64) * s.sdh);
  cp_async_commit();

  float G[32];
  mbar_wait(&bars[0], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_m64n64k16_bf16<0, 0>(G, kdesc(Cs, kk), kdesc(Bs, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_operand(G);
  cp_async_wait<0>();
  __syncthreads();  // every thread's dt

  for (int it = 0; it < items; ++it) {
    const int hi = h0 + it / npt, pt = it % npt;
    const float* Ds = Dall + it / npt * 64;
    if (tid == 0) tma_store_wait_read<0>();  // item it - 1's output has left its tile
    if (it > 0) __syncthreads();  // every warp is done with item it - 1: its planes, x stage and tile
    if (tid == 0 && it + 1 < items) load_x(it + 1);
    scan_chunk64(Ds, A[hi], cum, ecum, wend, lane);
    // each term's products in accumulators of their own (term 0's also take the state's part, scaled),
    // summed smallest first, as the mma.sync kernel sums them: with one accumulator for all, more of the
    // bf16 outputs came out a rounding away from the plain version's than that kernel's (PERF.md)
    float acc[TERMS][32];
#pragma unroll
    for (int k = 0; k < TERMS; ++k)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[k][e] = 0.f;
    auto summed = [&](int e) {
      float v = 0.f;
#pragma unroll
      for (int k = TERMS - 1; k >= 0; --k) v += acc[k][e];
      return v;
    };
    if (has_h) {
      // H's rows 64 pt .. of p into TERMS bf16 planes, each 8-float piece a 16-byte chunk of its box
      const float* hs = hbuf + (((long long)bi * s.h + hi) * nc + c) * s.p * N + (long long)pt * 64 * N;
      float4 v[PIECES][2];
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const int e = tid + i * WG;
        const float4* src = reinterpret_cast<const float4*>(hs + (long long)(e / (N / 8)) * N + e % (N / 8) * 8);
        v[i][0] = __ldg(src);
        v[i][1] = __ldg(src + 1);
      }
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const int e = tid + i * WG, r = e / (N / 8), q = e % (N / 8);
        const int off = q / 8 * FBOX + r * 128 + (((q % 8) ^ (r % 8)) << 4);
        uint32_t split[4][TERMS];
        split_pair(v[i][0].x, v[i][0].y, split[0]);
        split_pair(v[i][0].z, v[i][0].w, split[1]);
        split_pair(v[i][1].x, v[i][1].y, split[2]);
        split_pair(v[i][1].z, v[i][1].w, split[3]);
#pragma unroll
        for (int k = 0; k < TERMS; ++k)
          *reinterpret_cast<uint4*>(planes + k * NB * FBOX + off) =
              make_uint4(split[0][k], split[1][k], split[2][k], split[3][k]);
      }
      fence_proxy_async_shared();
      __syncthreads();  // the planes are whole
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int k = TERMS - 1; k >= 0; --k)
          wgmma_m64n64k16_bf16<0, 0>(acc[k], kdesc(Cs, kk), kdesc(planes + k * NB * FBOX, kk), kk > 0);
      wgmma_commit();
    }
    // G o L o dt as TERMS bf16 A fragments: k16 step kk holds accumulator columns 16 kk .. 16 kk + 15
    uint32_t af[TERMS][4][4];
    const float cr0 = cum[row], cr1 = cum[row + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float cc0 = cum[col], cc1 = cum[col + 1], d0 = Ds[col], d1 = Ds[col + 1];
      uint32_t lo[TERMS], up[TERMS];
      split_pair(col <= row ? G[4 * j] * expf(cr0 - cc0) * d0 : 0.f,
                 col + 1 <= row ? G[4 * j + 1] * expf(cr0 - cc1) * d1 : 0.f, lo);
      split_pair(col <= row + 8 ? G[4 * j + 2] * expf(cr1 - cc0) * d0 : 0.f,
                 col + 1 <= row + 8 ? G[4 * j + 3] * expf(cr1 - cc1) * d1 : 0.f, up);
#pragma unroll
      for (int k = 0; k < TERMS; ++k) {
        af[k][j / 2][(j % 2) * 2] = lo[k];
        af[k][j / 2][(j % 2) * 2 + 1] = up[k];
      }
    }
    if (has_h) {  // the state's part, exp(cum) o (C . H^T), into term 0's accumulators
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < TERMS; ++k) wgmma_fence_operand(acc[k]);
      const float e0 = ecum[row], e1 = ecum[row + 8];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[0][e] = summed(e) * (e % 4 < 2 ? e0 : e1);
    }
    mbar_wait(&bars[1 + it % 2], (it / 2) & 1);
    const unsigned char* Xs = Xring + it % 2 * FBOX;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TERMS; ++k) wgmma_fence_operand(acc[k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int k = TERMS - 1; k >= 0; --k)
        wgmma_m64n64k16_bf16_rs<1>(acc[k], af[k][kk], mndesc(Xs, kk), kk > 0 || (k == 0 && has_h));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < TERMS; ++k) wgmma_fence_operand(acc[k]);
#pragma unroll
    for (int k = 0; k < TERMS; ++k) wgmma_fence_operand(af[k]);
    // y into its swizzled tile (rows row, row + 8; columns 8j + 2t, + 1), then out by TMA
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(Ys + r * 128 + ((j ^ (r % 8)) << 4) + 4 * t) =
            __floats2bfloat162_rn(summed(4 * j + 2 * half), summed(4 * j + 2 * half + 1));
      }
    fence_proxy_async_shared();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&map_y, Ys, pt * 64, hi, l0, bi);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait<0>();
}

// The rows of a bf16 tensor with element strides `st` (batch, head, row; `cols` unit) as a 4-D tensor
// map (cols, heads, rows, batch) in boxes of 64 columns by 64 rows of one head, 128-byte swizzled: x and
// y [b, l, h, p] and B, C [b, l, n] (one head) as the model lays them out, with strides that grow along
// the dims.  A dim of extent 1 is never stepped over: it gets a stride the encoder takes.
int encode_rows(CUtensorMap* map, const void* base, int cols, int heads, int rows, int batch, const long long* st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  const long long row = st[2], head = heads == 1 ? row : st[1], bat = batch == 1 ? row * rows : st[0];
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)head * 2, (cuuint64_t)row * 2, (cuuint64_t)bat * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

template <typename K>
cudaError_t allow_fwd_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int N>
int launch_fwd_wgmma(const void* x, const float* dt, const float* A, const void* B, const void* C, void* y,
                     float* state, float* hbuf, const SsdShape& s, int hg, cudaStream_t stream) {
  if (s.chunk != 64 || s.l % 64 != 0 || s.p % 64 != 0 || hg < 1 || s.h % hg != 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t ce = make_context_current(&dev);
  if (ce != cudaSuccess) return (int)ce;
  const long long sx[3] = {s.sxb, s.sxh, s.sxl}, sB[3] = {s.sBb, 0, s.sBl}, sC[3] = {s.sCb, 0, s.sCl};
  const long long sy[3] = {(long long)s.l * s.h * s.p, s.p, (long long)s.h * s.p};
  CUtensorMap mx, mB, mC, my;
  int err = encode_rows(&mx, x, s.p, s.h, s.l, s.b, sx);
  if (err == 0) err = encode_rows(&mB, B, N, 1, s.l, s.b, sB);
  if (err == 0) err = encode_rows(&mC, C, N, 1, s.l, s.b, sC);
  if (err == 0) err = encode_rows(&my, y, s.p, s.h, s.l, s.b, sy);
  if (err != 0) return err;
  const BwdShape bs{s.b, s.l, s.h, N, hg, s.sxb, s.sxl, s.sxh, s.sdb, s.sdl, s.sdh, s.sBb, s.sBl, s.sCb, s.sCl, 0, 0, 0};
  const long long blocks = (long long)s.b * s.h * (s.p / BP) * (N / SLICE);
  if ((ce = allow_fwd_smem(ssd_scan_fwd_states_kernel<N>, bwd_states_smem())) != cudaSuccess) return (int)ce;
  ssd_scan_fwd_states_kernel<N><<<(unsigned)blocks, ST_THREADS, bwd_states_smem(), stream>>>(mx, mB, dt, A, hbuf, state,
                                                                                               bs, s.p);
  if ((ce = cudaGetLastError()) != cudaSuccess) return (int)ce;
  const FwdShape f{s.b, s.l, s.h, s.p, N, hg, s.sdb, s.sdl, s.sdh};
  const int ch_smem = fwd_chunk_smem(N, hg);
  if ((ce = allow_fwd_smem(ssd_scan_fwd_chunk_kernel<N>, ch_smem)) != cudaSuccess) return (int)ce;
  ssd_scan_fwd_chunk_kernel<N><<<(unsigned)(s.b * (s.l / 64) * (s.h / hg)), WG, ch_smem, stream>>>(
      mx, mB, mC, my, dt, A, hbuf, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 backward's chunk kernel on wgmma: chunk 64, p 64, state width 64 or 128
// ---------------------------------------------------------------------------

constexpr int BW_THREADS = 256;  // two warpgroups
constexpr int BW_CW = 7;         // the warp that sums d(cum)
// One head's per-step partials, in floats: M's row sums per warpgroup [2][64] and its column sums per warp of
// a warpgroup [4][64]; Sum_n exp(cum) (dy.H) o C per 64 state columns [2][64]; Sum_p x o (B.dH^T) and
// Sum_p dxdt o x per warpgroup [2][64] each; the carry per warp [8].
constexpr int BW_PARTS = 2 * 64 + 4 * 64 + 2 * 64 + 2 * 64 + 2 * 64 + 8;

// The descriptors of a swizzled tile's k16 steps (kdesc, mndesc) as one base and constant offsets.  The base
// passes through an empty asm where the product is issued, so the compiler cannot hoist the dozens of
// descriptors the head loop's products use out of it, where they took registers from the accumulators.
struct Tile {
  uint64_t d;
  __device__ __forceinline__ uint64_t k(int kk) const { return d + (((kk / 4) * FBOX + 32 * (kk % 4)) >> 4); }
  __device__ __forceinline__ uint64_t mn(int kk) const { return d + ((2048 * kk) >> 4); }
};
__device__ __forceinline__ Tile ktile(const unsigned char* tile) {
  uint64_t d = wgmma_desc_sw128(tile, 16, 1024);
  asm volatile("" : "+l"(d));
  return {d};
}
__device__ __forceinline__ Tile mntile(const unsigned char* tile) {
  uint64_t d = wgmma_desc_sw128(tile, FBOX, 1024);
  asm volatile("" : "+l"(d));
  return {d};
}

// The chunk kernel's shared memory: alignment slack; C and B (n / 64 boxes each); a 2-stage ring of x and dy
// boxes; TERMS planes of the [64, 64] tile (C.B^T) o L, then Sum W; TERMS planes of H and of dH (n / 64 boxes
// each); dx's box for its TMA store; C.B^T in each thread's fragment order (fp32); three barriers and a pad;
// dt of the group's heads; each warp's factors (cum, exp(cum), exp(cum_last - cum)); two heads' partials.
__host__ __device__ constexpr int bwd_wgmma_smem(int n, int hg) {
  return 1024 + (2 * (n / 64) + 4 + 3 + 6 * (n / 64) + 1) * FBOX + 16 * BW_THREADS * 4 + 4 * 8 +
         hg * 64 * 4 + (BW_THREADS / 32) * 3 * 64 * 4 + 2 * BW_PARTS * 4;
}

// Each chunk's backward on wgmma, one block of two warpgroups per (b, chunk c, group of s.hg heads), given
// the state entering the chunk (hbuf: the forward's, or the states kernel's; zero for the first chunk) and
// the gradient of the one leaving it (dhbuf; dstate, or zero, for the last): the function of
// ssd_scan_bwd_chunk_mma_kernel, which the source note of the backward sets out, with every product on
// wgmma from shared memory in the 128-byte swizzle.  x, dy, B and C are used as stored (by TMA from the
// maps, or with TMA false by cp.async into the same layout: rows with a zero stride); the fp32 operands,
// (C.B^T) o L, H, dH and Sum W, enter as TERMS bf16 planes, split once a head by the whole block; nothing
// is an A fragment in registers.  Each warpgroup takes half the columns of every [64, 64] product (s of
// dy.x^T, p of dxdt's two) and, of the [64, n] ones, 64 columns of both (state 128) or one whole (state 64:
// warpgroup 0 dy.H and dC, warpgroup 1 x.dH and dB), so every elementwise phase runs on all 8 warps.  Per
// head: dy.x^T is issued first, and while it runs the block splits H and dH (brought to L2 during the
// head before), warp 7 sums the last head's d(cum) and every warp scans the chunk's decays; then W, M's
// sums and (C.B^T) o L into planes; then ((C.B^T) o L)^T.dy, B.dH^T and dy.H / x.dH issued before the
// first two's epilogue (dx, through a swizzled tile and a TMA store) and waited one group behind.  Each
// product sums its terms smallest first in one accumulator, as the mma.sync kernel does.  At state 128 the
// [64, n] products run in halves of 32 columns, one half in flight while the last is read, and the k16
// loops of the large products are not unrolled: whole, their accumulators and descriptors spilled at 255
// registers (scripts/ssd_bwd_probe.py, PERF.md).  Tried and dropped (same script): B.dH^T and dy.H issued
// before W's epilogue behind a third barrier, and at state 64 a second set of H and dH planes split for
// the next head while this head's products ran (both no faster or slower); Sum W in shared memory with
// C.B^T recomputed a head; the state's fp32 staged by bulk copies.
template <int N, bool TMA>
__global__ void __launch_bounds__(BW_THREADS, 1)
ssd_scan_bwd_chunk_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_dy,
                          const __grid_constant__ CUtensorMap map_B, const __grid_constant__ CUtensorMap map_C,
                          const __grid_constant__ CUtensorMap map_dx,
                          const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                          const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                          const float* __restrict__ dstate, const float* __restrict__ hbuf,
                          const float* __restrict__ dhbuf, bf16* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ pdB, float* __restrict__ pdC, float* __restrict__ pdA, BwdShape s) {
  constexpr int NB = N / 64, PIECES = N / 32, ITEMS = N / 64;  // boxes of a row; H's 8-float pieces a thread
  constexpr int AT_ONCE = N == 128 ? 1 : 2;  // H's and dH's pieces a thread loads at once (registers at 128)
  static_assert(N == 64 || N == 128, "state width 64 or 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Cs = base;
  unsigned char* Bs = Cs + NB * FBOX;
  unsigned char* ring = Bs + NB * FBOX;  // [stage][x, dy]
  unsigned char* Wp = ring + 4 * FBOX;   // TERMS planes of (C.B^T) o L, at the end of Sum W
  unsigned char* Hp = Wp + 3 * FBOX;     // TERMS planes of H [64 p][n], then of dH, NB boxes each
  unsigned char* Dxs = Hp + 6 * NB * FBOX;  // dx's tile, swizzled, for its TMA store
  float4* Gs = reinterpret_cast<float4*>(Dxs + FBOX);                 // [4][thread]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Gs + 4 * BW_THREADS);  // B and C; the ring's two
  float* Dall = reinterpret_cast<float*>(bars + 4);                   // [hg][64] dt
  float* fac = Dall + s.hg * 64;
  float* parts = fac + (BW_THREADS / 32) * 3 * 64;  // two heads' partials, by parity

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  // the warpgroup, broadcast so the compiler knows it is warp-uniform: wgmma under a branch it cannot
  // prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), row = 16 * (warp % 4) + g;  // rows row, row + 8
  const int groups = s.h / s.hg, nc = s.l / BCL;
  const int grp = blockIdx.x % groups, c = blockIdx.x / groups % nc, bi = blockIdx.x / (groups * nc);
  const int h0 = grp * s.hg, l0 = c * BCL;
  const bool has_h = c > 0, has_dh = c < nc - 1 || dstate != nullptr;
  const int box = N == 128 ? wg : 0;  // the 64 state columns of this warpgroup's [64, n] products
  float* cum = fac + warp * 3 * 64;
  float* ecum = cum + 64;
  float* wend = ecum + 64;
  // item i of this warpgroup's [64, n] products: dy.H (dC's part) or x.dH (dB's)
  auto is_e = [&](int i) { return N == 128 ? i == 0 : wg == 0; };
  auto h_src = [&](int j) { return hbuf + (((long long)bi * s.h + h0 + j) * nc + c) * BP * N; };
  auto dh_src = [&](int j) {
    const long long bh = (long long)bi * s.h + h0 + j;
    return c < nc - 1 ? dhbuf + (bh * nc + c) * BP * N : dstate + bh * BP * N;
  };
  auto prefetch_states = [&](int j) {  // head j's H and dH into L2 (one thread)
    if (has_h) prefetch_l2(h_src(j), BP * N * 4);
    if (has_dh) prefetch_l2(dh_src(j), BP * N * 4);
  };
  // head j's x and dy into stage j % 2 (swizzled: row r's 16-byte pieces XOR-ed with r % 8, as TMA lays them)
  auto load_x = [&](int j) {
    unsigned char* Xs = ring + (j % 2) * 2 * FBOX;
    unsigned char* Ys = Xs + FBOX;
    const int hi = h0 + j;
    if (TMA) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&bars[1 + j % 2], 2 * FBOX);
        tma_load_4d(Xs, &map_x, &bars[1 + j % 2], 0, hi, l0, bi);
        tma_load_4d(Ys, &map_dy, &bars[1 + j % 2], 0, hi, l0, bi);
      }
    } else {
      const bf16* xs = x + bi * s.sxb + (long long)l0 * s.sxl + hi * s.sxh;
      const bf16* ys = dy + bi * s.syb + (long long)l0 * s.syl + hi * s.syh;
      for (int e = tid; e < 64 * 8; e += BW_THREADS) {
        const int r = e / 8, off = r * 128 + (((e % 8) ^ (r % 8)) << 4);
        cp_async16(Xs + off, xs + r * s.sxl + e % 8 * 8, 16);
        cp_async16(Ys + off, ys + r * s.syl + e % 8 * 8, 16);
      }
    }
  };
  // d(cum) of head j's steps lane and lane + 32 by warp BW_CW from the head's partials and its own factors
  // (not yet replaced by the next head's), its reverse cumulative sum, ddt and dA's part
  auto dcum = [&](int j) {
    const int hi = h0 + j;
    const float* part = parts + (j % 2) * BW_PARTS;
    const float *rowM = part, *colM = rowM + 128, *yoffp = colM + 256, *supdp = yoffp + 128, *ddirp = supdp + 128,
                *carryp = ddirp + 128;
    const float* Dj = Dall + j * 64;
    float dc[2], di[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int l = lane + 32 * v;
      const float rows = rowM[l] + rowM[64 + l];
      const float cols = colM[l] + colM[64 + l] + colM[128 + l] + colM[192 + l];
      float yo = 0.f;
      if (has_h)
#pragma unroll
        for (int k = 0; k < NB; ++k) yo += yoffp[k * 64 + l];
      dc[v] = rows - cols + yo - wend[l] * Dj[l] * (supdp[l] + supdp[64 + l]);
      di[v] = ddirp[l] + ddirp[64 + l];
    }
    float carry_all = 0.f;
    for (int w = 0; w < BW_THREADS / 32; ++w) carry_all += carryp[w];
    if (lane == 31) dc[1] += carry_all;  // the chunk's last step
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_down_sync(0xffffffffu, dc[0], off), u1 = __shfl_down_sync(0xffffffffu, dc[1], off);
      if (lane + off < 32) {
        dc[0] += u0;
        dc[1] += u1;
      }
    }
    dc[0] += __shfl_sync(0xffffffffu, dc[1], 0);
    const float a_h = A[hi];
    float* drow = ddt + (bi * (long long)s.l + l0 + lane) * s.h + hi;
    drow[0] = dc[0] * a_h + di[0];
    drow[32LL * s.h] = dc[1] * a_h + di[1];
    const float da = warp_sum(dc[0] * Dj[lane] + dc[1] * Dj[lane + 32]);
    if (lane == 0) pdA[(bi * (long long)nc + c) * s.h + hi] = da;
  };

  if (TMA) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_arrive_expect_tx(&bars[0], 2 * NB * FBOX);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(Cs + nb * FBOX, &map_C, &bars[0], 64 * nb, 0, l0, bi);
        tma_load_4d(Bs + nb * FBOX, &map_B, &bars[0], 64 * nb, 0, l0, bi);
      }
    }
  } else {
    for (int e = tid; e < 64 * (N / 8); e += BW_THREADS) {
      const int r = e / (N / 8), q = e % (N / 8), off = q / 8 * FBOX + r * 128 + (((q % 8) ^ (r % 8)) << 4);
      cp_async16(Bs + off, Bm + bi * s.sBb + (long long)(l0 + r) * s.sBl + q * 8, 16);
      cp_async16(Cs + off, Cm + bi * s.sCb + (long long)(l0 + r) * s.sCl + q * 8, 16);
    }
  }
  load_x(0);
  for (int e = tid; e < s.hg * 64; e += BW_THREADS)
    cp_async4(Dall + e, dt + bi * s.sdb + (long long)(l0 + e % 64) * s.sdl + (long long)(h0 + e / 64) * s.sdh);
  cp_async_commit();
  if (tid == 0) prefetch_states(0);
  cp_async_wait<0>();
  fence_proxy_async_shared();  // what cp.async wrote, to the async proxy the wgmma read through
  if (TMA) mbar_wait(&bars[0], 0);
  __syncthreads();

  {  // G = C.B^T on this warpgroup's 32 columns of s, kept in shared memory for every head
    float G[16];
    wgmma_fence();
    const Tile c = ktile(Cs), b = ktile(Bs + 4096 * wg);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_m64n32k16_bf16<0, 0>(G, c.k(kk), b.k(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(G);
#pragma unroll
    for (int i = 0; i < 4; ++i) Gs[i * BW_THREADS + tid] = make_float4(G[4 * i], G[4 * i + 1], G[4 * i + 2], G[4 * i + 3]);
  }
  float Wsum[16] = {};      // Sum W over the group's heads, this warpgroup's columns
  float acc[ITEMS][32] = {};  // the group's dC or dB on this warpgroup's items

  // head j's H and dH into their planes (rows p, state columns in 64-wide boxes); returns this thread's
  // share of <dH, H>
  auto split = [&](int j) {
    float hh = 0.f;
    if (!(has_h || has_dh)) return hh;
    const float* hs = h_src(j);
    const float* ds = dh_src(j);
    unsigned char* hp = Hp;
    unsigned char* dhp = Hp + 3 * NB * FBOX;
#pragma unroll 1
    for (int i0 = 0; i0 < PIECES; i0 += AT_ONCE) {
      float4 hv[AT_ONCE][2], dv[AT_ONCE][2];
#pragma unroll
      for (int i = 0; i < AT_ONCE; ++i) {
        const int e = tid + (i0 + i) * BW_THREADS;
        const long long at = (long long)(e / (N / 8)) * N + e % (N / 8) * 8;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        hv[i][0] = has_h ? __ldcg(reinterpret_cast<const float4*>(hs + at)) : z;
        hv[i][1] = has_h ? __ldcg(reinterpret_cast<const float4*>(hs + at) + 1) : z;
        dv[i][0] = has_dh ? __ldcg(reinterpret_cast<const float4*>(ds + at)) : z;
        dv[i][1] = has_dh ? __ldcg(reinterpret_cast<const float4*>(ds + at) + 1) : z;
      }
#pragma unroll
      for (int i = 0; i < AT_ONCE; ++i) {
        const int e = tid + (i0 + i) * BW_THREADS, r = e / (N / 8), q = e % (N / 8);
        const int off = q / 8 * FBOX + r * 128 + (((q % 8) ^ (r % 8)) << 4);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          hh += hv[i][u].x * dv[i][u].x + hv[i][u].y * dv[i][u].y + hv[i][u].z * dv[i][u].z + hv[i][u].w * dv[i][u].w;
        uint32_t sh[4][TERMS], sd[4][TERMS];
        split_pair(hv[i][0].x, hv[i][0].y, sh[0]);
        split_pair(hv[i][0].z, hv[i][0].w, sh[1]);
        split_pair(hv[i][1].x, hv[i][1].y, sh[2]);
        split_pair(hv[i][1].z, hv[i][1].w, sh[3]);
        split_pair(dv[i][0].x, dv[i][0].y, sd[0]);
        split_pair(dv[i][0].z, dv[i][0].w, sd[1]);
        split_pair(dv[i][1].x, dv[i][1].y, sd[2]);
        split_pair(dv[i][1].z, dv[i][1].w, sd[3]);
#pragma unroll
        for (int k = 0; k < TERMS; ++k) {
          if (has_h)
            *reinterpret_cast<uint4*>(hp + k * NB * FBOX + off) = make_uint4(sh[0][k], sh[1][k], sh[2][k], sh[3][k]);
          if (has_dh)
            *reinterpret_cast<uint4*>(dhp + k * NB * FBOX + off) = make_uint4(sd[0][k], sd[1][k], sd[2][k], sd[3][k]);
        }
      }
    }
    return hh;
  };
  for (int j = 0; j < s.hg; ++j) {
    const int hi = h0 + j;
    const unsigned char* Xs = ring + (j % 2) * 2 * FBOX;
    const unsigned char* Ys = Xs + FBOX;
    const unsigned char* Hc = Hp;  // this head's planes of H, then of dH
    const unsigned char* dHc = Hp + 3 * NB * FBOX;
    const float* Ds = Dall + j * 64;
    float* part = parts + (j % 2) * BW_PARTS;
    float *rowM = part, *colM = rowM + 128, *yoffp = colM + 256, *supdp = yoffp + 128, *ddirp = supdp + 128,
          *carryp = ddirp + 128;
    if (!TMA) cp_async_wait<0>();
    fence_proxy_async_shared();  // x and dy (cp.async)
    __syncthreads();  // ... have landed; every warp is done with head j - 1
    if (tid == 0 && j > 0) {  // the last head's dx, from its tile
      tma_store_4d(&map_dx, Dxs, 0, hi - 1, l0, bi);
      tma_store_commit();
    }
    if (j + 1 < s.hg) load_x(j + 1);
    cp_async_commit();
    if (tid == 0 && j + 1 < s.hg) prefetch_states(j + 1);
    if (TMA) mbar_wait(&bars[1 + j % 2], (j / 2) & 1);

    // S = dy.x^T on this warpgroup's 32 columns of s
    float S[16];
    wgmma_fence();
    {
      const Tile a = ktile(Ys), b = ktile(Xs + 4096 * wg);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n32k16_bf16<0, 0>(S, a.k(kk), b.k(kk), kk > 0);
    }
    wgmma_commit();
    const float hh = split(j);  // this head's planes, while dy.x^T runs
    // B . dH^T on this warpgroup's 32 columns of p
    float Dd[16];
    auto issue_dd = [&] {
      if (has_dh) {
        const Tile a = ktile(Bs), b = ktile(dHc + 4096 * wg);
#pragma unroll 1
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int k = TERMS - 1; k >= 0; --k)
            wgmma_m64n32k16_bf16<0, 0>(Dd, a.k(kk), b.k(kk) + k * NB * FBOX / 16, kk > 0 || k < TERMS - 1);
      }
      wgmma_commit();
    };
    // an item's product, [64, 64] on state columns 64 box..: dy.H (e) or x.dH, H or dH MN-major
    auto issue = [&](bool e, float(&T)[32]) {
      if (e ? has_h : has_dh) {
        const Tile a = ktile(e ? Ys : Xs), b = mntile((e ? Hc : dHc) + box * FBOX);
#pragma unroll 1
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int k = TERMS - 1; k >= 0; --k)
            wgmma_m64n64k16_bf16<0, 1>(T, a.k(kk), b.mn(kk) + k * NB * FBOX / 16, kk > 0 || k < TERMS - 1);
      }
      wgmma_commit();
    };
    // an item's product on 32 state columns 64 box + 32 hf.., and its epilogue: the same in halves, so that
    // one half's accumulators are in flight while the other's are read
    auto issue_half = [&](bool e, float(&T)[16], int hf) {
      if (e ? has_h : has_dh) {
        const Tile a = ktile(e ? Ys : Xs), b = mntile((e ? Hc : dHc) + box * FBOX + 64 * hf);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int k = TERMS - 1; k >= 0; --k)
            wgmma_m64n32k16_bf16<0, 1>(T, a.k(kk), b.mn(kk) + k * NB * FBOX / 16, kk > 0 || k < TERMS - 1);
      }
      wgmma_commit();
    };
    float T0[32];
    if (warp == BW_CW && j > 0) dcum(j - 1);
    const float last = scan_chunk64(Ds, A[hi], cum, ecum, wend, lane);
    wgmma_wait<0>();
    wgmma_fence_operand(S);

    // W = S o L o dt_s, Sum W, M = (C.B^T) o W's row and column sums, (C.B^T) o L into the planes
    {
      float G[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = Gs[i * BW_THREADS + tid];
        G[4 * i] = v.x;
        G[4 * i + 1] = v.y;
        G[4 * i + 2] = v.z;
        G[4 * i + 3] = v.w;
      }
      float rows[2] = {0.f, 0.f}, cols[4][2] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 32 * wg + 8 * q + 2 * t;
        float gl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = row + 8 * (e / 2), cc = col + e % 2;
          const float L = cc <= rr ? expf(cum[rr] - cum[cc]) : 0.f;  // masked before the exp
          const float w = S[4 * q + e] * L * Ds[cc];
          const float m = G[4 * q + e] * w;
          Wsum[4 * q + e] += w;
          rows[e / 2] += m;
          cols[q][e % 2] += m;
          gl[e] = G[4 * q + e] * L;
        }
        uint32_t lo[TERMS], up[TERMS];
        split_pair(gl[0], gl[1], lo);
        split_pair(gl[2], gl[3], up);
        const int o0 = row * 128 + (((col / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
        const int o1 = (row + 8) * 128 + (((col / 8) ^ ((row + 8) % 8)) << 4) + (col % 8) * 2;
#pragma unroll
        for (int k = 0; k < TERMS; ++k) {
          *reinterpret_cast<uint32_t*>(Wp + k * FBOX + o0) = lo[k];
          *reinterpret_cast<uint32_t*>(Wp + k * FBOX + o1) = up[k];
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {  // over the warpgroup's 32 columns: the 4 lanes of a row, then its q
        rows[v] += __shfl_xor_sync(0xffffffffu, rows[v], 1);
        rows[v] += __shfl_xor_sync(0xffffffffu, rows[v], 2);
      }
      if (t == 0) {
        rowM[wg * 64 + row] = rows[0];
        rowM[wg * 64 + row + 8] = rows[1];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // over the warp's 16 rows: the 8 lanes of a column
          float v = cols[q][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colM[(warp % 4) * 64 + 32 * wg + 8 * q + 2 * t + e] = v;
        }
    }
    if (tid == 0) tma_store_wait_read<0>();  // the last head's dx has left its tile
    fence_proxy_async_shared();
    __syncthreads();  // the planes of (C.B^T) o L, H and dH are whole

    // ((C.B^T) o L)^T . dy on this warpgroup's 32 columns of p
    float Dc[16];
    wgmma_fence();
    {
      const Tile a = mntile(Wp), b = mntile(Ys + 64 * wg);
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k = TERMS - 1; k >= 0; --k)
          wgmma_m64n32k16_bf16<1, 1>(Dc, a.mn(kk) + k * FBOX / 16, b.mn(kk), kk > 0 || k < TERMS - 1);
    }
    wgmma_commit();
    float Ta[16], Tb[16];  // state 128: each item's product in halves of 32 columns
    issue_dd();
    if (ITEMS == 2)
      issue_half(is_e(0), Ta, 0);
    else
      issue(is_e(0), T0);
    float carry = 0.f;  // this thread's share of <dH, H_out>
    // dC += exp(cum) o (dy . H) and its per-step dot with C; dB += wend dt o (x . dH) and its dot with B
    auto finish = [&](bool e, float(&T)[32], float(&a)[32]) {
      if (!(e ? has_h : has_dh)) return;
      const unsigned char* other = (e ? Cs : Bs) + box * FBOX;
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        const float f = e ? ecum[r] : wend[r] * Ds[r];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float v0 = T[4 * q + 2 * half] * f, v1 = T[4 * q + 2 * half + 1] * f;
          a[4 * q + 2 * half] += v0;
          a[4 * q + 2 * half + 1] += v1;
          const float2 o = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(other + r * 128 + ((q ^ (r % 8)) << 4) + 4 * t));
          dot[half] += v0 * o.x + v1 * o.y;
        }
      }
      if (e) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = dot[half];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) yoffp[box * 64 + row + 8 * half] = v;
        }
      } else {
        carry += dot[0] + dot[1];
      }
    };
    // and its epilogue in halves (issue_half)
    float edot[2] = {0.f, 0.f};  // the E item's per-row dots over its halves
    auto finish_half = [&](bool e, float(&T)[16], float(&a)[32], int hf) {
      if (!(e ? has_h : has_dh)) return;
      const unsigned char* other = (e ? Cs : Bs) + box * FBOX;
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        const float f = e ? ecum[r] : wend[r] * Ds[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int qq = 4 * hf + q;
          const float v0 = T[4 * q + 2 * half] * f, v1 = T[4 * q + 2 * half + 1] * f;
          a[4 * qq + 2 * half] += v0;
          a[4 * qq + 2 * half + 1] += v1;
          const float2 o = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(other + r * 128 + ((qq ^ (r % 8)) << 4) + 4 * t));
          dot[half] += v0 * o.x + v1 * o.y;
        }
      }
      if (e) {
        edot[0] += dot[0];
        edot[1] += dot[1];
        if (hf == 1)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v = edot[half];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) yoffp[box * 64 + row + 8 * half] = v;
          }
      } else {
        carry += dot[0] + dot[1];
      }
    };
    // dx = dxdt dt, dxdt = ((C.B^T) o L)^T . dy + wend o (B . dH^T), and per step dxdt.x and x.(B.dH^T) over
    // this warpgroup's columns
    auto dx_out = [&] {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sr = row + 8 * half;
        const float we = wend[sr], d = Ds[sr];
        float dd = 0.f, su = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pc = 32 * wg + 8 * q + 2 * t;
          // B.dH^T is 0 with no dH (selected, not written: a write to an accumulator while a product of the
          // same stage is in flight serialises the wgmma)
          const float d0 = has_dh ? Dd[4 * q + 2 * half] : 0.f, d1 = has_dh ? Dd[4 * q + 2 * half + 1] : 0.f;
          const float v0 = Dc[4 * q + 2 * half] + we * d0, v1 = Dc[4 * q + 2 * half + 1] + we * d1;
          *reinterpret_cast<__nv_bfloat162*>(Dxs + sr * 128 + (((pc / 8) ^ (sr % 8)) << 4) + (pc % 8) * 2) =
              __floats2bfloat162_rn(v0 * d, v1 * d);
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Xs + sr * 128 + (((pc / 8) ^ (sr % 8)) << 4) + (pc % 8) * 2));
          dd += v0 * xv.x + v1 * xv.y;
          su += d0 * xv.x + d1 * xv.y;
        }
        dd += __shfl_xor_sync(0xffffffffu, dd, 1);
        dd += __shfl_xor_sync(0xffffffffu, dd, 2);
        su += __shfl_xor_sync(0xffffffffu, su, 1);
        su += __shfl_xor_sync(0xffffffffu, su, 2);
        if (t == 0) {
          ddirp[wg * 64 + sr] = dd;
          supdp[wg * 64 + sr] = su;
        }
      }
    };
    {  // Dc, Dd, T0 in that order
      wgmma_wait<1>();
      wgmma_fence_operand(Dc);
      wgmma_fence_operand(Dd);
      dx_out();
      if constexpr (ITEMS == 2) {
        issue_half(is_e(0), Tb, 1);
        wgmma_wait<1>();
        wgmma_fence_operand(Ta);
        finish_half(is_e(0), Ta, acc[0], 0);
        wgmma_fence();
        issue_half(is_e(1), Ta, 0);
        wgmma_wait<1>();
        wgmma_fence_operand(Tb);
        finish_half(is_e(0), Tb, acc[0], 1);
        wgmma_fence();
        issue_half(is_e(1), Tb, 1);
        wgmma_wait<1>();
        wgmma_fence_operand(Ta);
        finish_half(is_e(1), Ta, acc[ITEMS - 1], 0);
        wgmma_wait<0>();
        wgmma_fence_operand(Tb);
        finish_half(is_e(1), Tb, acc[ITEMS - 1], 1);
      } else {
        wgmma_wait<0>();
        wgmma_fence_operand(T0);
        finish(is_e(0), T0, acc[0]);
      }
    }
    if (has_dh) carry += expf(last) * hh;  // <dH, H_out> = exp(cum_last) <dH, H> + Sum (x.dH wend dt) o B
    carry = warp_sum(carry);
    if (lane == 0) carryp[warp] = carry;
    fence_proxy_async_shared();  // dx's tile, to the TMA store
  }
  __syncthreads();  // the last head's partials are whole; no warp reads the planes
  if (tid == 0) {
    tma_store_4d(&map_dx, Dxs, 0, h0 + s.hg - 1, l0, bi);
    tma_store_commit();
  }
  if (warp == BW_CW) dcum(s.hg - 1);

  // Sum W into the planes [l][s], and transposed [s][l] (where H's were), then within the chunk
  // dC += (Sum W).B (s <= l) and dB += (Sum W)^T.C (l >= s), both with A K-major, so that one code path
  // with the operands picked at run time serves either item (a wgmma on the same accumulators in two
  // branches serialises them)
  unsigned char* WTp = Hp;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = 32 * wg + 8 * q + 2 * t;
    uint32_t lo[TERMS], up[TERMS];
    split_pair(Wsum[4 * q], Wsum[4 * q + 1], lo);
    split_pair(Wsum[4 * q + 2], Wsum[4 * q + 3], up);
    const int o0 = row * 128 + (((col / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
    const int o1 = (row + 8) * 128 + (((col / 8) ^ ((row + 8) % 8)) << 4) + (col % 8) * 2;
#pragma unroll
    for (int k = 0; k < TERMS; ++k) {
      *reinterpret_cast<uint32_t*>(Wp + k * FBOX + o0) = lo[k];
      *reinterpret_cast<uint32_t*>(Wp + k * FBOX + o1) = up[k];
      const uint32_t v[4] = {lo[k] & 0xffffu, lo[k] >> 16, up[k] & 0xffffu, up[k] >> 16};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (l, s) = (row + 8 (e / 2), col + e % 2) at row s, column l
        const int r = col + e % 2, cl = row + 8 * (e / 2);
        *reinterpret_cast<uint16_t*>(WTp + k * FBOX + r * 128 + (((cl / 8) ^ (r % 8)) << 4) + (cl % 8) * 2) =
            (uint16_t)v[e];
      }
    }
  }
  fence_proxy_async_shared();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) wgmma_fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool e = is_e(i);
    const Tile a = ktile(e ? Wp : WTp), b = mntile((e ? Bs : Cs) + box * FBOX);
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int k = TERMS - 1; k >= 0; --k) wgmma_m64n64k16_bf16<0, 1>(acc[i], a.k(kk) + k * FBOX / 16, b.mn(kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    wgmma_fence_operand(acc[i]);
    float* out = is_e(i) ? pdC : pdB;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long at = ((bi * (long long)s.l + l0 + row + 8 * half) * groups + grp) * N + 64 * box + 2 * t;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(out + at + 8 * q) = make_float2(acc[i][4 * q + 2 * half], acc[i][4 * q + 2 * half + 1]);
    }
  }
  cp_async_wait<0>();
  if (tid == 0) tma_store_wait<0>();
}

template <int N, bool TMA>
int launch_bwd_wgmma(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C, const bf16* dy,
                     const float* dstate, bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC, float* hbuf,
                     float* dhbuf, float* pdB, float* pdC, float* pdA, int carried, const BwdShape& s,
                     cudaStream_t stream) {
  const int nc = s.l / BCL, groups = s.h / s.hg;
  CUtensorMap mx{}, my{}, mB{}, mC{}, mdx{};
  int dev = 0;
  const cudaError_t ce = make_context_current(&dev);  // the driver's encoder needs a current context
  if (ce != cudaSuccess) return (int)ce;
  const long long sdx[3] = {(long long)s.l * s.h * BP, BP, (long long)s.h * BP};  // dx contiguous [b, l, h, 64]
  int merr = encode_rows(&mdx, dx, BP, s.h, s.l, s.b, sdx);
  if (merr != 0) return merr;
  if (TMA) {
    const long long sx[3] = {s.sxb, s.sxh, s.sxl}, sy[3] = {s.syb, s.syh, s.syl};
    const long long sB[3] = {s.sBb, 0, s.sBl}, sC[3] = {s.sCb, 0, s.sCl};
    int err = encode_rows(&mx, x, BP, s.h, s.l, s.b, sx);
    if (err == 0) err = encode_rows(&my, dy, BP, s.h, s.l, s.b, sy);
    if (err == 0) err = encode_rows(&mB, B, N, 1, s.l, s.b, sB);
    if (err == 0) err = encode_rows(&mC, C, N, 1, s.l, s.b, sC);
    if (err != 0) return err;
  }
  const int st_smem = bwd_states_smem(), ch_smem = bwd_wgmma_smem(N, s.hg);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_states_mma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_bwd_chunk_kernel<N, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, ch_smem);
  if (err != cudaSuccess) return (int)err;
  const int dirs = carried ? 1 : 2;  // given the forward's states, the gradients' direction alone
  ssd_scan_bwd_states_mma_kernel<N><<<(unsigned)(s.b * s.h * (N / SLICE) * dirs), ST_THREADS, st_smem, stream>>>(
      x, dt, A, B, C, dy, dstate, hbuf, dhbuf, s, dirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_bwd_chunk_kernel<N, TMA><<<(unsigned)(s.b * nc * groups), BW_THREADS, ch_smem, stream>>>(
      mx, my, mB, mC, mdx, x, dt, A, B, C, dy, dstate, hbuf, dhbuf, dx, ddt, pdB, pdC, pdA, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)s.b * s.l * s.n + s.h;
  ssd_scan_bwd_mma_sum_kernel<bf16><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      pdB, pdC, pdA, dB, dC, dA, s.b, s.l, s.h, s.n, groups, nc);
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
// ssd_scan_mma_bf16_kernel<n, pt>, 3 ssd_scan_fwd_states_kernel<n> then
// ssd_scan_fwd_chunk_kernel<n> (x, B, C and y bf16 on routes 2 and 3; on 3
// chunk 64, p a multiple of 64, n 64 or 128, rows TMA can address, hg heads a
// chunk-kernel block, hbuf fp32 [b, h, l / 64, p, n] scratch: the states
// entering the chunks); dt, A and state are float32.  y is contiguous [b, l, h, p], state contiguous
// [b, h, p, n].  Shapes, routes and the shared-memory size are validated by
// the Python wrapper.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B, const void* C,
                            void* y, float* state, int route, int b, int l, int h, int p, int n, int chunk,
                            int pt, long long sxb, long long sxl, long long sxh, long long sdb, long long sdl,
                            long long sdh, long long sBb, long long sBl, long long sCb, long long sCl,
                            float* hbuf, int hg, void* stream) {
  const SsdShape s{b, l, h, p, n, chunk, pt, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) return launch_simt<float>(x, dt, A, B, C, y, state, s, st);
  if (route == 1) return launch_simt<bf16>(x, dt, A, B, C, y, state, s, st);
  if (route == 2 && chunk % 16 == 0 && chunk <= MAX_CL)
    return launch_mma_variant(n, pt, x, dt, A, B, C, y, state, s, st);
  if (route == 3 && n == 64) return launch_fwd_wgmma<64>(x, dt, A, B, C, y, state, hbuf, s, hg, st);
  if (route == 3 && n == 128) return launch_fwd_wgmma<128>(x, dt, A, B, C, y, state, hbuf, s, hg, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of route 3's states kernel (kernel 0) or chunk kernel (1) at state
// width n and hg heads a chunk-kernel block, in bytes.
extern "C" int ssd_scan_fwd_smem_bytes(int n, int hg, int kernel) {
  return kernel == 0 ? bwd_states_smem() : fwd_chunk_smem(n, hg);
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

// The backward on the tensor cores with the mma.sync chunk kernel (bf16; chunk 64, p 64, state width n 64 or
// 128; x, B, C and dy rows 16-byte aligned: the shapes the wrapper's bwd_route sends to the wgmma route, which
// replaced this one; run_bwd_route(route="mma") still runs it): dx, ddt, dA, dB, dC as ssd_scan_bwd gives them, from the same
// inputs.  hg: heads a block of the chunk kernel takes (dividing h).  Scratch, all fp32: hbuf and dhbuf
// [b, h, l / 64, 64, n] (the states entering the chunks and the gradients of those leaving them), pdB and
// pdC [b, l, h / hg, n], pdA [b, l / 64, h].  Launches ssd_scan_bwd_states_mma_kernel<n>,
// ssd_scan_bwd_chunk_mma_kernel<n> and ssd_scan_bwd_mma_sum_kernel on `stream`; returns the first launch's
// CUDA error, or 0.
extern "C" int ssd_scan_bwd_mma(const void* x, const float* dt, const float* A, const void* B, const void* C,
                                const void* dy, const float* dstate, void* dx, float* ddt, float* dA, void* dB,
                                void* dC, float* hbuf, float* dhbuf, float* pdB, float* pdC, float* pdA, int b,
                                int l, int h, int n, int hg, long long sxb, long long sxl, long long sxh,
                                long long sdb, long long sdl, long long sdh, long long sBb, long long sBl,
                                long long sCb, long long sCl, long long syb, long long syl, long long syh,
                                void* stream) {
  if (l % BCL != 0 || hg < 1 || h % hg != 0) return (int)cudaErrorInvalidValue;
  const BwdShape s{b, l, h, n, hg, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl, syb, syl, syh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_MMA_ARGS                                                                                        \
  static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B), static_cast<const bf16*>(C),               \
      static_cast<const bf16*>(dy), dstate, static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB),           \
      static_cast<bf16*>(dC), hbuf, dhbuf, pdB, pdC, pdA, s, st
  if (n == 64) return launch_bwd_mma<64>(SSD_BWD_MMA_ARGS);
  if (n == 128) return launch_bwd_mma<128>(SSD_BWD_MMA_ARGS);
#undef SSD_BWD_MMA_ARGS
  return (int)cudaErrorInvalidValue;
}

// The backward on wgmma (bf16; the shapes ssd_scan_bwd_mma takes): the same outputs from the same inputs
// and scratch.  carried: hbuf already holds the states entering chunks 1 .. l / 64 - 1 (the forward's, route
// 3 of ssd_scan_fwd), so the states kernel runs the gradients' direction alone; else it writes them first.
// tma: TMA can address the rows of x, dy, B and C (16-byte-aligned rows, no zero stride).  Launches
// ssd_scan_bwd_states_mma_kernel<n>, ssd_scan_bwd_chunk_kernel<n, tma> and ssd_scan_bwd_mma_sum_kernel on
// `stream`; returns the first launch's CUDA error (or a tensor-map error), or 0.
extern "C" int ssd_scan_bwd_wgmma(const void* x, const float* dt, const float* A, const void* B, const void* C,
                                  const void* dy, const float* dstate, void* dx, float* ddt, float* dA, void* dB,
                                  void* dC, float* hbuf, float* dhbuf, float* pdB, float* pdC, float* pdA,
                                  int carried, int tma, int b, int l, int h, int n, int hg, long long sxb,
                                  long long sxl, long long sxh, long long sdb, long long sdl, long long sdh,
                                  long long sBb, long long sBl, long long sCb, long long sCl, long long syb,
                                  long long syl, long long syh, void* stream) {
  if (l % BCL != 0 || hg < 1 || h % hg != 0) return (int)cudaErrorInvalidValue;
  const BwdShape s{b, l, h, n, hg, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl, syb, syl, syh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_WGMMA_ARGS                                                                                      \
  static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B), static_cast<const bf16*>(C),               \
      static_cast<const bf16*>(dy), dstate, static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB),           \
      static_cast<bf16*>(dC), hbuf, dhbuf, pdB, pdC, pdA, carried, s, st
  if (n == 64) return tma ? launch_bwd_wgmma<64, true>(SSD_BWD_WGMMA_ARGS) : launch_bwd_wgmma<64, false>(SSD_BWD_WGMMA_ARGS);
  if (n == 128)
    return tma ? launch_bwd_wgmma<128, true>(SSD_BWD_WGMMA_ARGS) : launch_bwd_wgmma<128, false>(SSD_BWD_WGMMA_ARGS);
#undef SSD_BWD_WGMMA_ARGS
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the wgmma backward's chunk kernel at state width n and hg heads a
// block, in bytes (its states kernel's: ssd_scan_bwd_mma_smem_bytes(n, 0)).
extern "C" int ssd_scan_bwd_wgmma_smem_bytes(int n, int hg) { return bwd_wgmma_smem(n, hg); }

// Dynamic shared memory of one block of the tensor-core backward's states kernel (kernel 0) or chunk
// kernel (1) at state width n, in bytes.
extern "C" int ssd_scan_bwd_mma_smem_bytes(int n, int kernel) { return kernel == 0 ? bwd_states_smem() : bwd_chunk_smem(n); }

// Blocks of ssd_scan_mma_bf16_kernel<n, pt> at `chunk` one SM holds at once
// on the current device, or minus a cudaError.
extern "C" int ssd_scan_mma_occupancy(int n, int pt, int chunk) { return occupancy_mma_variant(n, pt, chunk); }

// Dynamic shared memory of one ssd_scan_mma_bf16_kernel block, in bytes.
extern "C" int ssd_scan_mma_smem_bytes(int n, int pt, int chunk) { return mma_smem_bytes(chunk, n, pt); }

// The bf16 terms this build splits each inexact product operand into (SSD_TERMS).
extern "C" int ssd_scan_mma_terms() { return TERMS; }
