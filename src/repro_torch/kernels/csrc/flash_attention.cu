// Forward flash attention (online softmax, causal / sliding window, GQA) for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _flash_kernel).  Same function: q [B, H, S, D], k/v [B, KVH, S, D],
// q-head i reads kv-head i / (H / KVH) (the reference's (i % h) // group over
// the folded batch*heads axis), scores q.k / sqrt(D) with an optional causal
// mask, and the running max, normaliser and accumulator in fp32; p is
// rounded to the input type before P.V, as the Pallas kernel casts it to
// v.dtype, while the normaliser sums the unrounded p.  Two things the Pallas
// kernel leaves to its caller are done here: a sliding window (key j visible
// to query i only if i - j < window, the mask of blocks._sdpa_chunk) and a
// ragged S (the edge tiles are masked; the reference's S % block assert is a
// TPU tiling limit, not part of the function).  Strides are arguments: the
// model passes its [b, s, h, d] tensors as transposed views, with no copy.
//
// Bound on the H100 SXM: bytes.  At the LM prefill shapes (bf16, causal, S
// 512, k/v [4, 8, 512, D]) a call reads q, k, v and writes o once: 21 / 42 /
// 50 MB for granite-3-2b (q [4,32,512,64]), phi3.5-moe (q [4,32,512,128]) and
// llama4-scout (q [4,40,512,128]), 6.3 / 12.5 / 15.0 us at 3.35 TB/s, against
// 4.3 / 8.6 / 10.8 GFLOP, 4.4 / 8.7 / 10.9 us at the 989 TFLOP/s bf16 peak.
// What sets the time instead is latency: at D 128 one 226-register block
// fits an SM, so nothing covers a block's prologue (Q and the first K/V
// tiles in flight) and epilogue (the last barrier, the store), and within a
// tile the products, the softmax and the copies of a warp wait on one
// another (mma.sync issues in order).  A persistent schedule and wgmma with
// TMA are the next steps (PERF.md).
//
// bf16: flash_fwd_mma_bf16_kernel<D>, D in {16, 32, 64, 80, 128, 192}, on the
// tensor cores.
// - Grid: one block per (batch*q-head, q tile of BQ = 16 * warps rows); each
//   warp owns 16 query rows.  4 warps (BQ 64) at D <= 80; 8 warps (BQ 128) at
//   D 128 and 192, where each K/V tile then serves twice the rows (4 warps at
//   D 128 are slower on the card: scripts/flash_tiles.py, PERF.md).  Causal q
//   tiles run heaviest first.
// - Q is copied once with cp.async into shared memory and ldmatrix'd into
//   m16n8k16 A fragments that stay in registers for the whole KV loop; at D
//   192 (nemotron-4-340b) the fp32 output accumulator alone takes 96
//   registers a thread, so Q stays in shared memory beside the ring and each
//   k16 step of Q.K^T ldmatrix's its fragment again (one more ldmatrix per
//   four mma.sync).
// - K and V stream in 64-key tiles through a 3-stage cp.async ring, as bf16
//   as stored (no widening, no transposed copy): 16-byte copies (8-byte ones
//   where a row is only 8-byte aligned), zero-filled past the ragged end of
//   S.  The copy of tile t + 2 is issued before tile t's math, so one
//   barrier per tile orders the ring.  Rows are padded by 16 bytes, so the
//   eight rows an ldmatrix phase reads fall in distinct banks (row pitches of
//   48 / 80 / 144 / 176 / 272 / 400 bytes: 12, 20, 36, 44, 68 and 100 words,
//   each an odd multiple of 4 words modulo 32, so eight rows of 4 words
//   cover the 32 banks once).  Q
//   aliases the ring's last stage until its fragments are in registers (at D
//   192 it has its own region).  Where a row's 16-byte chunks do not divide
//   the block's threads (D 80: 10, D 192: 24), the copy walks the tile's
//   chunks in order, THREADS at a time.
// - S = Q.K^T and O += P.V run on mma.sync m16n8k16 bf16 with fp32
//   accumulators: K feeds ldmatrix as the B operand of the first, V feeds
//   ldmatrix.trans as the B operand of the second.
// - Online softmax on the accumulator fragments: the row max over the 4
//   lanes that share a row takes two shuffles; scale*log2(e) is folded into
//   one FMA before a single ex2.approx; the per-lane row sums are reduced (two
//   shuffles) once, in the epilogue.  p is rounded to bf16 and packed straight
//   into the A fragments of P.V: the C layout of two m16n8 tiles is the A
//   layout of one k16 step, so P never touches shared memory.
// - Masks only where a warp's 16 x 64 block needs them (the causal diagonal,
//   the window's first tiles, the ragged last tile); interior blocks run
//   unmasked.  Blocks a warp cannot see are skipped (causal tiles above the
//   diagonal and window tiles before the window are not even loaded).
// - Epilogue: divide by max(l, 1e-30), round once to bf16, stage each warp's
//   16 rows in shared memory and store 16 bytes at a time into the strided
//   output.
// - Occupancy (ptxas -v on sm_90a, PERF.md): shared memory 3 stages x (K + V)
//   x 64 x (D + 8) x 2 bytes = 18 / 30 / 54 / 66 / 102 / 150 KB a block at D
//   16 / 32 / 64 / 80 / 128 / 192, plus Q's 50 KB at D 192.  At D <= 64, 4
//   warps and at most 168 registers (110 / 128 / 167 used), so 3 blocks (12
//   warps) an SM; at D 80, 4 warps with up to 255 registers (its accumulator
//   and Q fragments take 12 more than D 64's 167), 2 blocks an SM; at D 128
//   and 192, 8 warps with up to 255 registers, 1 block (8 warps) an SM.  No
//   spills (chip_smoke.py fails on one).
//
// fp32: flash_fwd_kernel<D>, on the SIMT pipes (TF32 would break the
// reference's 2e-4).  One block per (batch*q-head, 64-row q tile), 256
// threads, each owning a 4 x 4 patch of the 64 x 64 score tile and 4 rows x
// D/16 columns of the output (in float4 runs where D is a multiple of 64,
// float2 at D 32, single floats at D 16 and 80); q and K staged transposed in
// shared memory (172 KB a block at D 192),
// P back through shared memory for P.V; row max and sum reduced over the 16
// threads of a row group with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct AttnShape {
  int B, H, KVH, S;
  long long sqb, sqh, sqs;  // element strides of q over batch, head, position (d is unit)
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MBK = 64;    // keys per K/V tile
constexpr int MPAD = 8;    // row padding in elements (16 bytes)
constexpr int STAGES = 3;  // depth of the K/V ring

// Warps a block at D 128: 8 (BQ 128).  scripts/flash_tiles.py builds a copy
// with -DFLASH_D128_WARPS=4 (BQ 64, two blocks an SM) to time the other tiling.
#ifndef FLASH_D128_WARPS
#define FLASH_D128_WARPS 8
#endif

template <int D>
__host__ __device__ constexpr int mma_warps() {
  return D == 128 ? FLASH_D128_WARPS : D == 192 ? 8 : 4;  // BQ 64 up to D 80
}

// Blocks per SM that __launch_bounds__ asks for: 3 at D <= 64 (at most 168
// registers a thread), 2 at D 80 (at most 255); at D 128 and 192 as many as
// fill 8 warps.
template <int D>
__host__ __device__ constexpr int mma_min_blocks() {
  return D == 128 ? 8 / FLASH_D128_WARPS : D == 192 ? 1 : D == 80 ? 2 : 3;
}

// Q kept in shared memory for the whole KV loop instead of in registers.
template <int D>
__host__ __device__ constexpr bool mma_q_in_smem() {
  return D == 192;
}

template <int D>
constexpr int mma_smem_bytes() {
  // K and V tiles of every stage, and Q's own rows where it stays in shared memory
  const int rows = STAGES * 2 * MBK + (mma_q_in_smem<D>() ? mma_warps<D>() * 16 : 0);
  return rows * (D + MPAD) * (int)sizeof(bf16);
}

// 2^x in one MUFU instruction (denormal results flush to 0, far below bf16's use here).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 16-byte chunk of a row into shared memory, zero-filled unless `ok`
// (`src` is then any valid address: nothing is read from it).
__device__ __forceinline__ void copy_chunk(bf16* dd, const bf16* gg, bool ok, bool vec16, const bf16* src) {
  if (vec16) {
    cp_async16(dd, ok ? gg : src, ok ? 16 : 0);
  } else {
    cp_async8(dd, ok ? gg : src, ok ? 8 : 0);
    cp_async8(dd + 4, ok ? gg + 4 : src, ok ? 8 : 0);
  }
}

// ROWS rows of D elements from global (row stride `stride`) into shared
// memory rows of D + MPAD; rows from `valid` on are zero-filled.  Where the
// block's threads are a multiple of a row's chunks, each thread copies one
// 16-byte column of every RSTEP-th row, so its addresses advance by a
// constant step; otherwise (D 80, D 192) the block walks the tile's chunks
// in order, THREADS at a time.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int valid, bool vec16,
                                          int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "whole passes of the block");
  if constexpr (THREADS % CPR == 0) {
    constexpr int RSTEP = THREADS / CPR;  // rows per pass of the block
    const int r = tid / CPR, col = (tid % CPR) * 8;
    bf16* d = dst + r * (D + MPAD) + col;
    const bf16* g = src + r * stride + col;
#pragma unroll
    for (int it = 0; it < ROWS / RSTEP; ++it)
      copy_chunk(d + it * RSTEP * (D + MPAD), g + it * RSTEP * stride, r + it * RSTEP < valid, vec16, src);
  } else {
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / CPR, col = (e % CPR) * 8;
      copy_chunk(dst + r * (D + MPAD) + col, src + r * stride + col, r < valid, vec16, src);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(mma_warps<D>() * 32, mma_min_blocks<D>())
flash_fwd_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ o, AttnShape p, int vec16) {
  constexpr int WARPS = mma_warps<D>();
  constexpr int THREADS = WARPS * 32;
  constexpr int BQ = WARPS * 16;
  constexpr int LD = D + MPAD;
  constexpr int KS = D / 16;    // k16 steps of Q.K^T
  constexpr int NT = MBK / 8;   // n8 tiles of a warp's 16 x 64 scores
  constexpr int PK = MBK / 16;  // k16 steps of P.V
  constexpr int DT = D / 8;     // n8 tiles of a warp's 16 x D output
  constexpr int STAGE = 2 * MBK * LD;
  constexpr bool QSMEM = mma_q_in_smem<D>();
  static_assert(BQ <= 2 * MBK, "Q and the output are staged in one ring stage");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][K: MBK rows, V: MBK rows][LD]
  // [BQ][LD]: after the ring for the whole loop (QSMEM), else in its last stage until Q is in registers
  bf16* Qs = ring + (QSMEM ? STAGES : STAGES - 1) * STAGE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.H;
  const int hq = blockIdx.x % p.H;
  const int hk = hq / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int r0 = q0 + warp * 16;                      // this warp's first row

  const bf16* qb = q + b * p.sqb + hq * p.sqh;
  const bf16* kb = k + b * p.skb + hk * p.skh;
  const bf16* vb = v + b * p.svb + hk * p.svh;
  bf16* ob = o + b * p.sob + hq * p.soh;

  const int q_last = min(q0 + BQ, p.S) - 1;
  int kt_end = (p.S + MBK - 1) / MBK;
  if (p.causal) kt_end = min(kt_end, q_last / MBK + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / MBK : 0;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * MBK;
    bf16* ks = ring + stage * STAGE;
    load_rows<MBK, D, THREADS>(ks, kb + k0 * p.sks, p.sks, p.S - k0, vec16, tid);
    load_rows<MBK, D, THREADS>(ks + MBK * LD, vb + k0 * p.svs, p.svs, p.S - k0, vec16, tid);
  };

  load_rows<BQ, D, THREADS>(Qs, qb + q0 * p.sqs, p.sqs, p.S - q0, vec16, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kt_begin + st < kt_end) load_kv(kt_begin + st, st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // Q has landed (this thread's copies)
  __syncthreads();              // ... everyone's

  const bf16* qrow = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // this lane's ldmatrix row of Q
  uint32_t qf[QSMEM ? 1 : KS][4];  // Q's A fragments, when they stay in registers
  if constexpr (!QSMEM) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows lane/4 and lane/4 + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the normaliser
  const float c = p.scale * 1.4426950408889634f;  // exp(x * scale) = exp2(x * c)

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % STAGES;
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; tile kt - 1 (and Q) is no longer read
    if (kt + STAGES - 1 < kt_end) load_kv(kt + STAGES - 1, (stage + STAGES - 1) % STAGES);
    cp_async_commit();

    const bf16* ks = ring + stage * STAGE;
    const bf16* vs = ks + MBK * LD;
    const int k0 = kt * MBK;
    // this warp's rows r0 .. r0 + 15 against keys k0 .. k0 + 63: S = Q.K^T, online softmax, O += P.V
    if (r0 >= p.S || (p.causal && k0 > r0 + 15) || (p.window > 0 && r0 - (k0 + MBK - 1) >= p.window)) continue;
    // only the causal diagonal, the window's first keys and the ragged end need the mask
    const bool masked = k0 + MBK > p.S || (p.causal && k0 + MBK - 1 > r0) ||
                        (p.window > 0 && r0 + 15 - k0 >= p.window);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QSMEM) {
        ldmatrix_x4(qa, qrow + kk * 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {  // keys nt*8 .. nt*8 + 15: two n8 tiles
        uint32_t r[4];
        ldmatrix_x4(r, ks + (nt * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[nt], qa, r[0], r[1]);
        mma_bf16(s[nt + 1], qa, r[2], r[3]);
      }
    }

    if (masked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + lane / 4 + (e / 2) * 8;
          const int j = k0 + nt * 8 + (lane % 4) * 2 + e % 2;
          const bool ok = j < p.S && (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
          if (!ok) s[nt][e] = -INFINITY;
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float mc[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mc[h] = mx[h] == -INFINITY ? 0.f : mx[h] * c;  // a row with nothing visible yet
      alpha[h] = ex2(m[h] * c - mc[h]);
      m[h] = mx[h];
    }

    uint32_t pf[PK][4];  // P as the A fragments of P.V
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = ex2(fmaf(s[nt][0], c, -mc[0])), p1 = ex2(fmaf(s[nt][1], c, -mc[0]));
      const float p2 = ex2(fmaf(s[nt][2], c, -mc[1])), p3 = ex2(fmaf(s[nt][3], c, -mc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {  // columns dt*8 .. dt*8 + 15: two n8 tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
        mma_bf16(acc[dt], pf[kk], r[0], r[1]);
        mma_bf16(acc[dt + 1], pf[kk], r[2], r[3]);
      }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: stage 0 holds the output
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  bf16* os = ring + warp * 16 * LD;  // this warp's 16 rows
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    bf16* cell = os + (lane / 4) * LD + dt * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(cell) = __floats2bfloat162_rn(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(cell + 8 * LD) =
        __floats2bfloat162_rn(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16 * CPR chunks of 16 bytes, CPR / 2 per lane
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int e = lane + it * 32;
    const int r = e / CPR, col = (e % CPR) * 8;
    if (r0 + r >= p.S) continue;
    const bf16* src = os + r * LD + col;
    bf16* dst = ob + (long long)(r0 + r) * p.sos + col;
    if (vec16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      reinterpret_cast<uint2*>(dst)[0] = reinterpret_cast<const uint2*>(src)[0];
      reinterpret_cast<uint2*>(dst)[1] = reinterpret_cast<const uint2*>(src)[1];
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, const AttnShape& p, int vec16,
               cudaStream_t stream) {
  constexpr int WARPS = mma_warps<D>();
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.S + 16 * WARPS - 1) / (16 * WARPS)));
  kernel<<<grid, WARPS * 32, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), static_cast<bf16*>(o), p, vec16);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA on the SIMT pipes, no TF32
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int PAD = 4;        // row padding that keeps float4 rows 16-byte aligned

template <int D>
constexpr int smem_floats() {
  return 2 * D * (BQ + PAD) + BK * (D + PAD) + BK * (BQ + PAD);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, AttnShape p) {
  constexpr int LDT = BQ + PAD;  // row length of the transposed tiles
  constexpr int LDV = D + PAD;
  constexpr int V4 = D / 4;                    // 4-element vectors per row
  constexpr int VW = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;  // output columns per vector (D 16 and 80: 1)
  constexpr int NG = D / (16 * VW);            // vectors of output per thread and row
  constexpr int DC = VW * NG;                  // output columns per thread
  static_assert(BQ == BK && BQ == 64, "the 16 x 16 thread grid covers 64 x 64 tiles");

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][LDT]  Qt[d][i] = q[q0 + i][d]
  float* Kt = Qt + D * LDT;      // [D][LDT]  Kt[d][j] = k[k0 + j][d]
  float* Vs = Kt + D * LDT;      // [BK][LDV] Vs[j][d] = v[k0 + j][d]
  float* Pt = Vs + BK * LDV;     // [BK][LDT] Pt[j][i] = p[i][j]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // score columns tx*4 .. tx*4+3
  const int b = blockIdx.x / p.H;
  const int hq = blockIdx.x % p.H;
  const int hk = hq / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first

  const float* qb = q + b * p.sqb + hq * p.sqh;
  const float* kb = k + b * p.skb + hk * p.skh;
  const float* vb = v + b * p.svb + hk * p.svh;
  float* ob = o + b * p.sob + hq * p.soh;

  for (int e = tid; e < BQ * V4; e += THREADS) {
    const int i = e / V4, d = (e % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + i < p.S) val = __ldg(reinterpret_cast<const float4*>(qb + (long long)(q0 + i) * p.sqs + d));
    Qt[(d + 0) * LDT + i] = val.x;
    Qt[(d + 1) * LDT + i] = val.y;
    Qt[(d + 2) * LDT + i] = val.z;
    Qt[(d + 3) * LDT + i] = val.w;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, p.S) - 1;
  int kt_end = (p.S + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BK * V4; e += THREADS) {
      const int j = e / V4, d = (e % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < p.S) {
        kv = __ldg(reinterpret_cast<const float4*>(kb + (long long)(k0 + j) * p.sks + d));
        vv = __ldg(reinterpret_cast<const float4*>(vb + (long long)(k0 + j) * p.svs + d));
      }
      Kt[(d + 0) * LDT + j] = kv.x;
      Kt[(d + 1) * LDT + j] = kv.y;
      Kt[(d + 2) * LDT + j] = kv.z;
      Kt[(d + 3) * LDT + j] = kv.w;
      *reinterpret_cast<float4*>(&Vs[j * LDV + d]) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx * 4 + c;
        bool ok = kj < p.S;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && qi - kj < p.window;
        s[r][c] = ok ? s[r][c] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      const float alpha = expf(m[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[r][c] - m_use);
        rs += pv;
        s[r][c] = pv;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Pt[(tx * 4 + c) * LDT + ty * 4 + r] = s[r][c];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[j * LDT + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[DC];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = &Vs[j * LDV + g * 16 * VW + tx * VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          vv[g * 4 + 0] = t.x;
          vv[g * 4 + 1] = t.y;
          vv[g * 4 + 2] = t.z;
          vv[g * 4 + 3] = t.w;
        } else if constexpr (VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(src);
          vv[g * 2 + 0] = t.x;
          vv[g * 2 + 1] = t.y;
        } else {
          vv[g] = *src;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(av[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + (long long)qi * p.sos;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) orow[g * 16 * VW + tx * VW + e] = acc[r][g * VW + e] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, const AttnShape& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.S + BQ - 1) / BQ));
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                       static_cast<const float*>(v), static_cast<float*>(o), p);
  return (int)cudaGetLastError();
}

// Every row of q, k, v and o starts 16-byte aligned (the wrapper checks 8 bytes
// for bf16: strides that are multiples of 4 elements and 16-byte base pointers).
bool rows_16b(const void* q, const void* k, const void* v, const void* o, const AttnShape& p) {
  const long long strides[] = {p.sqb, p.sqh, p.sqs, p.skb, p.skh, p.sks, p.svb, p.svh, p.svs, p.sob, p.soh, p.sos};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  const void* ptrs[] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted).  dtype 0 is float32 (SIMT kernel), 1 is bfloat16 (tensor-core
// kernel); o has q's shape and type.  Shapes, strides and alignment are
// validated by the Python wrapper.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                                   int B, int H, int KVH, int S, int D,
                                   long long sqb, long long sqh, long long sqs,
                                   long long skb, long long skh, long long sks,
                                   long long svb, long long svh, long long svs,
                                   long long sob, long long soh, long long sos,
                                   int causal, int window, float scale, void* stream) {
  const AttnShape p{B, H, KVH, S, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
                    causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(q, k, v, o, p, st);
      case 32: return launch_f32<32>(q, k, v, o, p, st);
      case 64: return launch_f32<64>(q, k, v, o, p, st);
      case 80: return launch_f32<80>(q, k, v, o, p, st);
      case 128: return launch_f32<128>(q, k, v, o, p, st);
      case 192: return launch_f32<192>(q, k, v, o, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    const int vec16 = rows_16b(q, k, v, o, p);
    switch (D) {
      case 16: return launch_mma<16>(q, k, v, o, p, vec16, st);
      case 32: return launch_mma<32>(q, k, v, o, p, vec16, st);
      case 64: return launch_mma<64>(q, k, v, o, p, vec16, st);
      case 80: return launch_mma<80>(q, k, v, o, p, vec16, st);
      case 128: return launch_mma<128>(q, k, v, o, p, vec16, st);
      case 192: return launch_mma<192>(q, k, v, o, p, vec16, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
