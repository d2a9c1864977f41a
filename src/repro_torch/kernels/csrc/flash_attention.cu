// Forward flash attention (online softmax, causal / sliding window, GQA) for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _flash_kernel).  Same function: q [B, H, Sq, D], k/v [B, KVH, Skv, D],
// q-head i reads kv-head i / (H / KVH) (the reference's (i % h) // group over
// the folded batch*heads axis), scores q.k / sqrt(D) with an optional causal
// mask, and the running max, normaliser and accumulator in fp32; p is
// rounded to the input type before P.V, as the Pallas kernel casts it to
// v.dtype, while the normaliser sums the unrounded p.  Three things the
// Pallas kernel leaves to its caller are done here, each with the semantics
// of blocks._sdpa_chunk at q_offset 0: a key length Skv other than the
// query's (whisper's cross attention: 448 decoder positions against 1500
// encoder frames; the causal mask is then top-left, key j visible to query i
// when j <= i), a sliding window (key j visible only if i - j < window) and
// ragged lengths (the edge tiles are masked; the reference's S % block
// assert is a TPU tiling limit, not part of the function).  A query row that
// sees no key at all (only where Sq > Skv under a window) is 0 / 0 = NaN, as
// softmax over no keys is in _sdpa.  Strides are arguments: the model passes
// its [b, s, h, d] tensors as transposed views, with no copy.
//
// Bound on the H100 SXM: bytes.  At the LM prefill shapes (bf16, causal, S
// 512, k/v [4, 8, 512, D]) a call reads q, k, v and writes o once: 21 / 42 /
// 50 MB for granite-3-2b (q [4,32,512,64]), phi3.5-moe (q [4,32,512,128]) and
// llama4-scout (q [4,40,512,128]), 6.3 / 12.5 / 15.0 us at 3.35 TB/s, against
// 4.3 / 8.6 / 10.8 GFLOP, 4.4 / 8.7 / 10.9 us at the 989 TFLOP/s bf16 peak.
// What set the time of the mma.sync kernel instead was latency: at D 128 one
// 222-register block fits an SM, so nothing covers a block's prologue (Q
// and the first K/V tiles in flight) and epilogue (the last barrier, the
// store), and within a tile the products, the softmax and the copies of a
// warp wait on one another (mma.sync issues in order).  The bf16 forward
// at D 64, 80, 128 and 192 with rows TMA can address (every served prefill
// and training forward) therefore runs flash_fwd_wgmma_kernel<D>: TMA loads
// by a producer warpgroup into a ring, wgmma products that run while the
// consumer warpgroups compute the softmax, a persistent grid (see its note,
// before FwdChoice).  The kernels below the next line keep the other calls.
//
// Each forward and backward kernel below also has a bf16-score variant
// (*_bf16_scores_kernel, the reference's attn_fp32_scores=False) compiled
// from the same body under a template flag: see the note before bfr().
//
// bf16 off the wgmma route (D 16 and 32, rows only 8-byte aligned, and the
// bf16-score mode): flash_fwd_mma_bf16_kernel<D>, D in {16, 32, 64, 80,
// 128, 192}, on the tensor cores through mma.sync.
// - Grid: one block per (batch*q-head, q tile of BQ = 16 * warps rows); each
//   warp owns 16 query rows; the grid covers Sq, the K/V loop Skv.  4 warps (BQ 64) at D <= 80; 8 warps (BQ 128) at
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
//   Skv.  The copy of tile t + 2 is issued before tile t's math, so one
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
// - Epilogue: divide by l, round once to bf16, stage each warp's
//   16 rows in shared memory and store 16 bytes at a time into the strided
//   output.
// - Occupancy (ptxas -v on sm_90a, PERF.md): shared memory 3 stages x (K + V)
//   x 64 x (D + 8) x 2 bytes = 18 / 30 / 54 / 66 / 102 / 150 KB a block at D
//   16 / 32 / 64 / 80 / 128 / 192, plus Q's 50 KB at D 192.  At D <= 64, 4
//   warps and at most 168 registers (110 / 128 / 158 used), so 3 blocks (12
//   warps) an SM; at D 80, 4 warps with up to 255 registers (192 used: its
//   accumulator and Q fragments pass 168), 2 blocks an SM; at D 128 and 192,
//   8 warps with up to 255 registers (222 and 254 used), 1 block (8 warps)
//   an SM.  No
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
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct AttnShape {
  int B, H, KVH, Sq, Skv;  // query and key lengths
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

// ---------------------------------------------------------------------------
// The bf16-score mode (the reference's attn_fp32_scores=False)
// ---------------------------------------------------------------------------
//
// Each step of the reference's bf16 softmax is rounded to bf16 (to nearest,
// ties to even) and held in fp32, as XLA evaluates a bf16 op in fp32 and
// rounds the result:
//   s = bf16(bf16(q.k^T) / c),  c = bf16(sqrt(D)) (flash_attention.py::score_divisor)
//   m = max s,  u = bf16(exp(bf16(s - m))),  l = bf16(sum u, in fp32),  y = bf16(u / l)
// and the backward, jax.grad's op by op:
//   g = bf16(dO.V^T),  R = sum_row bf16(bf16(g * bf16(1 / bf16(l * l))) * u), in bf16 (TreeSum)
//   dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c),  dQ = dS'.K,  dK = dS'^T.Q,  dV = y^T.dO
// Every step gives the bits of the IEEE fp32 op rounded to bf16 (no FMA
// contraction across a rounding), but the per-element divisions and exp
// take no IEEE division and no expf where they need not (div_bf16,
// exp_bf16): each is checked against bfr(__fdiv_rn) / bfr(expf) over every
// input it can take, on the card, by flash_bf16s_scalar_check (chip_smoke.py
// and tests/test_torch_gpu.py fail on one mismatch).  The online softmax
// cannot give bf16(exp(bf16(s - m))) at the row's final max, so the forward
// sweeps a q tile's keys three times (the raw scores' max, mapped once a
// row: the mapping is non-decreasing; the sum; y.V) and saves m and l; the
// backward's dQ kernels sweep twice (R, its windows of 32 summed in
// parallel, WindowSum; then dQ) and leave R for the dK/dV kernels.
//
// scripts/flash_bf16s_probe.py builds copies with -DFLASH_BF16S_PROBE=n to
// see what bounds the mode's kernels: 1,
// every per-element division is a multiplication by the reciprocal with no
// exact path; 2, exp is ex2.approx with no exact path; 3, the dQ kernels add
// no term of R; 4, the mma.sync forward runs its y.V sweep alone (no max
// and no sum sweep; m = 0, l = 1).  Each probe leaves the output wrong; 0,
// the shipped build, runs the kernels whole.
#ifndef FLASH_BF16S_PROBE
#define FLASH_BF16S_PROBE 0
#endif

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Below this a product x * r may have left fp32's normal range: the exact path runs.
constexpr float BF16S_TINY = 0x1p-125f;

// 1 / d in double precision with no subroutine call: rcp.approx and three
// Newton steps (for finite nonzero d).
__device__ __forceinline__ double rcp_f64(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-d, r, 1.0), r);
  return r;
}

// bfr(__fdiv_rn(x, d)) for bf16 x and d, inline: x / d to double precision
// (2^-51 of it), rounded once to fp32.  A quotient of two 8-bit
// significands lies at least 2^-33 of itself from an fp32 rounding boundary
// (or on one only where 1 / d is exact), so it rounds as the IEEE division.
// d = 0, +-inf or NaN: x times 1 / d, whose IEEE value is exact.  (__fdiv_rn
// calls a subroutine for such inputs, which costs spills where it sits
// beside each element's fast path.)
__device__ __forceinline__ float div_exact(float x, float d) {
  if (d == 0.f || !(fabsf(d) < INFINITY))
    return bfr(__fmul_rn(x, d == 0.f ? copysignf(INFINITY, d) : d != d ? d : copysignf(0.f, d)));
  return bfr(__double2float_rn((double)x * rcp_f64(d)));
}

// The reciprocal div_bf16 multiplies by: 1 / d rounded, or NaN where |d| is
// outside [2^-100, 2^100] (1 / d is then subnormal or its quotients may
// leave the range), which sends every division by d to the exact path.  One
// a call (d = c) or a row (d = l).
__device__ __forceinline__ float bf16_recip(float d) {
  const float a = fabsf(d);
  return a >= 0x1p-100f && a <= 0x1p100f ? __double2float_rn(rcp_f64(d)) : NAN;
}

// bf16(x / d) for bf16 x and d, the bits of bfr(__fdiv_rn(x, d)), from r =
// bf16_recip(d): bfr(x * r).  x * r is within 2^-22.9 of x / d, and a
// quotient of two 8-bit significands is either a bf16 value or at least
// 2^-17 of itself from a bf16 rounding boundary, so both round alike while
// x * r is normal; below 2^-125 (not 0) or NaN, div_exact.
__device__ __forceinline__ float div_bf16(float x, float r, float d) {
  const float q = __fmul_rn(x, r);
  if (FLASH_BF16S_PROBE != 1 && !(fabsf(q) >= BF16S_TINY) && q != 0.f) return div_exact(x, d);
  return bfr(q);
}

// Where exp_bf16 takes expf: the fp32 result within this many units in its
// last place of a bf16 rounding boundary (exp_fast lies at most 2 units
// from expf on the card, flash_bf16s_scalar_check's reading).
constexpr unsigned EXP_MARGIN = 4;

// bf16(exp(t)) for a bf16 t, the bits of bfr(expf(t)): ex2.approx of t *
// log2(e) = x + dx (dx, x's rounding error and log2(e)'s low part, carried
// by one FMA after the ex2), unless the result lies within EXP_MARGIN units
// of a bf16 rounding boundary, below 2^-125 or is NaN (t = -inf among
// them), where expf runs.
__device__ __forceinline__ float exp_fast(float t) {
  const float x = __fmul_rn(t, 1.44269502f);
  const float dx = fmaf(t, 1.925963e-8f, fmaf(t, 1.44269502f, -x));
  const float e0 = ex2(x);
  return fmaf(e0, __fmul_rn(dx, 0.693147181f), e0);
}
// Whether exp_fast's e for t must give way to expf: near a bf16 rounding boundary, below 2^-125 or NaN.
__device__ __forceinline__ bool exp_needs_expf(float e) {
  const unsigned near = (__float_as_uint(e) + EXP_MARGIN - 0x8000u) & 0xffffu;
  return FLASH_BF16S_PROBE != 2 && (near <= 2 * EXP_MARGIN || !(e >= BF16S_TINY));
}
__device__ __forceinline__ float exp_bf16(float t) {
  const float e = exp_fast(t);
  return bfr(exp_needs_expf(e) ? expf(t) : e);
}

// s = bf16(bf16(acc) / c) of a q.k^T accumulator; rc = bf16_recip(c).
__device__ __forceinline__ float bf16_score(float acc, float c, float rc) { return div_bf16(bfr(acc), rc, c); }

// u = bf16(exp(bf16(s - m))): 0 where s is masked (-inf), NaN for a row whose max is -inf (it sees no key).
__device__ __forceinline__ float bf16_exp(float s, float m) { return exp_bf16(bfr(__fsub_rn(s, m))); }

// The mode's per-element steps in two flavours with one interface.  A branch
// an element to the exact path keeps a thread's elements from overlapping
// (such branches took ~40% of the forward's time on the card:
// scripts/flash_bf16s_probe.py, PERF.md), so the kernels run an
// element block (with_bf16s_steps) first with FastSteps, straight-line:
// x * r and exp_fast, every element's need of the exact path OR-ed into
// `need`; and only in a thread where some element needs it, once more with
// ExactSteps (div_bf16, exp_bf16, which branch where they must).  A block
// writes only its outputs, so running it twice changes nothing else.
struct FastSteps {
  bool need = false;
  __device__ __forceinline__ float div(float x, float r, float) {
    const float q = __fmul_rn(x, r);
    need |= FLASH_BF16S_PROBE != 1 && !(fabsf(q) >= BF16S_TINY) & (q != 0.f);
    return bfr(q);
  }
  __device__ __forceinline__ float exp(float t) {  // -inf (a masked score) gives 0
    const float e = exp_fast(t);
    need |= exp_needs_expf(e) & (t != -INFINITY);
    return t == -INFINITY ? 0.f : bfr(e);
  }
  __device__ __forceinline__ float score(float acc, float c, float rc) { return div(bfr(acc), rc, c); }
  __device__ __forceinline__ float u(float s, float m) { return exp(bfr(__fsub_rn(s, m))); }
};
struct ExactSteps {
  __device__ __forceinline__ float div(float x, float r, float d) { return div_bf16(x, r, d); }
  __device__ __forceinline__ float exp(float t) { return exp_bf16(t); }
  __device__ __forceinline__ float score(float acc, float c, float rc) { return bf16_score(acc, c, rc); }
  __device__ __forceinline__ float u(float s, float m) { return bf16_exp(s, m); }
};

// Runs `block(steps)` branch-free and, where an element needs the exact path, exactly.
template <typename Block>
__device__ __forceinline__ void with_bf16s_steps(Block&& block) {
  FastSteps fast;
  block(fast);
  if (!fast.need) return;
  ExactSteps exact;
  block(exact);
}

// item(steps, i) for i < N, G items a with_bf16s_steps block (BF16S), or
// each with ExactSteps (the fp32-score mode, which calls none; or !FAST,
// where a kernel has no registers for the redo).  A block's inputs outlive
// its fast pass until its redo is decided, so blocks of a few items keep the
// registers of a whole fragment's inputs free.
template <bool BF16S, int N, int G, bool FAST = true, typename Item>
__device__ __forceinline__ void bf16s_blocks(Item&& item) {
#pragma unroll
  for (int g = 0; g < N; g += G) {
    auto block = [&](auto& steps) {
#pragma unroll
      for (int i = g; i < g + G; ++i) item(steps, i);
    };
    if constexpr (BF16S && FAST) {
      with_bf16s_steps(block);
    } else {
      ExactSteps exact;
      block(exact);
    }
  }
}

// The levels of XLA's CPU tree reduction over a row of Skv values
// (flash_attention.py::tree_levels): while more than 32 remain they are
// padded to a multiple of 32, lo[k] zeros in front, and each window of 32
// summed from its first element on; n[k] values enter level k.  The last
// <= 32 values are summed in order.
struct TreeLevels {
  int levels;
  int lo[3], n[3];
};

// The levels above the first windows: those a window sum enters (one chain
// for a row of at most 32 keys, where the row is one window).
__host__ __device__ inline TreeLevels up_levels(const TreeLevels& t) {
  return t.levels > 0 ? TreeLevels{t.levels - 1, {t.lo[1], t.lo[2], 0}, {t.n[1], t.n[2], 0}}
                      : TreeLevels{0, {0, 0, 0}, {0, 0, 0}};
}

// A running bf16 sum of one row's values, fed in order of their index j
// (tree_sum in flash_attention.py): acc[k] holds level k's open window.
// Leading values the caller skips must be zeros (every accumulator is 0
// then), and trailing ones too: flush() closes the open windows as the
// zeros would.
struct TreeSum {
  float acc[3], top;
  __device__ __forceinline__ void reset() { acc[0] = acc[1] = acc[2] = top = 0.f; }
  __device__ __forceinline__ void add(float x, int j, const TreeLevels& t) {
    if (t.levels == 0) {
      top = bfr(__fadd_rn(top, x));
      return;
    }
    acc[0] = bfr(__fadd_rn(acc[0], x));
    int idx = j;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= t.levels || ((idx + t.lo[k]) % 32 != 31 && idx != t.n[k] - 1)) return;  // window still open
      const float w = acc[k];
      acc[k] = 0.f;
      idx = (idx + t.lo[k]) / 32;
      if (k + 1 == t.levels) {
        top = bfr(__fadd_rn(top, w));
      } else {
        acc[k + 1] = bfr(__fadd_rn(acc[k + 1], w));
      }
    }
  }
  __device__ __forceinline__ float flush(const TreeLevels& t) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= t.levels) break;
      if (k + 1 == t.levels) {
        top = bfr(__fadd_rn(top, acc[k]));
      } else {
        acc[k + 1] = bfr(__fadd_rn(acc[k + 1], acc[k]));
      }
      acc[k] = 0.f;
    }
    return top;
  }
};

// R's bf16 sum in TreeSum's order with each window of 32 keys added by one
// thread: a row's terms are added by two neighbouring lanes, `half` 0 and 1,
// and of each 64-key tile each takes the 32 keys that fall in windows of one
// parity, in key order (one window, or the tail of one and the head of the
// window after next), so a window is one in-order chain of 32 and a row's
// two halves run at once.  The window sums enter the levels above in window
// order through half 0's TreeSum (`up`, over up_levels); at Skv 512 that is
// 16 chains of 32 a row and one of 16, where TreeSum alone is one of 512.
// Keys past Skv are not added; tiles the caller skips hold zeros, as TreeSum
// takes them.  Both lanes of a pair call every method (they shuffle).
struct WindowSum {
  TreeSum up;
  float open;  // this thread's window still open
  __device__ __forceinline__ void reset() {
    up.reset();
    open = 0.f;
  }
  // The tile of 64 keys from k0 (a multiple of 64) of a row of n keys;
  // term(x) is key k0 + x's term.
  template <typename Term>
  __device__ __forceinline__ void add_tile(Term term, int k0, int n, int half, const TreeLevels& t,
                                           const TreeLevels& up_t) {
    const int lo = t.levels > 0 ? t.lo[0] : 0;
    const int off = (k0 + lo) % 32;                  // the tile's first key's place in its window
    const bool first = (k0 + lo) / 32 % 2 == half;  // this thread takes the tile's first window
    float c0 = 0.f, c1 = 0.f;                        // the windows this thread closes, in order
    int w0 = 0, w1 = 0, nc = 0;
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + (first ? (i < 32 - off ? i : i + 32) : i + 32 - off);
      if (key >= n) break;
      open = bfr(__fadd_rn(open, term(key - k0)));
      if ((key + lo) % 32 == 31 || key == n - 1) {
        if (nc == 0) {
          c0 = open;
          w0 = (key + lo) / 32;
        } else {
          c1 = open;
          w1 = (key + lo) / 32;
        }
        ++nc;
        open = 0.f;
      }
    }
    // the first window's thread closes it and at most the one after next, the other thread the one between
    const float pc0 = __shfl_xor_sync(0xffffffffu, c0, 1), pc1 = __shfl_xor_sync(0xffffffffu, c1, 1);
    const int pw0 = __shfl_xor_sync(0xffffffffu, w0, 1), pw1 = __shfl_xor_sync(0xffffffffu, w1, 1);
    const int pnc = __shfl_xor_sync(0xffffffffu, nc, 1);
    if (half != 0) return;
    const float fc0 = first ? c0 : pc0, fc1 = first ? c1 : pc1, oc0 = first ? pc0 : c0;
    const int fw0 = first ? w0 : pw0, fw1 = first ? w1 : pw1, ow0 = first ? pw0 : w0;
    const int fn = first ? nc : pnc, on = first ? pnc : nc;
    if (fn > 0) up.add(fc0, fw0, up_t);
    if (on > 0) up.add(oc0, ow0, up_t);
    if (fn > 1) up.add(fc1, fw1, up_t);
  }
  // R, in half 0: the one window still open (in either thread) enters the levels above, which close.
  __device__ __forceinline__ float finish(const TreeLevels& up_t) {
    const float last = bfr(__fadd_rn(open, __shfl_xor_sync(0xffffffffu, open, 1)));  // one of the two is 0
    if (up_t.levels == 0) return bfr(__fadd_rn(up.top, last));
    up.acc[0] = bfr(__fadd_rn(up.acc[0], last));
    return up.flush(up_t);
  }
};

// The bf16 forward; BF16S: the bf16-score mode (three sweeps of the keys,
// m and l to `lse` [2][B * H * Sq] in place of the log-sum-exp).
template <int D, bool BF16S>
__device__ __forceinline__ void flash_fwd_mma_bf16_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                        const bf16* __restrict__ v, bf16* __restrict__ o,
                                                        float* __restrict__ lse, const AttnShape& p, int vec16) {
  constexpr int NSWEEP = BF16S ? (FLASH_BF16S_PROBE == 4 ? 1 : 3) : 1;
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

  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kt_end = (p.Skv + MBK - 1) / MBK;
  if (p.causal) kt_end = min(kt_end, q_last / MBK + 1);  // top-left: keys up to the block's last row
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / MBK : 0;

  // the block's key tiles, once for each sweep: step it is tile kt_begin + it % nk of sweep it / nk
  const int nk = max(kt_end - kt_begin, 0), steps = NSWEEP * nk;
  auto load_kv = [&](int it, int stage) {
    const int k0 = (kt_begin + (BF16S ? it % nk : it)) * MBK;
    bf16* ks = ring + stage * STAGE;
    load_rows<MBK, D, THREADS>(ks, kb + k0 * p.sks, p.sks, p.Skv - k0, vec16, tid);
    if (!BF16S || it >= (NSWEEP - 1) * nk)  // the bf16-score mode's max and sum sweeps read no V
      load_rows<MBK, D, THREADS>(ks + MBK * LD, vb + k0 * p.svs, p.svs, p.Skv - k0, vec16, tid);
  };

  load_rows<BQ, D, THREADS>(Qs, qb + q0 * p.sqs, p.sqs, p.Sq - q0, vec16, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load_kv(st, st);
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
  constexpr bool ALONE = BF16S && NSWEEP == 1;  // the probe's y.V sweep alone
  float m[2] = {ALONE ? 0.f : -INFINITY, ALONE ? 0.f : -INFINITY};  // running max, rows lane/4 and lane/4 + 8
  float l[2] = {ALONE ? 1.f : 0.f, ALONE ? 1.f : 0.f};               // this lane's share of the normaliser
  const float c = p.scale * 1.4426950408889634f;  // exp(x * scale) = exp2(x * c)
  // the bf16-score mode: 1 / c and the rows' 1 / l (div_bf16)
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  float rl[2] = {1.f, 1.f};

  for (int it = 0; it < steps; ++it) {
    const int stage = it % STAGES;
    const int sweep = BF16S ? it / nk + 3 - NSWEEP : 0, kt = kt_begin + (BF16S ? it % nk : it);
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; tile kt - 1 (and Q) is no longer read
    if (it + STAGES - 1 < steps) load_kv(it + STAGES - 1, (stage + STAGES - 1) % STAGES);
    cp_async_commit();
    if (BF16S && !ALONE && it == nk) {  // the max sweep is done: the row's max over its 4 lanes, mapped
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
        m[h] = bf16_score(m[h], p.scale, rc);
      }
    }
    if (BF16S && !ALONE && it == 2 * nk) {  // the sum sweep is done: l = bf16(the row's sum over its 4 lanes)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = bfr(l[h]);
        rl[h] = bf16_recip(l[h]);
      }
    }

    const bf16* ks = ring + stage * STAGE;
    const bf16* vs = ks + MBK * LD;
    const int k0 = kt * MBK;
    // this warp's rows r0 .. r0 + 15 against keys k0 .. k0 + 63: S = Q.K^T, online softmax, O += P.V
    if (r0 >= p.Sq || (p.causal && k0 > r0 + 15) || (p.window > 0 && r0 - (k0 + MBK - 1) >= p.window)) continue;
    // only the causal diagonal, the window's first keys and the ragged end need the mask
    const bool masked = k0 + MBK > p.Skv || (p.causal && k0 + MBK - 1 > r0) ||
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
          const bool ok = j < p.Skv && (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
          if (!ok) s[nt][e] = -INFINITY;
        }
    }

    if constexpr (BF16S) {
      if (sweep == 0) {
        // this lane's share of the row max of the raw scores, mapped once a row (bfr, the division by c > 0
        // and bfr are each non-decreasing, so max bf16_score = bf16_score(max))
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
          m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
        }
        continue;
      }
      if (sweep == 1) {  // this lane's share of the row sum, in fp32
        float u[NT][4];
        bf16s_blocks<true, NT, 2>([&](auto& steps, int nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) u[nt][e] = steps.u(steps.score(s[nt][e], p.scale, rc), m[e / 2]);
        });
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e / 2] = __fadd_rn(l[e / 2], u[nt][e]);
        continue;
      }
      uint32_t pf[PK][4];  // y = bf16(u / l) as the A fragments of y.V
      bf16s_blocks<true, NT, 2>([&](auto& steps, int nt) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = steps.div(steps.u(steps.score(s[nt][e], p.scale, rc), m[e / 2]), rl[e / 2], l[e / 2]);
        pf[nt / 2][(nt % 2) * 2] = pack_bf16(y[0], y[1]);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(y[2], y[3]);
      });
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs + (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
          mma_bf16(acc[dt], pf[kk], r[0], r[1]);
          mma_bf16(acc[dt + 1], pf[kk], r[2], r[3]);
        }
      continue;
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
  float inv[2];     // what the accumulator is multiplied by
  if constexpr (BF16S) {
    // y is normalised already; l is NaN for a row that sees no key, and 0 where the block has no key
    // tile at all: both NaN, as in _sdpa
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = l[h] > 0.f ? 1.f : NAN;
    if (lse != nullptr && lane % 4 == 0) {  // m and l, for the backward
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + lane / 4 + h * 8;
        if (i < p.Sq) {
          lse[(long long)blockIdx.x * p.Sq + i] = m[h];
          lse[((long long)gridDim.x + blockIdx.x) * p.Sq + i] = l[h];
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);  // 0 only for a row that sees no key: NaN, as in _sdpa
    }
    if (lse != nullptr && lane % 4 == 0) {  // log-sum-exp of the scaled scores, for the backward
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + lane / 4 + h * 8;
        if (i < p.Sq) lse[(long long)blockIdx.x * p.Sq + i] = m[h] * p.scale + logf(l[h]);
      }
    }
  }
  bf16* os = ring + warp * 16 * LD;  // this warp's 16 rows
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    bf16* cell = os + (lane / 4) * LD + dt * 8 + (lane % 4) * 2;
    if constexpr (BF16S) {
      *reinterpret_cast<__nv_bfloat162*>(cell) = __floats2bfloat162_rn(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(cell + 8 * LD) =
          __floats2bfloat162_rn(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(cell) = __floats2bfloat162_rn(acc[dt][0] / l[0], acc[dt][1] / l[0]);
      *reinterpret_cast<__nv_bfloat162*>(cell + 8 * LD) =
          __floats2bfloat162_rn(acc[dt][2] / l[1], acc[dt][3] / l[1]);
    }
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16 * CPR chunks of 16 bytes, CPR / 2 per lane
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int e = lane + it * 32;
    const int r = e / CPR, col = (e % CPR) * 8;
    if (r0 + r >= p.Sq) continue;
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
__global__ void __launch_bounds__(mma_warps<D>() * 32, mma_min_blocks<D>())
flash_fwd_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ o, float* __restrict__ lse, AttnShape p, int vec16) {
  flash_fwd_mma_bf16_body<D, false>(q, k, v, o, lse, p, vec16);
}

// The bf16-score mode: p.scale is the divisor bf16(sqrt(D)); lse gets m, then l.
template <int D>
__global__ void __launch_bounds__(mma_warps<D>() * 32, mma_min_blocks<D>())
flash_fwd_mma_bf16_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                 bf16* __restrict__ o, float* __restrict__ lse, AttnShape p, int vec16) {
  flash_fwd_mma_bf16_body<D, true>(q, k, v, o, lse, p, vec16);
}

template <int D, bool BF16S>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, const AttnShape& p, int vec16,
               cudaStream_t stream) {
  constexpr int WARPS = mma_warps<D>();
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = BF16S ? flash_fwd_mma_bf16_scores_kernel<D> : flash_fwd_mma_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + 16 * WARPS - 1) / (16 * WARPS)));
  kernel<<<grid, WARPS * 32, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, p, vec16);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA on the SIMT pipes, no TF32
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int PAD = 4;        // row padding that keeps float4 rows 16-byte aligned

// Unroll of the score loop over D: 8.  scripts/flash_f32_unroll.py builds a
// copy with -DFLASH_F32_SCORE_UNROLL=2 to compare registers, spills and times.
#ifndef FLASH_F32_SCORE_UNROLL
#define FLASH_F32_SCORE_UNROLL 8
#endif
constexpr int F32_SCORE_UNROLL = FLASH_F32_SCORE_UNROLL;

template <int D>
constexpr int smem_floats() {
  return 2 * D * (BQ + PAD) + BK * (D + PAD) + BK * (BQ + PAD);
}

// The fp32 forward; BF16S: the bf16-score mode (three sweeps of the keys,
// m and l to `lse` [2][B * H * Sq] in place of the log-sum-exp).
template <int D, bool BF16S>
__device__ __forceinline__ void flash_fwd_body(const float* __restrict__ q, const float* __restrict__ k,
                                               const float* __restrict__ v, float* __restrict__ o,
                                               float* __restrict__ lse, const AttnShape& p) {
  constexpr int NSWEEP = BF16S ? 3 : 1;
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
    if (q0 + i < p.Sq) val = __ldg(reinterpret_cast<const float4*>(qb + (long long)(q0 + i) * p.sqs + d));
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

  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kt_end = (p.Skv + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  // the block's key tiles, once for each sweep: step it is tile kt_begin + it % nk of sweep it / nk
  const int nk = max(kt_end - kt_begin, 0);
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;  // the bf16-score mode: 1 / c and the rows' 1 / l
  float rl[4];

  for (int it = 0; it < NSWEEP * nk; ++it) {
    const int sweep = BF16S ? it / nk : 0, kt = kt_begin + (BF16S ? it % nk : it);
    const int k0 = kt * BK;
    const bool need_v = !BF16S || sweep == 2;  // the bf16-score mode's max and sum sweeps read no V
    if (BF16S && it == 2 * nk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // the sum sweep is done: l = bf16(the row's sum)
        l[r] = bfr(l[r]);
        rl[r] = bf16_recip(l[r]);
      }
    }
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BK * V4; e += THREADS) {
      const int j = e / V4, d = (e % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < p.Skv) {
        kv = __ldg(reinterpret_cast<const float4*>(kb + (long long)(k0 + j) * p.sks + d));
        if (need_v) vv = __ldg(reinterpret_cast<const float4*>(vb + (long long)(k0 + j) * p.svs + d));
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
#pragma unroll (F32_SCORE_UNROLL)
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

    if constexpr (BF16S) {
      float w[4][4];  // the scores (sweep 0), u (1) or y (2)
      bf16s_blocks<true, 4, 1>([&](auto& steps, int r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = q0 + ty * 4 + r, kj = k0 + tx * 4 + c;
          bool ok = kj < p.Skv;
          if (p.causal) ok = ok && kj <= qi;
          if (p.window > 0) ok = ok && qi - kj < p.window;
          const float sc = ok ? steps.score(s[r][c], p.scale, rc) : -INFINITY;
          w[r][c] = sweep == 0 ? sc : sweep == 1 ? steps.u(sc, m[r]) : steps.div(steps.u(sc, m[r]), rl[r], l[r]);
        }
      });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float red = sweep == 0 ? -INFINITY : 0.f;  // this thread's share of the row's max (sweep 0) or sum (1)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = w[r][c];
          red = sweep == 0 ? fmaxf(red, w[r][c]) : __fadd_rn(red, w[r][c]);
        }
        if (sweep == 0) {
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) red = fmaxf(red, __shfl_xor_sync(0xffffffffu, red, off));
          m[r] = fmaxf(m[r], red);
        } else if (sweep == 1) {
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) red += __shfl_xor_sync(0xffffffffu, red, off);
          l[r] += red;
        }
      }
      if (sweep < 2) continue;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty * 4 + r;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kj = k0 + tx * 4 + c;
          bool ok = kj < p.Skv;
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
    if (qi >= p.Sq) continue;
    float* orow = ob + (long long)qi * p.sos;
    if constexpr (BF16S) {
      // y is normalised already; l is NaN for a row that sees no key, and 0 where the block has no key
      // tile at all: both NaN, as in _sdpa
      const float keep = l[r] > 0.f ? 1.f : NAN;
      if (lse != nullptr && tx == 0) {
        lse[(long long)blockIdx.x * p.Sq + qi] = m[r];
        lse[((long long)gridDim.x + blockIdx.x) * p.Sq + qi] = l[r];
      }
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e) orow[g * 16 * VW + tx * VW + e] = acc[r][g * VW + e] * keep;
      continue;
    }
    const float denom = l[r];  // 0 only for a row that sees no key: NaN, as in _sdpa
    if (lse != nullptr && tx == 0) lse[(long long)blockIdx.x * p.Sq + qi] = m[r] + logf(denom);  // scores scaled
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) orow[g * 16 * VW + tx * VW + e] = acc[r][g * VW + e] / denom;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, AttnShape p) {
  flash_fwd_body<D, false>(q, k, v, o, lse, p);
}

// The bf16-score mode: p.scale is the divisor bf16(sqrt(D)); lse gets m, then l.  One block an SM asked
// for, so ptxas may take the registers the mode's steps need (it stops at 128 otherwise, and spills).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_scores_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             float* __restrict__ o, float* __restrict__ lse, AttnShape p) {
  flash_fwd_body<D, true>(q, k, v, o, lse, p);
}

template <int D, bool BF16S>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, const AttnShape& p,
               cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kernel = BF16S ? flash_fwd_bf16_scores_kernel<D> : flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                          static_cast<const float*>(v), static_cast<float*>(o), lse, p);
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

// ===========================================================================
// Backward
// ===========================================================================
//
// The gradient of the forward above (blocks._sdpa_chunk's at q_offset 0, as
// jax.grad takes it through the reference's XLA attention; no Pallas kernel
// of the reference has a backward).  With P = exp(S * scale - lse) from the
// forward's log-sum-exp, the kernels below compute
//   delta = rowsum(dO o O)
//   dP = dO.V^T,  dS = P o (dP - delta)
//   dQ = scale * dS.K
//   dV = P~^T.dO,  dK = scale * dS^T.Q,  each summed over the GQA group
// with P~ the probabilities rounded to the input type, as the forward rounds
// them before P.V; P and dS are rounded to bf16 as the A operands of the
// second products.  No atomics: each output element is written by one
// thread, each sum taken in one order, so two calls give the same bits.
// Masks as the forward's; a query row that sees no key (only where Sq >=
// Skv + window) has no finite lse, and the wrapper refuses the shapes that
// make one.
//
// Routes (flash_attention.py::bwd_route, a function of type, head dim,
// strides and alignment that the CPU tests pin; the wrapper passes the
// route's code and launches nothing else):
// - BWD_WGMMA, bf16 at D 64, 80 and 128 where TMA can address every row of
//   q, k, v, o and dO (strides multiples of 8 elements, 16-byte-aligned
//   bases): the training path of granite-3-2b, phi3.5-moe and zamba2-2.7b's
//   shared block.  Two launches: flash_bwd_dq_wgmma_kernel<D> (which also
//   computes delta) and flash_bwd_dkdv_wgmma_kernel<D>, below.
// - BWD_MMA, every other bf16 call: D 16 and 32 (too narrow for a k16 step
//   in each row of a 128-byte swizzle box), D 192 (no training path), rows
//   only 8-byte aligned.  No path on the card runs it: the delta pre-pass,
//   the mma.sync dQ kernel and the mma.sync dK/dV kernel, one pass up to D
//   80 and a dV and a dK pass at D 128 and 192.
// - BWD_SIMT, fp32: the delta pre-pass, dQ and dK/dV on the SIMT pipes.
// - The bf16-score mode (bf16_scores, see its note above) takes the same
//   routes, with no delta pre-pass: the dQ kernels sweep the keys twice,
//   first for each row's R (written to the scratch), then for dQ, and the
//   dK/dV kernels read R beside the forward's (m, l) (on the wgmma route the
//   dQ kernel writes each q tile's m, l, R and 1 / l, as it writes the fp32
//   mode's lse and delta).
// The launch order is delta (where separate), dQ, dK/dV, on one stream.
//
// Bound on the H100 SXM: at the training shapes (bf16, causal, S 512,
// granite-3-2b q [4,32,512,64], k/v [4,8,512,64]; phi3.5-moe q
// [4,32,512,128], k/v [4,8,512,128]) the call moves 42.5 / 85 MB (q, k, v,
// o, dO and the three gradients once, lse and delta in fp32) against 10.8 /
// 21.5 GFLOP (five S x S x D products), so bytes bound it: 12.7 / 25.2 us.
//
// The wgmma route (NVIDIA H100 80GB HBM3, 700 W; scripts/flash_bwd_probe.py,
// device time by the profiler): granite 0.070 ms (dQ 0.029, dK/dV 0.041),
// phi 0.129 ms (0.052, 0.077), against cuDNN's 0.092 / 0.150 and the
// mma.sync route's 0.123 / 0.263 (delta 0.016 / 0.015; dQ 0.040 / 0.067;
// dK/dV 0.067 at D 64, dV 0.083 and dK 0.098 at D 128).  What bounds it now
// is latency, not the tensor cores or the loads: without its products
// dK/dV takes 0.061 of its 0.077 ms at phi, without its streamed loads
// 0.075, and without the cluster's sum (each output's cl partials read
// through distributed shared memory; with more of those reads in flight
// it was slower) 0.060.  What held the mma.sync route back: one dK/dV
// block walked a whole GQA group a tile after another (up to 32 dependent
// steps, 256 blocks of 4 warps), D 128 took two dK/dV passes (two mma.sync
// accumulators and the fragments passed 255 registers), every operand was
// re-read from shared memory by ldmatrix, and delta was a launch of its
// own.  The design:
// - One warpgroup a block (128 threads), 64 rows of its own and 64-row tiles
//   of the other side streaming through an mbarrier ring that the block's
//   first thread refills by TMA as each stage is released (2 stages at D
//   128, 3 at D 64, so two blocks fit an SM; ptxas: dK/dV 218 / 154
//   registers, dQ 154 / 122 at D 128 / 64, no spill).  A producer warpgroup
//   of its own would hold registers (setmaxnreg moves them in warpgroups)
//   that the one consumer warpgroup needs at D 128; the TMA loads take one
//   thread a few instructions a stage.
// - TMA maps over each tensor as it lies, 4-D (D, positions, heads, batch)
//   in 64 x 64 boxes with the 128-byte swizzle, zero-filled past Sq and
//   Skv; a tile of D columns is ceil(D / 64) boxes.
// - D 80 (zamba2-2.7b's shared block, q/k/v [4,32,512,80], a GQA group of
//   1).  On mma.sync it took 0.1343-0.1381 ms in three launches
//   (delta 0.019, dQ 0.051, dK/dV 0.068) against cuDNN's 0.1065 and a bound
//   of 0.0252 (bytes): every operand re-read through ldmatrix, delta a
//   launch of its own.  Its 160-byte rows do not fill whole 128-byte
//   swizzle boxes, so a tile is two boxes, the second holding columns 64 ..
//   79, zero-filled past them by TMA (no extra bytes read from device
//   memory; the shared memory of a D 128 tile, still two blocks an SM).
//   S and dP take five k16 steps, the fifth in the second box; the output
//   products run at N 80 (m64n80k16), reading the MN-major B's columns 64 ..
//   79 from the second box one LBO on; delta sums every place of both
//   boxes' rows (the zero columns add 0).  At a GQA group of 1 the dK/dV
//   block stores its dK and dV from registers.  It takes 0.099-0.102 ms in
//   two launches (dQ 0.045-0.047, dK/dV 0.051-0.053) against cuDNN's
//   0.105-0.106; without its products or its loads each kernel keeps 88-94%
//   of its time: latency bounds it, as at D 64 and 128.
// - All products on wgmma with fp32 accumulators.  S^T = K.Q^T and dP^T =
//   V.dO^T (dK/dV), S = Q.K^T and dP = dO.V^T (dQ): m64n64k16, both
//   operands from shared memory, K-major (D the reduction).  The
//   accumulator layout of a 64 x 64 product is the register A fragment of
//   the next: P^T and dS^T (dS), rounded to bf16 and packed, feed dV +=
//   P~^T.dO and dK += dS^T.Q (dQ += dS.K) as m64nDk16 with A from
//   registers and B read MN-major from the same shared tiles that were the
//   K-major B of the first products.  So no operand is transposed or
//   re-read through ldmatrix, and D 128 keeps dK and dV (64 + 64 fp32
//   registers a thread) in one pass.
// - dQ: one block per (batch * q-head, q tile), K and V streaming; its
//   prologue sums delta from the O and dO tiles, both brought by TMA (O into
//   the ring's last stage before that stage's first K/V tile: from O's rows
//   in global memory, loaded by every thread before its first product,
//   delta took 0.028 of dQ's 0.074 ms at phi; this way 0.005), and writes
//   each q tile's lse * log2(e) and delta, 64 each, rows past Sq +inf and
//   0, to a scratch the dK/dV kernel's ring reads with one bulk copy a
//   stage.
// - dK/dV: one block per (batch, kv-head, cluster rank, key tile), Q, dO
//   and the stats streaming.  The blocks of one (batch, kv-head, key tile)
//   form a thread-block cluster of c blocks, c the largest divisor of the
//   group G = H / KVH that is at most 8 (flash_attention.py::bwd_cluster;
//   no cluster at G 1), and rank r takes q-heads r G / c .. (r + 1) G / c -
//   1: granite's and phi's longest chain of dependent steps falls from 32
//   to 8 and their 256 blocks become 1,024.  Each block keeps its dK and dV
//   in fp32 registers; at the end it stages them in its own shared memory,
//   and after a cluster barrier rank r sums rows 64 r / c .. 64 (r + 1) / c
//   - 1 over the cluster's blocks in rank order, reading the others'
//   partials through distributed shared memory, and stores them as bf16:
//   one fixed order, nothing atomic, no fp32 partials in device memory
//   (per-q-head partials summed by another kernel would write and read
//   ~268 MB at phi's shape).  Every block of a cluster sees the same q
//   tiles (they depend on the key tile only), so a cluster whose keys no
//   query sees (past Sq under a causal mask or a window) sums and stores
//   zeros, and every block reaches both cluster barriers.
//
// The mma.sync kernels (mma.sync m16n8k16, fp32 accumulators, 4 warps):
// - flash_bwd_dq_mma_bf16_kernel<D>: one block per (batch * q-head, 64-row q
//   tile); each warp owns 16 query rows.  Q and dO stay in shared memory;
//   K and V stream in 64-key tiles through a 2-stage cp.async ring.  Per
//   tile, S = Q.K^T and dP = dO.V^T (K and V as ldmatrix B operands, as the
//   forward reads K), P and dS from the row's lse and delta in registers,
//   dS rounded to bf16 and packed into A fragments (the C layout of two
//   m16n8 tiles is the A layout of one k16 step), dQ += dS.K (K through
//   ldmatrix.trans, as the forward reads V).
// - flash_bwd_dkdv_mma_bf16_kernel<D, MODE>: one block per (batch, kv-head,
//   64-key tile); each warp owns 16 keys, so the products run transposed:
//   S^T = K.Q^T and dP^T = V.dO^T with K and V as the A operands.  The block
//   loops over the q-heads of its group and the 64-row q tiles that see its
//   keys, Q, dO, lse and delta through a 2-stage ring; P^T and dS^T are
//   packed as A fragments for dV += P~^T.dO and dK += dS^T.Q (Q and dO
//   through ldmatrix.trans).  Keys past Skv need no mask: their rows are
//   never stored.  Query rows past Sq read lse +inf, so their P is 0.
//   Registers: at D <= 80 one pass keeps dK and dV (MODE 3); at D 128 and
//   192 the two accumulators with S and dP would pass 255 registers, so the
//   host launches a dV pass (MODE 1) and a dK pass (MODE 2), which read Q
//   twice and recompute S once more; at D 192 the q tiles are 32 rows.
//
// fp32, on the SIMT pipes (no TF32, as the forward): 32 x 32 score tiles,
// 256 threads as 16 x 16, each a 2 x 2 patch and 2 rows x D/16 columns of
// its output, rows in shared memory padded to an odd length.

struct BwdShape {
  int B, H, KVH, Sq, Skv;
  long long st[8][3];  // element strides over batch, head, position of q, k, v, o, dO, dq, dk, dv (d is unit)
  int causal, window;
  float scale;       // 1 / sqrt(D); in the bf16-score mode the divisor bf16(sqrt(D))
  TreeLevels tree;   // the bf16-score mode: the order of R's bf16 sum over Skv keys
};
enum { SQ_, SK_, SV_, SO_, SDO_, SDQ_, SDK_, SDV_ };

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_BQ = 64;  // query rows of a dQ block
constexpr int BWD_BK = 64;  // key rows: a K/V tile of the dQ loop, a dK/dV block

// Query rows of a q tile of the dK/dV loop: 32 at D 192, where the dK
// pass's accumulator (96 registers a thread) leaves no room for 64-query S
// and dP tiles, 64 below.
template <int D>
__host__ __device__ constexpr int bwd_bq() {
  return D == 192 ? 32 : 64;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ const T* at(const T* base, const BwdShape& p, int which, int b, int h, long long i) {
  return base + b * p.st[which][0] + h * p.st[which][1] + i * p.st[which][2];
}

// delta[b, h, i] = sum_d dO[i, d] * O[i, d] in fp32; a warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, BwdShape p,
                       int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.y * 8 + warp;
  if (i >= p.Sq) return;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const T* orow = at(o, p, SO_, b, h, i);
  const T* grow = at(dout, p, SDO_, b, h, i);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(long long)blockIdx.x * p.Sq + i] = acc;
}

// ---------------------------------------------------------------------------
// bf16 dQ
// ---------------------------------------------------------------------------

constexpr int TLD = BWD_BK + 1;  // row pitch, in floats, of the bf16-score mode's staged R terms

template <int D, bool BF16S>
constexpr int bwd_dq_smem_bytes() {
  // Q, dO; 2 stages of K, V; the bf16-score mode's R terms of each warp's 16 x 64 block
  return (2 * BWD_BQ + 2 * 2 * BWD_BK) * (D + MPAD) * (int)sizeof(bf16) +
         (BF16S ? BWD_WARPS * 16 * TLD * (int)sizeof(float) : 0);
}

// dQ on mma.sync.  BF16S, the bf16-score mode: `lse` holds m, then l
// ([2][B * H * Sq]); the keys are swept twice, the first time for each
// row's R (each warp stages its 16 x 64 terms in shared memory and each
// row's two lanes add them, WindowSum), which goes to `rsum` for the dK/dV
// kernel; the second for dQ.
template <int D, bool BF16S>
__device__ __forceinline__ void flash_bwd_dq_mma_bf16_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                           const bf16* __restrict__ v,
                                                           const bf16* __restrict__ dout,
                                                           const float* __restrict__ lse,
                                                           const float* __restrict__ delta, float* __restrict__ rsum,
                                                           bf16* __restrict__ dq, const BwdShape& p, int vec16) {
  constexpr int NSWEEP = BF16S ? 2 : 1;
  // the mode's steps: at D 192 (no training path) the accumulator leaves no registers for the branch-free
  // pass and its redo, so each element takes ExactSteps
  constexpr bool FAST = D != 192;
  constexpr int LD = D + MPAD;
  constexpr int KS = D / 16;       // k16 steps of S and dP
  constexpr int NT = BWD_BK / 8;   // n8 tiles of a warp's 16 x 64 scores
  constexpr int PK = BWD_BK / 16;  // k16 steps of dS.K
  static_assert(NT % 4 == 0, "S and dP in two halves of whole k16 steps");
  constexpr int DT = D / 8;        // n8 tiles of a warp's 16 x D output
  constexpr int STAGE = 2 * BWD_BK * LD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Gs = Qs + BWD_BQ * LD;                   // dO, [BQ][LD]
  bf16* ring = Gs + BWD_BQ * LD;                 // [2][K: BK rows, V: BK rows][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* Ts = reinterpret_cast<float*>(ring + 2 * STAGE) + warp * 16 * TLD;  // this warp's R terms [16][TLD]
  const int b = blockIdx.x / p.H, hq = blockIdx.x % p.H, hk = hq / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BWD_BQ;  // heaviest causal tiles first
  const int r0 = q0 + warp * 16;

  const bf16* kb = at(k, p, SK_, b, hk, 0);
  const bf16* vb = at(v, p, SV_, b, hk, 0);
  const int q_last = min(q0 + BWD_BQ, p.Sq) - 1;
  int kt_end = (p.Skv + BWD_BK - 1) / BWD_BK;
  if (p.causal) kt_end = min(kt_end, q_last / BWD_BK + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BWD_BK : 0;
  // the block's key tiles, once for each sweep: step it is tile kt_begin + it % nk of sweep it / nk
  const int nk = max(kt_end - kt_begin, 0), steps = NSWEEP * nk;

  auto load_kv = [&](int it, int stage) {
    const int k0 = (kt_begin + (BF16S ? it % nk : it)) * BWD_BK;
    bf16* ks = ring + stage * STAGE;
    load_rows<BWD_BK, D, BWD_THREADS>(ks, kb + k0 * p.st[SK_][2], p.st[SK_][2], p.Skv - k0, vec16, tid);
    load_rows<BWD_BK, D, BWD_THREADS>(ks + BWD_BK * LD, vb + k0 * p.st[SV_][2], p.st[SV_][2], p.Skv - k0, vec16,
                                      tid);
  };
  load_rows<BWD_BQ, D, BWD_THREADS>(Qs, at(q, p, SQ_, b, hq, q0), p.st[SQ_][2], p.Sq - q0, vec16, tid);
  load_rows<BWD_BQ, D, BWD_THREADS>(Gs, at(dout, p, SDO_, b, hq, q0), p.st[SDO_][2], p.Sq - q0, vec16, tid);
  if (steps > 0) load_kv(0, 0);
  cp_async_commit();

  // rows lane/4 and lane/4 + 8; a row past Sq gets P = 0.  fp32 scores: lse in base 2, delta.  bf16
  // scores: m, l, bf16(1 / bf16(l * l)) and, after the first sweep, R.
  float l2[2], dl[2], ll[2], il2[2], rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + lane / 4 + h * 8;
    const long long row = (long long)blockIdx.x * p.Sq + i;
    if constexpr (BF16S) {
      l2[h] = i < p.Sq ? lse[row] : INFINITY;
      ll[h] = i < p.Sq ? lse[(long long)gridDim.x * p.Sq + row] : 1.f;
      il2[h] = div_exact(1.f, bfr(__fmul_rn(ll[h], ll[h])));
      rl[h] = bf16_recip(ll[h]);
      dl[h] = 0.f;
    } else {
      l2[h] = i < p.Sq ? lse[row] * LOG2E : INFINITY;
      dl[h] = i < p.Sq ? delta[row] : 0.f;
    }
  }
  WindowSum wsum;  // R: lanes 2 r and 2 r + 1, row r0 + r's (in lane 2 r)
  wsum.reset();
  const TreeLevels up_t = up_levels(p.tree);
  const float c = BF16S ? p.scale : p.scale * LOG2E;
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  const bf16* qrow = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // this lane's ldmatrix row
  const bf16* grow = Gs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  // step it: wait for tile kt_begin + it % nk (and Q, dO), start the next; false where this warp sees none
  // of its keys
  auto arrive = [&](int it) -> bool {
    const int k0 = (kt_begin + (BF16S ? it % nk : it)) * BWD_BK;
    cp_async_wait<0>();  // tile it (and Q, dO) has landed (this thread's copies)
    __syncthreads();     // ... everyone's; tile it - 1 is no longer read
    if (it + 1 < steps) load_kv(it + 1, (it + 1) % 2);
    cp_async_commit();
    return !(r0 >= p.Sq || (p.causal && k0 > r0 + 15) || (p.window > 0 && r0 - (k0 + BWD_BK - 1) >= p.window));
  };
  // S and dP of this warp's 16 rows against keys nt0 * 8 .. (nt0 + N) * 8 - 1 of step it's tile, S masked
  auto products = [&](int it, auto& sc, auto& dp, int nt0) {
    constexpr int N = sizeof(sc) / sizeof(sc[0]);
    const int k0 = (kt_begin + (BF16S ? it % nk : it)) * BWD_BK;
    const bf16* ks = ring + it % 2 * STAGE;
    const bf16* vs = ks + BWD_BK * LD;
    const bool masked = k0 + BWD_BK > p.Skv || (p.causal && k0 + BWD_BK - 1 > r0) ||
                        (p.window > 0 && r0 + 15 - k0 >= p.window);
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      ldmatrix_x4(qa, qrow + kk * 16);
      ldmatrix_x4(ga, grow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < N; nt += 2) {  // keys (nt0 + nt) * 8 .. + 15: two n8 tiles
        const int off = ((nt0 + nt) * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, ks + off);
        mma_bf16(sc[nt], qa, r[0], r[1]);
        mma_bf16(sc[nt + 1], qa, r[2], r[3]);
        ldmatrix_x4(r, vs + off);
        mma_bf16(dp[nt], ga, r[0], r[1]);
        mma_bf16(dp[nt + 1], ga, r[2], r[3]);
      }
    }
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < N; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + lane / 4 + (e / 2) * 8;
          const int j = k0 + (nt0 + nt) * 8 + (lane % 4) * 2 + e % 2;
          const bool ok = j < p.Skv && (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
          if (!ok) sc[nt][e] = -INFINITY;
        }
    }
  };

  if constexpr (BF16S) {  // the R sweep, before dQ's accumulator is live
    for (int it = 0; it < nk; ++it) {
      if (!arrive(it)) continue;
      float s[NT][4], dp[NT][4];
      products(it, s, dp, 0);
      const int k0 = (kt_begin + it) * BWD_BK;
      // R's terms bf16(bf16(g * bf16(l^-2)) * u), staged for the row's two lanes
      bf16s_blocks<true, NT, 2, FAST>([&](auto& steps, int nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = steps.u(steps.score(s[nt][e], c, rc), l2[e / 2]);
          Ts[(lane / 4 + (e / 2) * 8) * TLD + nt * 8 + (lane % 4) * 2 + e % 2] =
              bfr(__fmul_rn(bfr(__fmul_rn(bfr(dp[nt][e]), il2[e / 2])), u));
        }
      });
      __syncwarp();
      if (FLASH_BF16S_PROBE != 3) {
        const float* trow = Ts + (lane / 2) * TLD;
        wsum.add_tile([trow](int x) { return trow[x]; }, k0, p.Skv, lane % 2, p.tree, up_t);
      }
      __syncwarp();
    }
    // each row's R, to rsum and to its fragments' lanes
    const float r = wsum.finish(up_t);
    if (lane % 2 == 0 && r0 + lane / 2 < p.Sq) rsum[(long long)blockIdx.x * p.Sq + r0 + lane / 2] = r;
#pragma unroll
    for (int h = 0; h < 2; ++h) dl[h] = __shfl_sync(0xffffffffu, r, (lane / 4 + h * 8) * 2);
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  for (int it = BF16S ? nk : 0; it < steps; ++it) {
    if (!arrive(it)) continue;
    const bf16* ks = ring + it % 2 * STAGE;
    if constexpr (BF16S) {
      // dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c), a k16 step's A fragment at a time, each used as
      // soon as it is made; at D 192 S and dP in two halves of the tile's keys (registers)
      constexpr int HALVES = D == 192 ? 2 : 1, HN = NT / HALVES;
#pragma unroll
      for (int half = 0; half < HALVES; ++half) {
        float s[HN][4], dp[HN][4];
        products(it, s, dp, half * HN);
#pragma unroll
        for (int kk = 0; kk < HN / 2; ++kk) {
          uint32_t df[4];
          bf16s_blocks<true, 2, 2, FAST>([&](auto& steps, int h) {
            const int nt = 2 * kk + h;
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float u = steps.u(steps.score(s[nt][e], c, rc), l2[e / 2]);
              const float gl = steps.div(bfr(dp[nt][e]), rl[e / 2], ll[e / 2]);
              ds[e] = steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, dl[e / 2])), u)), rc, c);
            }
            df[h * 2] = pack_bf16(ds[0], ds[1]);
            df[h * 2 + 1] = pack_bf16(ds[2], ds[3]);
          });
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, ks + ((half * HN / 2 + kk) * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
            mma_bf16(acc[dt], df, r[0], r[1]);
            mma_bf16(acc[dt + 1], df, r[2], r[3]);
          }
        }
      }
      continue;
    }
    float s[NT][4], dp[NT][4];
    products(it, s, dp, 0);
    uint32_t df[PK][4];  // dS as the A fragments of dS.K
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = ex2(fmaf(s[nt][e], c, -l2[e / 2])) * (dp[nt][e] - dl[e / 2]);
      df[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
      df[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {  // columns dt*8 .. dt*8 + 15: two n8 tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, ks + (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
        mma_bf16(acc[dt], df[kk], r[0], r[1]);
        mma_bf16(acc[dt + 1], df[kk], r[2], r[3]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + lane / 4 + h * 8;
    if (i >= p.Sq) continue;
    bf16* row = dq + b * p.st[SDQ_][0] + hq * p.st[SDQ_][1] + i * p.st[SDQ_][2] + (lane % 4) * 2;
    const float out = BF16S ? 1.f : p.scale;  // dS' holds the bf16-score mode's scale already
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * h] * out, acc[dt][2 * h + 1] * out);
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dq, BwdShape p, int vec16) {
  flash_bwd_dq_mma_bf16_body<D, false>(q, k, v, dout, lse, delta, nullptr, dq, p, vec16);
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_mma_bf16_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                    const float* __restrict__ stats, float* __restrict__ rsum,
                                    bf16* __restrict__ dq, BwdShape p, int vec16) {
  flash_bwd_dq_mma_bf16_body<D, true>(q, k, v, dout, stats, nullptr, rsum, dq, p, vec16);
}

// ---------------------------------------------------------------------------
// bf16 dK, dV
// ---------------------------------------------------------------------------

// MODE: 1 dV only, 2 dK only, 3 both (bwd_modes: one launch at D <= 80, two above)
template <int D>
__host__ __device__ constexpr bool bwd_split() {
  return D >= 128;
}

// Per-row statistics a q tile of the dK/dV loop carries: lse (base 2) and
// delta; in the bf16-score mode m, l, R and 1 / l (bf16_recip).
template <bool BF16S>
__host__ __device__ constexpr int bwd_nstats() {
  return BF16S ? 4 : 2;
}

template <int D, bool BF16S>
constexpr int bwd_dkdv_smem_bytes() {
  // K, V; 2 stages of Q, dO; 2 stages of the rows' statistics
  return (2 * BWD_BK + 2 * 2 * bwd_bq<D>()) * (D + MPAD) * (int)sizeof(bf16) +
         2 * bwd_nstats<BF16S>() * bwd_bq<D>() * (int)sizeof(float);
}

// dK and dV on mma.sync.  BF16S, the bf16-score mode: `lse` holds m, then l
// ([2][B * H * Sq]), `delta` each row's R (the dQ kernel's); each q tile's
// 1 / l is taken as its stats are loaded.
template <int D, int MODE, bool BF16S>
__device__ __forceinline__ void flash_bwd_dkdv_mma_bf16_body(const bf16* __restrict__ q,
                                                             const bf16* __restrict__ k,
                                                             const bf16* __restrict__ v,
                                                             const bf16* __restrict__ dout,
                                                             const float* __restrict__ lse,
                                                             const float* __restrict__ delta, bf16* __restrict__ dk,
                                                             bf16* __restrict__ dv, const BwdShape& p, int vec16) {
  constexpr bool DV = MODE & 1, DK = MODE & 2;
  constexpr int NSTAT = bwd_nstats<BF16S>();
  constexpr int BQ = bwd_bq<D>();
  constexpr int LD = D + MPAD;
  constexpr int KS = D / 16;
  constexpr int NT = BQ / 8;   // n8 tiles of a warp's 16 keys x BQ queries
  constexpr int PK = BQ / 16;  // k16 steps over the queries
  constexpr int DT = D / 8;
  constexpr int STAGE = 2 * BQ * LD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* Vs = Ks + BWD_BK * LD;                   // [BK][LD]
  bf16* ring = Vs + BWD_BK * LD;                 // [2][Q: BQ rows, dO: BQ rows][LD]
  // [2][lse * log2(e): BQ, delta: BQ], or in the bf16-score mode [2][m: BQ, l: BQ, R: BQ, 1 / l: BQ]
  float* stats = reinterpret_cast<float*>(ring + 2 * STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.KVH, hk = blockIdx.x % p.KVH;
  const int G = p.H / p.KVH;
  const int k0 = blockIdx.y * BWD_BK;  // causal: the first key tiles see the most queries
  const int kw = k0 + warp * 16;       // this warp's first key

  load_rows<BWD_BK, D, BWD_THREADS>(Ks, at(k, p, SK_, b, hk, k0), p.st[SK_][2], p.Skv - k0, vec16, tid);
  if constexpr (DK)
    load_rows<BWD_BK, D, BWD_THREADS>(Vs, at(v, p, SV_, b, hk, k0), p.st[SV_][2], p.Skv - k0, vec16, tid);

  // the q tiles that see a key of this block: top-left causal, i >= j; window, i - j < window
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + BWD_BK - 1 + p.window) : p.Sq;
  const int qt_begin = q_lo / BQ;
  const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_begin : 0;
  const int total = G * nq;  // (q-head of the group, q tile) pairs, in order

  auto load_q = [&](int it, int stage) {
    const int hq = hk * G + it / nq, q0 = (qt_begin + it % nq) * BQ;
    bf16* qs = ring + stage * STAGE;
    load_rows<BQ, D, BWD_THREADS>(qs, at(q, p, SQ_, b, hq, q0), p.st[SQ_][2], p.Sq - q0, vec16, tid);
    load_rows<BQ, D, BWD_THREADS>(qs + BQ * LD, at(dout, p, SDO_, b, hq, q0), p.st[SDO_][2], p.Sq - q0, vec16,
                                  tid);
    float* st = stats + stage * NSTAT * BQ;
    for (int e = tid; e < BQ; e += BWD_THREADS) {
      const int i = q0 + e;
      const long long row = ((long long)b * p.H + hq) * p.Sq + i;
      if constexpr (BF16S) {
        st[e] = i < p.Sq ? lse[row] : INFINITY;  // a row past Sq: u = 0
        st[BQ + e] = i < p.Sq ? lse[(long long)p.B * p.H * p.Sq + row] : 1.f;
        st[2 * BQ + e] = i < p.Sq ? delta[row] : 0.f;
        st[3 * BQ + e] = bf16_recip(st[BQ + e]);
      } else {
        st[e] = i < p.Sq ? lse[row] * LOG2E : INFINITY;  // a row past Sq: P = 0
        st[BQ + e] = i < p.Sq ? delta[row] : 0.f;
      }
    }
  };
  if (total > 0) load_q(0, 0);
  cp_async_commit();

  const float c = BF16S ? p.scale : p.scale * LOG2E;
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  const bf16* krow = Ks + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // this lane's ldmatrix row
  const bf16* vrow = Vs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  float accv[DV ? DT : 1][4], acck[DK ? DT : 1][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DV) accv[dt][e] = 0.f;
      if constexpr (DK) acck[dt][e] = 0.f;
    }

  for (int it = 0; it < total; ++it) {
    const int stage = it % 2;
    cp_async_wait<0>();  // q tile it (and K, V) has landed (this thread's copies)
    __syncthreads();     // ... everyone's, and the stats; tile it - 1 is no longer read
    if (it + 1 < total) load_q(it + 1, stage ^ 1);
    cp_async_commit();

    const int q0 = (qt_begin + it % nq) * BQ;
    const bf16* qs = ring + stage * STAGE;
    const bf16* gs = qs + BQ * LD;
    const float* l2 = stats + stage * NSTAT * BQ;  // lse * log2(e), or m
    const float* dl = l2 + BQ;                      // delta, or l
    const float* rr = l2 + 2 * BQ;                  // R
    const float* rl = l2 + 3 * BQ;                  // 1 / l
    // this warp's keys kw .. kw + 15 against queries q0 .. q0 + BQ - 1
    if (kw >= p.Skv || (p.causal && q0 + BQ - 1 < kw) || (p.window > 0 && q0 - (kw + 15) >= p.window)) continue;
    const bool masked = (p.causal && q0 < kw + 15) || (p.window > 0 && q0 + BQ - 1 - kw >= p.window);

    float s[NT][4], dp[DK ? NT : 1][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        if constexpr (DK) dp[nt][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, krow + kk * 16);
      if constexpr (DK) ldmatrix_x4(va, vrow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {  // queries nt*8 .. nt*8 + 15: two n8 tiles
        const int off = (nt * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, qs + off);
        mma_bf16(s[nt], ka, r[0], r[1]);
        mma_bf16(s[nt + 1], ka, r[2], r[3]);
        if constexpr (DK) {
          ldmatrix_x4(r, gs + off);
          mma_bf16(dp[nt], va, r[0], r[1]);
          mma_bf16(dp[nt + 1], va, r[2], r[3]);
        }
      }
    }
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kw + lane / 4 + (e / 2) * 8;
          const int i = q0 + nt * 8 + (lane % 4) * 2 + e % 2;
          const bool ok = (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
          if (!ok) s[nt][e] = -INFINITY;
        }
    }
    uint32_t pf[DV ? PK : 1][4], df[DK ? PK : 1][4];  // P^T and dS^T as A fragments over the queries
    bf16s_blocks<BF16S, NT, 2>([&](auto& steps, int nt) {
      {
        const int i0 = nt * 8 + (lane % 4) * 2;  // this lane's two query columns
        float pv[4];  // P, or u in the bf16-score mode
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[e] = BF16S ? steps.u(steps.score(s[nt][e], c, rc), l2[i0 + e % 2])
                        : ex2(fmaf(s[nt][e], c, -l2[i0 + e % 2]));
        if constexpr (DV) {
          float y[4];  // y = bf16(u / l)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = BF16S ? steps.div(pv[e], rl[i0 + e % 2], dl[i0 + e % 2]) : pv[e];
          pf[nt / 2][(nt % 2) * 2] = pack_bf16(y[0], y[1]);
          pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(y[2], y[3]);
        }
        if constexpr (DK) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + e % 2;
            if constexpr (BF16S) {  // dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c)
              const float gl = steps.div(bfr(dp[nt][e]), rl[i], dl[i]);
              ds[e] = steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, rr[i])), pv[e])), rc, c);
            } else {
              ds[e] = pv[e] * (dp[nt][e] - dl[i]);
            }
          }
          df[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
          df[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      }
    });
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        const int off = (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8;
        uint32_t r[4];
        if constexpr (DV) {
          ldmatrix_x4_trans(r, gs + off);
          mma_bf16(accv[dt], pf[kk], r[0], r[1]);
          mma_bf16(accv[dt + 1], pf[kk], r[2], r[3]);
        }
        if constexpr (DK) {
          ldmatrix_x4_trans(r, qs + off);
          mma_bf16(acck[dt], df[kk], r[0], r[1]);
          mma_bf16(acck[dt + 1], df[kk], r[2], r[3]);
        }
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = kw + lane / 4 + h * 8;
    if (j >= p.Skv) continue;
    if constexpr (DV) {
      bf16* row = dv + b * p.st[SDV_][0] + hk * p.st[SDV_][1] + j * p.st[SDV_][2] + (lane % 4) * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
            __floats2bfloat162_rn(accv[dt][2 * h], accv[dt][2 * h + 1]);
    }
    if constexpr (DK) {
      bf16* row = dk + b * p.st[SDK_][0] + hk * p.st[SDK_][1] + j * p.st[SDK_][2] + (lane % 4) * 2;
      const float out = BF16S ? 1.f : p.scale;  // dS' holds the bf16-score mode's scale already
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
            __floats2bfloat162_rn(acck[dt][2 * h] * out, acck[dt][2 * h + 1] * out);
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                               const bf16* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                               BwdShape p, int vec16) {
  flash_bwd_dkdv_mma_bf16_body<D, MODE, false>(q, k, v, dout, lse, delta, dk, dv, p, vec16);
}

template <int D, int MODE>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_mma_bf16_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                      const float* __restrict__ stats, const float* __restrict__ rsum,
                                      bf16* __restrict__ dk, bf16* __restrict__ dv, BwdShape p, int vec16) {
  flash_bwd_dkdv_mma_bf16_body<D, MODE, true>(q, k, v, dout, stats, rsum, dk, dv, p, vec16);
}

// ---------------------------------------------------------------------------
// fp32 dQ and dK, dV on the SIMT pipes
// ---------------------------------------------------------------------------

constexpr int FB = 32;  // rows of a score tile, both ways

template <int D, bool BF16S>
constexpr int bwd_f32_smem_bytes() {
  return (4 * FB * (D + 1) + 2 * FB * (FB + 1) + bwd_nstats<BF16S>() * FB) * (int)sizeof(float);
}

// ROWS rows of D floats from global (row stride `stride`) into shared rows of
// D + 1; rows from `valid` on are zero.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride, int valid, int D,
                                              int tid) {
  for (int e = tid; e < FB * D; e += 256) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < valid ? src[r * stride + d] : 0.f;
  }
}

// dQ on the SIMT pipes.  BF16S, the bf16-score mode: `lse` holds m, then l
// ([2][B * H * Sq]); the keys are swept twice, the first time for each
// row's R (the terms staged in shared memory, each row's added in key order
// by one thread, TreeSum), which goes to `rsum` for the dK/dV kernel; the
// second for dQ.
template <int D, bool BF16S>
__device__ __forceinline__ void flash_bwd_dq_body(const float* __restrict__ q, const float* __restrict__ k,
                                                  const float* __restrict__ v, const float* __restrict__ dout,
                                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                                  float* __restrict__ rsum, float* __restrict__ dq,
                                                  const BwdShape& p) {
  constexpr int NSWEEP = BF16S ? 2 : 1;
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;              // [FB][LD]
  float* Gs = Qs + FB * LD;     // dO
  float* Ks = Gs + FB * LD;
  float* Vs = Ks + FB * LD;
  float* Ss = Vs + FB * LD;     // dS (the bf16-score mode: R's terms, then dS'), [FB][FB + 1]
  float* Rs = Ss + FB * (FB + 1);  // the bf16-score mode: the rows' R

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // rows 2ty, 2ty + 1; keys 2tx, 2tx + 1
  const int b = blockIdx.x / p.H, hq = blockIdx.x % p.H, hk = hq / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FB;
  load_rows_f32(Qs, at(q, p, SQ_, b, hq, q0), p.st[SQ_][2], p.Sq - q0, D, tid);
  load_rows_f32(Gs, at(dout, p, SDO_, b, hq, q0), p.st[SDO_][2], p.Sq - q0, D, tid);
  // fp32 scores: lse, delta; bf16 scores: m, l, bf16(1 / bf16(l * l)), 1 / l; a row past Sq gets P = 0
  float ls[2], dl[2], ll[2], il2[2], rl[2], acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + 2 * ty + r;
    const long long row = (long long)blockIdx.x * p.Sq + i;
    ls[r] = i < p.Sq ? lse[row] : INFINITY;
    if constexpr (BF16S) {
      ll[r] = i < p.Sq ? lse[(long long)gridDim.x * p.Sq + row] : 1.f;
      il2[r] = div_exact(1.f, bfr(__fmul_rn(ll[r], ll[r])));
      rl[r] = bf16_recip(ll[r]);
      dl[r] = 0.f;
    } else {
      dl[r] = i < p.Sq ? delta[row] : 0.f;
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  const int q_last = min(q0 + FB, p.Sq) - 1;
  int kt_end = (p.Skv + FB - 1) / FB;
  if (p.causal) kt_end = min(kt_end, q_last / FB + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / FB : 0;
  // the block's key tiles, once for each sweep: step it is tile kt_begin + it % nk of sweep it / nk
  const int nk = max(kt_end - kt_begin, 0);
  TreeSum tree;  // threads 0 .. FB - 1: row q0 + tid's R
  tree.reset();

  for (int it = 0; it < NSWEEP * nk; ++it) {
    const int sweep = BF16S ? it / nk : 0, kt = kt_begin + (BF16S ? it % nk : it);
    const int k0 = kt * FB;
    if (BF16S && it == nk && tid < FB) {  // the R sweep is done
      const float r = tree.flush(p.tree);
      Rs[tid] = r;
      if (q0 + tid < p.Sq) rsum[(long long)blockIdx.x * p.Sq + q0 + tid] = r;
    }
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_rows_f32(Ks, at(k, p, SK_, b, hk, k0), p.st[SK_][2], p.Skv - k0, D, tid);
    load_rows_f32(Vs, at(v, p, SV_, b, hk, k0), p.st[SV_][2], p.Skv - k0, D, tid);
    __syncthreads();
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float qv = Qs[(2 * ty + r) * LD + d], gv = Gs[(2 * ty + r) * LD + d];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          s[r][cc] = fmaf(qv, Ks[(2 * tx + cc) * LD + d], s[r][cc]);
          dp[r][cc] = fmaf(gv, Vs[(2 * tx + cc) * LD + d], dp[r][cc]);
        }
      }
    }
    auto block = [&](auto& steps) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = q0 + 2 * ty + r, j = k0 + 2 * tx + cc;
          const bool ok = j < p.Skv && (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
          float ds;
          if constexpr (BF16S) {
            const float u = ok ? steps.u(steps.score(s[r][cc], p.scale, rc), ls[r]) : 0.f;
            const float g = bfr(dp[r][cc]);
            if (sweep == 0) {  // R's term
              ds = bfr(__fmul_rn(bfr(__fmul_rn(g, il2[r])), u));
            } else {  // dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c)
              const float gl = steps.div(g, rl[r], ll[r]);
              ds = steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, Rs[2 * ty + r])), u)), rc, p.scale);
            }
          } else {
            const float pv = ok ? expf(s[r][cc] * p.scale - ls[r]) : 0.f;
            ds = pv * (dp[r][cc] - dl[r]);
          }
          Ss[(2 * ty + r) * (FB + 1) + 2 * tx + cc] = ds;
        }
    };
    if constexpr (BF16S) {
      with_bf16s_steps(block);
    } else {
      ExactSteps unused;
      block(unused);
    }
    __syncthreads();
    if (BF16S && sweep == 0) {  // each row's terms in key order
      if (tid < FB && FLASH_BF16S_PROBE != 3) {
        const int n = min(FB, p.Skv - k0);
        for (int j = 0; j < n; ++j) tree.add(Ss[tid * (FB + 1) + j], k0 + j, p.tree);
      }
      continue;
    }
#pragma unroll 2
    for (int j = 0; j < FB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ds = Ss[(2 * ty + r) * (FB + 1) + j];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[r][cc] = fmaf(ds, Ks[j * LD + tx + 16 * cc], acc[r][cc]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + 2 * ty + r;
    if (i >= p.Sq) continue;
    float* row = dq + b * p.st[SDQ_][0] + hq * p.st[SDQ_][1] + i * p.st[SDQ_][2];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) row[tx + 16 * cc] = BF16S ? acc[r][cc] : acc[r][cc] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, BwdShape p) {
  flash_bwd_dq_body<D, false>(q, k, v, dout, lse, delta, nullptr, dq, p);
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_bf16_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ stats, float* __restrict__ rsum, float* __restrict__ dq,
                                BwdShape p) {
  flash_bwd_dq_body<D, true>(q, k, v, dout, stats, nullptr, rsum, dq, p);
}

// dK and dV on the SIMT pipes.  BF16S, the bf16-score mode: `lse` holds m,
// then l ([2][B * H * Sq]), `delta` each row's R (the dQ kernel's).
template <int D, bool BF16S>
__device__ __forceinline__ void flash_bwd_dkdv_body(const float* __restrict__ q, const float* __restrict__ k,
                                                    const float* __restrict__ v, const float* __restrict__ dout,
                                                    const float* __restrict__ lse, const float* __restrict__ delta,
                                                    float* __restrict__ dk, float* __restrict__ dv,
                                                    const BwdShape& p) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;              // [FB][LD]
  float* Vs = Ks + FB * LD;
  float* Qs = Vs + FB * LD;
  float* Gs = Qs + FB * LD;     // dO
  float* Ps = Gs + FB * LD;     // P^T, [FB][FB + 1]
  float* Ss = Ps + FB * (FB + 1);  // dS^T
  float* Ls = Ss + FB * (FB + 1);  // lse of the q tile, or m
  float* Ds = Ls + FB;             // delta, or R
  float* Ll = Ds + FB;             // the bf16-score mode: l
  float* Rl = Ll + FB;             // the bf16-score mode: 1 / l

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // keys 2ty, 2ty + 1; queries 2tx, 2tx + 1
  const int b = blockIdx.x / p.KVH, hk = blockIdx.x % p.KVH;
  const int G = p.H / p.KVH;
  const int k0 = blockIdx.y * FB;
  load_rows_f32(Ks, at(k, p, SK_, b, hk, k0), p.st[SK_][2], p.Skv - k0, D, tid);
  load_rows_f32(Vs, at(v, p, SV_, b, hk, k0), p.st[SV_][2], p.Skv - k0, D, tid);
  float av[2][NC], ak[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) av[r][cc] = ak[r][cc] = 0.f;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + FB - 1 + p.window) : p.Sq;
  const int qt_begin = q_lo / FB;
  const int qt_end = q_hi > q_lo ? (q_hi + FB - 1) / FB : qt_begin;
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;

  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * FB;
      __syncthreads();  // the previous tile's Q, dO, P, dS are no longer read
      load_rows_f32(Qs, at(q, p, SQ_, b, hq, q0), p.st[SQ_][2], p.Sq - q0, D, tid);
      load_rows_f32(Gs, at(dout, p, SDO_, b, hq, q0), p.st[SDO_][2], p.Sq - q0, D, tid);
      if (tid < FB) {
        const int i = q0 + tid;
        const long long row = ((long long)b * p.H + hq) * p.Sq + i;
        Ls[tid] = i < p.Sq ? lse[row] : INFINITY;
        Ds[tid] = i < p.Sq ? delta[row] : 0.f;
        if constexpr (BF16S) {
          Ll[tid] = i < p.Sq ? lse[(long long)p.B * p.H * p.Sq + row] : 1.f;
          Rl[tid] = bf16_recip(Ll[tid]);
        }
      }
      __syncthreads();
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float kv = Ks[(2 * ty + r) * LD + d], vv = Vs[(2 * ty + r) * LD + d];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            s[r][cc] = fmaf(kv, Qs[(2 * tx + cc) * LD + d], s[r][cc]);
            dp[r][cc] = fmaf(vv, Gs[(2 * tx + cc) * LD + d], dp[r][cc]);
          }
        }
      }
      auto block = [&](auto& steps) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int j = k0 + 2 * ty + r, i = q0 + 2 * tx + cc, ic = 2 * tx + cc;
            const bool ok = (!p.causal || j <= i) && (p.window == 0 || i - j < p.window);
            if constexpr (BF16S) {  // y = bf16(u / l); dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c)
              const float u = ok ? steps.u(steps.score(s[r][cc], p.scale, rc), Ls[ic]) : 0.f;
              const float gl = steps.div(bfr(dp[r][cc]), Rl[ic], Ll[ic]);
              Ps[(2 * ty + r) * (FB + 1) + ic] = steps.div(u, Rl[ic], Ll[ic]);
              Ss[(2 * ty + r) * (FB + 1) + ic] =
                  steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, Ds[ic])), u)), rc, p.scale);
            } else {
              const float pv = ok ? expf(s[r][cc] * p.scale - Ls[ic]) : 0.f;
              Ps[(2 * ty + r) * (FB + 1) + ic] = pv;
              Ss[(2 * ty + r) * (FB + 1) + ic] = pv * (dp[r][cc] - Ds[ic]);
            }
          }
      };
      if constexpr (BF16S) {
        with_bf16s_steps(block);
      } else {
        ExactSteps unused;
        block(unused);
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < FB; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float pv = Ps[(2 * ty + r) * (FB + 1) + i], ds = Ss[(2 * ty + r) * (FB + 1) + i];
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            av[r][cc] = fmaf(pv, Gs[i * LD + tx + 16 * cc], av[r][cc]);
            ak[r][cc] = fmaf(ds, Qs[i * LD + tx + 16 * cc], ak[r][cc]);
          }
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + 2 * ty + r;
    if (j >= p.Skv) continue;
    float* vrow = dv + b * p.st[SDV_][0] + hk * p.st[SDV_][1] + j * p.st[SDV_][2];
    float* krow = dk + b * p.st[SDK_][0] + hk * p.st[SDK_][1] + j * p.st[SDK_][2];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      vrow[tx + 16 * cc] = av[r][cc];
      krow[tx + 16 * cc] = BF16S ? ak[r][cc] : ak[r][cc] * p.scale;  // dS' holds the bf16-score mode's scale
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, BwdShape p) {
  flash_bwd_dkdv_body<D, false>(q, k, v, dout, lse, delta, dk, dv, p);
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_bf16_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ stats, const float* __restrict__ rsum,
                                  float* __restrict__ dk, float* __restrict__ dv, BwdShape p) {
  flash_bwd_dkdv_body<D, true>(q, k, v, dout, stats, rsum, dk, dv, p);
}

template <typename KERNEL>
cudaError_t allow_smem(KERNEL kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
};

// The bf16-score mode's mma.sync backward: dQ (which leaves R in a.delta), then dK/dV.
template <int D>
int launch_bwd_mma_bf16_scores(const BwdArgs& a, const BwdShape& p, int vec16, cudaStream_t stream) {
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.dout);
  bf16 *dk = static_cast<bf16*>(a.dk), *dv = static_cast<bf16*>(a.dv);
  constexpr int dq_smem = bwd_dq_smem_bytes<D, true>(), kv_smem = bwd_dkdv_smem_bytes<D, true>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_bf16_scores_kernel<D>, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dq_grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + BWD_BQ - 1) / BWD_BQ));
  flash_bwd_dq_mma_bf16_scores_kernel<D><<<dq_grid, BWD_THREADS, dq_smem, stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dq), p, vec16);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)(p.B * p.KVH), (unsigned)((p.Skv + BWD_BK - 1) / BWD_BK));
  if constexpr (bwd_split<D>()) {
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_scores_kernel<D, 1>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_scores_kernel<D, 1><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse,
                                                                                           a.delta, dk, dv, p, vec16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_scores_kernel<D, 2>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_scores_kernel<D, 2><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse,
                                                                                           a.delta, dk, dv, p, vec16);
  } else {
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_scores_kernel<D, 3>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_scores_kernel<D, 3><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse,
                                                                                           a.delta, dk, dv, p, vec16);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_mma(const BwdArgs& a, const BwdShape& p, int vec16, cudaStream_t stream) {
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.dout);
  bf16 *dk = static_cast<bf16*>(a.dk), *dv = static_cast<bf16*>(a.dv);
  constexpr int dq_smem = bwd_dq_smem_bytes<D, false>(), kv_smem = bwd_dkdv_smem_bytes<D, false>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_bf16_kernel<D>, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dq_grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + BWD_BQ - 1) / BWD_BQ));
  flash_bwd_dq_mma_bf16_kernel<D><<<dq_grid, BWD_THREADS, dq_smem, stream>>>(q, k, v, g, a.lse, a.delta,
                                                                             static_cast<bf16*>(a.dq), p, vec16);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)(p.B * p.KVH), (unsigned)((p.Skv + BWD_BK - 1) / BWD_BK));
  if constexpr (bwd_split<D>()) {
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_kernel<D, 1>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_kernel<D, 1><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse, a.delta, dk,
                                                                                    dv, p, vec16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_kernel<D, 2>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_kernel<D, 2><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse, a.delta, dk,
                                                                                    dv, p, vec16);
  } else {
    if ((err = allow_smem(flash_bwd_dkdv_mma_bf16_kernel<D, 3>, kv_smem)) != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_bf16_kernel<D, 3><<<kv_grid, BWD_THREADS, kv_smem, stream>>>(q, k, v, g, a.lse, a.delta, dk,
                                                                                    dv, p, vec16);
  }
  return (int)cudaGetLastError();
}

// The bf16-score mode's SIMT backward: dQ (which leaves R in a.delta), then dK/dV.
template <int D>
int launch_bwd_f32_bf16_scores(const BwdArgs& a, const BwdShape& p, cudaStream_t stream) {
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *g = static_cast<const float*>(a.dout);
  constexpr int smem = bwd_f32_smem_bytes<D, true>();
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_scores_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dq_grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + FB - 1) / FB));
  flash_bwd_dq_bf16_scores_kernel<D><<<dq_grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta,
                                                                     static_cast<float*>(a.dq), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(flash_bwd_dkdv_bf16_scores_kernel<D>, smem)) != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)(p.B * p.KVH), (unsigned)((p.Skv + FB - 1) / FB));
  flash_bwd_dkdv_bf16_scores_kernel<D><<<kv_grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta,
                                                                       static_cast<float*>(a.dk),
                                                                       static_cast<float*>(a.dv), p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_f32(const BwdArgs& a, const BwdShape& p, cudaStream_t stream) {
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *g = static_cast<const float*>(a.dout);
  constexpr int smem = bwd_f32_smem_bytes<D, false>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dq_grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + FB - 1) / FB));
  flash_bwd_dq_kernel<D><<<dq_grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta, static_cast<float*>(a.dq), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(flash_bwd_dkdv_kernel<D>, smem)) != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)(p.B * p.KVH), (unsigned)((p.Skv + FB - 1) / FB));
  flash_bwd_dkdv_kernel<D><<<kv_grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta, static_cast<float*>(a.dk),
                                                           static_cast<float*>(a.dv), p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA (D 64, 80 and 128, rows TMA can address)
// ---------------------------------------------------------------------------

// scripts/flash_bwd_probe.py builds copies with -DFLASH_BWD_PROBE=n to see
// what bounds the two kernels: 1, the dQ kernel computes no delta (loads no
// tile of O); 2, neither runs its products; 3, neither loads its
// streamed tiles (the ring's barriers complete with no bytes; the products
// run on whatever shared memory holds); 4, the dK/dV kernel stores each
// block's own partials, with no cluster sum.  Each leaves the output wrong;
// 0, the shipped build, runs the kernels whole.  5 runs D 80's output
// products (dQ += dS.K, dV += P~^T.dO, dK += dS^T.Q) at N 128 over the
// tile's zero columns, 80 .. 127, in place of N 80 (the output stays right).
#ifndef FLASH_BWD_PROBE
#define FLASH_BWD_PROBE 0
#endif

constexpr int HB = 64;                   // rows of a tile: a block's queries (dQ) or keys (dK/dV), a streamed tile
constexpr int HBOX = 64 * 64 * 2;        // one 128-byte-swizzled TMA box: 64 rows of 64 bf16
constexpr int HTHREADS = 128;            // one warpgroup; its first thread issues the TMA loads

// Bytes of a q tile's stats, fp32: lse * log2(e) and delta; in the
// bf16-score mode m, l, R and 1 / l.
template <bool BF16S>
__host__ __device__ constexpr int hstats() {
  return (BF16S ? 4 : 2) * HB * 4;
}

// A 64-row tile of D columns: ceil(D / 64) boxes, one HBOX apart.  At D 80
// the second box holds columns 64 .. 79, and TMA fills its columns 80 .. 127
// with zeros (the maps' dim 0 has the extent D), reading nothing for them.
template <int D>
__host__ __device__ constexpr int htile() {
  return (D + 63) / 64 * HBOX;
}

// N of the output products (dQ += dS.K, dV += P~^T.dO, dK += dS^T.Q): D, so
// an accumulator holds D / 2 fp32 a thread; FLASH_BWD_PROBE 5 takes D 80's
// at N 128.
template <int D>
__host__ __device__ constexpr int hout() {
  return D == 80 && FLASH_BWD_PROBE == 5 ? 128 : D;
}

// Depth of the ring of streamed tiles (Q and dO for dK/dV, K and V for dQ):
// as deep as two blocks an SM leave room for.
template <int D>
__host__ __device__ constexpr int hstages() {
  return D == 64 ? 3 : 2;
}

// Shared memory a block asks: 1024 bytes of alignment slack, the resident
// tiles (dK/dV: K, V; dQ: Q, dO and the q tile's stats), the ring and its
// barriers.  dK/dV's stages carry their q tile's stats after Q and dO,
// padded to keep the next stage 1024-byte aligned.
template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * htile<D>() + 1024;
}
template <int D>
__host__ __device__ constexpr int dkdv_wgmma_smem() {
  return 1024 + 2 * htile<D>() + hstages<D>() * dkdv_stage_bytes<D>() + (1 + hstages<D>()) * 8;
}
template <int D>
__host__ __device__ constexpr int dq_wgmma_smem() {
  return 1024 + 2 * htile<D>() + 1024 + hstages<D>() * 2 * htile<D>() + (1 + hstages<D>()) * 8;
}
static_assert(2 * dkdv_wgmma_smem<128>() <= 232448 && 2 * dq_wgmma_smem<128>() <= 232448, "two blocks an SM");
static_assert(2 * dkdv_wgmma_smem<80>() <= 232448 && 2 * dq_wgmma_smem<80>() <= 232448, "two blocks an SM");
static_assert(2 * HB * (128 + 4) * 4 <= 2 * htile<128>() + hstages<128>() * dkdv_stage_bytes<128>(),
              "the cluster's sum is staged over the tiles and the ring");
static_assert(2 * HB * (80 + 4) * 4 <= 2 * htile<80>() + hstages<80>() * dkdv_stage_bytes<80>(),
              "the cluster's sum is staged over the tiles and the ring");

// wgmma descriptors of k16 step kk of a tile of 64 rows by D columns, as TMA
// writes it (ceil(D / 64) boxes of 64 rows of 128 bytes, 128-byte swizzle).
// K-major, D the reduction (S^T = K.Q^T, dP^T = V.dO^T; S = Q.K^T, dP =
// dO.V^T): the step's 32 bytes of a box's rows, eight rows a 1024-byte group.
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int kk) {
  return wgmma_desc_sw128(tile + (kk / 4) * HBOX + 32 * (kk % 4), 16, 1024);
}
// MN-major, the rows the reduction and D the output's columns (dV += P^T.dO,
// dK += dS^T.Q; dQ += dS.K): rows 16 kk .. 16 kk + 15 of every box, the boxes
// (64 columns each) one HBOX apart.  At N 80 the product reads columns 64 ..
// 79 from the first 32 bytes of each row of the second box.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int kk) {
  return wgmma_desc_sw128(tile + 16 * 128 * kk, HBOX, 1024);
}

// Rows s0 .. s0 + 63 of head h of batch b of a tensor mapped as (D,
// positions, heads, batch): ceil(D / 64) boxes of 64 columns.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int s0, int h,
                                          int b) {
#pragma unroll
  for (int j = 0; j < (D + 63) / 64; ++j) tma_load_4d(dst + j * HBOX, map, bar, 64 * j, s0, h, b);
}

// Packs accumulator n8 blocks 2 kk and 2 kk + 1 of a 64 x 64 fp32 tile,
// rounded to bf16, into the A fragment of k16 step kk of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], int j, float e0, float e1, float e2, float e3) {
  f[j / 2][(j % 2) * 2] = pack_bf16(e0, e1);
  f[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
}

// dQ = scale * dS.K, one block per (batch * q-head, 64-row q tile), heaviest
// causal tiles first.  Q and dO arrive once by TMA; K and V stream through
// an mbarrier ring that the block's first thread refills as each tile is
// released.  O's tile arrives by TMA beside Q and dO, into the ring's last
// stage, which takes its K/V tile once the block has summed delta =
// rowsum(dO o O) of its rows from the two tiles in shared memory; the block
// writes its rows' lse * log2(e) and delta to `stats` ([B * H][q tiles][2][64],
// rows past Sq lse +inf and delta 0) for the dK/dV kernel that runs next on
// the stream.  Per K/V tile: S = Q.K^T and dP = dO.V^T on wgmma from shared
// memory (both K-major), P and dS in registers, dS rounded to bf16 as the A
// fragments of dQ += dS.K (K read MN-major from the same tile).
//
// BF16S, the bf16-score mode: `lse` holds the forward's m, then l ([2][B *
// H * Sq]); no O tile.  The ring streams the block's K/V tiles twice: the
// first sweep stages each tile's R terms bf16(bf16(g * bf16(l^-2)) * u) as
// bf16 over its K tile (free once the products are read; 16-byte chunks
// XOR-swizzled by row, so neither the fragment-layout writes nor the row
// reads conflict) and each row's two threads add them (WindowSum); the
// second computes dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c) for dQ +=
// dS'.K.  `stats` gets each q tile's [4][64]: m, l, R and 1 / l (rows past
// Sq m +inf, l 1, R 0), which the dK/dV kernel's ring reads as it reads the
// fp32 mode's lse and delta.
template <int D, bool BF16S>
__device__ __forceinline__ void flash_bwd_dq_wgmma_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                                        const CUtensorMap& map_v, const CUtensorMap& map_do,
                                                        const CUtensorMap& map_o, const float* __restrict__ lse,
                                                        float* __restrict__ stats, bf16* __restrict__ dq,
                                                        const BwdShape& p) {
  constexpr int S = hstages<D>(), TILE = htile<D>(), NSTAT = hstats<BF16S>() / (HB * 4);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Gs = smem + TILE;  // dO
  float* st = reinterpret_cast<float*>(smem + 2 * TILE);  // the rows' stats, [NSTAT][64]
  unsigned char* ring = smem + 2 * TILE + 1024;           // [S][K tile, V tile]
  unsigned char* Os = ring + (S - 1) * 2 * TILE;          // O, in the last stage until delta is summed
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + S * 2 * TILE);  // [0]: Q, dO (and O); [1 + s]: stage s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H, hq = blockIdx.x % p.H, hk = hq / (p.H / p.KVH);
  const int nqt = gridDim.y, qt = nqt - 1 - blockIdx.y, q0 = qt * HB;
  const int q_last = min(q0 + HB, p.Sq) - 1;
  int kt_end = (p.Skv + HB - 1) / HB;
  if (p.causal) kt_end = min(kt_end, q_last / HB + 1);
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / HB : 0;
  // the block's key tiles, once for each sweep: step it is tile kt_begin + it % nk of sweep it / nk (one
  // sweep without the mode, which takes no division by nk)
  const int nk = max(kt_end - kt_begin, 0), steps = (BF16S ? 2 : 1) * nk;
  // stages the prologue fills: all but the last, which O holds until delta is summed
  const int first = min(steps, BF16S ? S : S - 1);

  auto load_kv = [&](int it) {
    uint64_t* full = &bar[1 + it % S];
    unsigned char* ks = ring + it % S * 2 * TILE;
    const int kt = kt_begin + (BF16S ? it % nk : it);
    mbar_arrive_expect_tx(full, FLASH_BWD_PROBE == 3 ? 0 : 2 * TILE);
    if constexpr (FLASH_BWD_PROBE != 3) {
      load_tile<D>(ks, &map_k, full, kt * HB, hk, b);
      load_tile<D>(ks + TILE, &map_v, full, kt * HB, hk, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[0], (BF16S || FLASH_BWD_PROBE == 1 ? 2 : 3) * TILE);
    load_tile<D>(Qs, &map_q, &bar[0], q0, hq, b);
    load_tile<D>(Gs, &map_do, &bar[0], q0, hq, b);
    if constexpr (!BF16S && FLASH_BWD_PROBE != 1) load_tile<D>(Os, &map_o, &bar[0], q0, hq, b);
    for (int it = 0; it < first; ++it) load_kv(it);
  }
  float* gst = stats + ((long long)blockIdx.x * nqt + qt) * NSTAT * HB;
  if constexpr (BF16S) {  // m, l and 1 / l of the tile's rows
    if (tid < HB) {
      const int i = q0 + tid;
      const long long row = (long long)blockIdx.x * p.Sq + i;
      const float l = i < p.Sq ? lse[(long long)gridDim.x * p.Sq + row] : 1.f;
      gst[tid] = st[tid] = i < p.Sq ? lse[row] : INFINITY;  // past Sq: u = 0
      gst[HB + tid] = st[HB + tid] = l;
      gst[3 * HB + tid] = st[3 * HB + tid] = bf16_recip(l);
    }
    mbar_wait(&bar[0], 0);
  } else {  // delta and lse * log2(e) of the tile's rows from the O and dO tiles, two threads a row
    mbar_wait(&bar[0], 0);
    const int row = tid / 2, i = q0 + row;
    float acc = 0.f;  // rows past Sq are zero-filled: 0
    if (FLASH_BWD_PROBE != 1) {
      // the two tiles are swizzled alike, so a 16-byte chunk at one place holds the same columns of both;
      // thread tid % 2 takes half of the row's places, starting at a place that differs from row to row.
      // Every place of the row's boxes is summed: at D 80 the zero-filled columns add 0
      constexpr int HALF = TILE / (HB * 16) / 2;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const int place = (tid % 2) * HALF + (c + row) % HALF;
        const int off = place / 8 * HBOX + row * 128 + place % 8 * 16;
        const uint4 ov = *reinterpret_cast<const uint4*>(Os + off), gv = *reinterpret_cast<const uint4*>(Gs + off);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      const float l2 = i < p.Sq ? lse[(long long)blockIdx.x * p.Sq + i] * LOG2E : INFINITY;  // past Sq: P = 0
      gst[row] = st[row] = l2;
      gst[HB + row] = st[HB + row] = acc;
    }
  }
  __syncthreads();  // the stats are in shared memory, and O is no longer read: the last stage takes its K/V tile
  if (tid == 0 && first < min(steps, S)) load_kv(first);
  const int r = warp * 16 + lane / 4, t = lane % 4;  // this thread's rows r, r + 8 of the tile; columns 2t, 2t + 1
  // fp32 scores: lse * log2(e) and delta; bf16 scores: m and l, 1 / l, bf16(1 / bf16(l * l)) and (after the
  // first sweep) R
  const float l2[2] = {st[r], st[r + 8]};
  float dl[2] = {st[HB + r], st[HB + r + 8]}, rl[2] = {1.f, 1.f}, il2[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};
  if constexpr (BF16S) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rl[h] = st[3 * HB + r + 8 * h];
      il2[h] = div_exact(1.f, bfr(__fmul_rn(dl[h], dl[h])));
    }
  }
  const float c = BF16S ? p.scale : p.scale * LOG2E;
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  WindowSum wsum;  // R: threads 2 r and 2 r + 1, row r's (in thread 2 r)
  wsum.reset();
  const TreeLevels up_t = up_levels(p.tree);

  float acc[hout<D>() / 2];
#pragma unroll
  for (int e = 0; e < hout<D>() / 2; ++e) acc[e] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int sweep = BF16S ? it / nk : 1, k0 = (kt_begin + (BF16S ? it % nk : it)) * HB;
    if (BF16S && it == nk) {  // the R sweep is done: each row's R, to the stats and to its fragments' threads
      const float rsum = wsum.finish(up_t);
      if (tid % 2 == 0) gst[2 * HB + tid / 2] = st[2 * HB + tid / 2] = rsum;  // past Sq: no terms, 0
      __syncthreads();
      rr[0] = st[2 * HB + r];
      rr[1] = st[2 * HB + r + 8];
    }
    mbar_wait(&bar[1 + it % S], (it / S) & 1);
    unsigned char* ks = ring + it % S * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    float s[32], dp[32];  // the first k16 step overwrites them; zeroed so that no register is read undefined
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_m64n64k16_bf16<0, 0>(s, kmajor_desc(Qs, kk), kmajor_desc(ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_m64n64k16_bf16<0, 0>(dp, kmajor_desc(Gs, kk), kmajor_desc(vs, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    wgmma_fence_operand(dp);

    const bool masked = k0 + HB > p.Skv || (p.causal && k0 + HB - 1 > q0) || (p.window > 0 && q0 + HB - 1 - k0 >= p.window);
    auto visible = [&](int j, int e) {
      const int i = q0 + r + (e / 2) * 8, jj = k0 + 8 * j + 2 * t + e % 2;
      return !masked || (jj < p.Skv && (!p.causal || jj <= i) && (p.window == 0 || i - jj < p.window));
    };
    if (BF16S && sweep == 0) {
      // R's terms over the K tile: row x's 16-byte chunk ch at (ch ^ x % 8); the products are done with it
      __syncthreads();
      bf16s_blocks<true, 8, 2>([&](auto& steps, int j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float term[2];
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const float u = visible(j, e) ? steps.u(steps.score(s[4 * j + e], c, rc), l2[h]) : 0.f;
            term[e % 2] = bfr(__fmul_rn(bfr(__fmul_rn(bfr(dp[4 * j + e]), il2[h])), u));
          }
          const int x = r + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(ks + x * 128 + ((j ^ x % 8) * 16) + 4 * t) =
              __floats2bfloat162_rn(term[0], term[1]);
        }
      });
      __syncthreads();
      if (FLASH_BF16S_PROBE != 3) {
        const int row = tid / 2;
        const unsigned char* trow = ks + row * 128;
        wsum.add_tile([trow, row](int x) {
          return __bfloat162float(*reinterpret_cast<const bf16*>(trow + ((x / 8) ^ row % 8) * 16 + x % 8 * 2));
        }, k0, p.Skv, tid % 2, p.tree, up_t);
      }
      fence_proxy_async_shared();  // the staged terms are read before TMA refills the stage
    } else {
      uint32_t df[4][4];  // dS (dS') as the A fragments of dS.K, k16 steps over the tile's keys
      bf16s_blocks<BF16S, 8, 2>([&](auto& steps, int j) {
        {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (BF16S) {  // dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c)
              const float u = visible(j, e) ? steps.u(steps.score(s[4 * j + e], c, rc), l2[e / 2]) : 0.f;
              const float gl = steps.div(bfr(dp[4 * j + e]), rl[e / 2], dl[e / 2]);
              ds[e] = steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, rr[e / 2])), u)), rc, c);
            } else {
              const float pv = visible(j, e) ? ex2(fmaf(s[4 * j + e], c, -l2[e / 2])) : 0.f;
              ds[e] = pv * (dp[4 * j + e] - dl[e / 2]);
            }
          }
          pack_a(df, j, ds[0], ds[1], ds[2], ds[3]);
        }
      });
      wgmma_fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 && FLASH_BWD_PROBE != 2; ++kk)
        wgmma_bf16_rs<hout<D>(), 1>(acc, df[kk], mnmajor_desc(ks, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
      wgmma_fence_operand(df);
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && it + S < steps) load_kv(it + S);
  }

  const float out = BF16S ? 1.f : p.scale;  // dS' holds the bf16-score mode's scale already
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + r + h * 8;
    if (i >= p.Sq) continue;
    bf16* row = dq + b * p.st[SDQ_][0] + hq * p.st[SDQ_][1] + i * p.st[SDQ_][2] + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * out, acc[4 * j + 2 * h + 1] * out);
  }
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, D == 64 ? 3 : 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_o, const float* __restrict__ lse,
                          float* __restrict__ stats, bf16* __restrict__ dq, BwdShape p) {
  flash_bwd_dq_wgmma_body<D, false>(map_q, map_k, map_v, map_do, map_o, lse, stats, dq, p);
}

// The bf16-score mode: `stats` holds the forward's m, then l; `scratch` gets each q tile's m, l, R and 1 / l.
// Two blocks an SM at D 64 too: the mode's steps need more than the 168 registers of three.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 2)
flash_bwd_dq_wgmma_bf16_scores_kernel(const __grid_constant__ CUtensorMap map_q,
                                      const __grid_constant__ CUtensorMap map_k,
                                      const __grid_constant__ CUtensorMap map_v,
                                      const __grid_constant__ CUtensorMap map_do, const float* __restrict__ stats,
                                      float* __restrict__ scratch, bf16* __restrict__ dq, BwdShape p) {
  flash_bwd_dq_wgmma_body<D, true>(map_q, map_k, map_v, map_do, map_q, stats, scratch, dq, p);
}

// dK = scale * dS^T.Q and dV = P~^T.dO.  One block per (batch, kv-head,
// cluster rank, 64-key tile): the `cl` blocks of one (batch, kv-head, key
// tile) form a cluster, and rank r takes q-heads r * G / cl .. (r + 1) *
// G / cl - 1 of the GQA group, each over the q tiles that see its keys.  K
// and V arrive once by TMA; each (q-head, q tile)'s Q, dO and stats stream
// through an mbarrier ring that the block's first thread refills as each
// stage is released.  Per stage: S^T = K.Q^T and dP^T = V.dO^T on wgmma
// from shared memory (both K-major); P^T and dS^T in registers; rounded to
// bf16 they are the A fragments of dV += P~^T.dO and dK += dS^T.Q, with dO
// and Q read MN-major from the same tiles.  Each block keeps its dK and dV
// in fp32 registers; at the end every block stages them in its own shared
// memory and, after a cluster barrier, block r sums rows r * 64 / cl ..
// (r + 1) * 64 / cl - 1 over the cluster's blocks in rank order through
// distributed shared memory and stores them as bf16.  A block that sees no
// q tile (every block of its cluster alike: the q range depends on the key
// tile only) sums and stores zeros.  BF16S, the bf16-score mode: the stats
// are the dQ kernel's m, l, R and 1 / l, from which u, y^T = bf16(u / l) and
// dS'^T take the place of P^T and dS^T (dS' holds the scale).
template <int D, bool BF16S>
__device__ __forceinline__ void flash_bwd_dkdv_wgmma_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                                          const CUtensorMap& map_v, const CUtensorMap& map_do,
                                                          const float* __restrict__ stats, bf16* __restrict__ dk,
                                                          bf16* __restrict__ dv, const BwdShape& p, int cl) {
  constexpr int S = hstages<D>(), TILE = htile<D>(), STAGE = dkdv_stage_bytes<D>(), HST = hstats<BF16S>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + TILE;
  unsigned char* ring = smem + 2 * TILE;  // [S][Q tile, dO tile, stats]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + S * STAGE);  // [0]: K and V; [1 + s]: stage s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.H / p.KVH, per = G / cl;  // q-heads of the group, of a block
  const int rank = blockIdx.x % cl, bk = blockIdx.x / cl, b = bk / p.KVH, hk = bk % p.KVH;
  const int k0 = blockIdx.y * HB;
  const int nqt = (p.Sq + HB - 1) / HB;
  // the q tiles that see a key of this block: top-left causal, i >= j; window, i - j < window
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + HB - 1 + p.window) : p.Sq;
  const int qt_begin = q_lo / HB;
  const int nq = q_hi > q_lo ? (q_hi + HB - 1) / HB - qt_begin : 0;
  const int total = per * nq;  // (q-head, q tile) pairs, in order

  auto load_q = [&](int it) {
    uint64_t* full = &bar[1 + it % S];
    unsigned char* qs = ring + it % S * STAGE;
    const int hq = hk * G + rank * per + it / nq, qt = qt_begin + it % nq;
    mbar_arrive_expect_tx(full, FLASH_BWD_PROBE == 3 ? 0 : 2 * TILE + HST);
    if constexpr (FLASH_BWD_PROBE != 3) {
      load_tile<D>(qs, &map_q, full, qt * HB, hq, b);
      load_tile<D>(qs + TILE, &map_do, full, qt * HB, hq, b);
      bulk_load(qs + 2 * TILE, stats + ((long long)(b * p.H + hq) * nqt + qt) * (HST / 4), HST, full);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && total > 0) {
    mbar_arrive_expect_tx(&bar[0], 2 * TILE);
    load_tile<D>(Ks, &map_k, &bar[0], k0, hk, b);
    load_tile<D>(Vs, &map_v, &bar[0], k0, hk, b);
    for (int it = 0; it < min(total, S); ++it) load_q(it);
  }

  const int r = warp * 16 + lane / 4, t = lane % 4;  // this thread's keys r, r + 8 of the tile; columns 2t, 2t + 1
  const float c = BF16S ? p.scale : p.scale * LOG2E;
  const float rc = BF16S ? bf16_recip(p.scale) : 0.f;
  float accv[hout<D>() / 2], acck[hout<D>() / 2];
#pragma unroll
  for (int e = 0; e < hout<D>() / 2; ++e) accv[e] = acck[e] = 0.f;
  if (total > 0) mbar_wait(&bar[0], 0);
  for (int it = 0; it < total; ++it) {
    mbar_wait(&bar[1 + it % S], (it / S) & 1);
    const unsigned char* qs = ring + it % S * STAGE;
    const unsigned char* gs = qs + TILE;
    // the q tile's lse * log2(e) and delta; or m, l, R and 1 / l
    const float* l2 = reinterpret_cast<const float*>(qs + 2 * TILE);
    const float* dl = l2 + HB;
    const int q0 = (qt_begin + it % nq) * HB;
    float s[32], dp[32];  // the first k16 step overwrites them; zeroed so that no register is read undefined
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_m64n64k16_bf16<0, 0>(s, kmajor_desc(Ks, kk), kmajor_desc(qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_m64n64k16_bf16<0, 0>(dp, kmajor_desc(Vs, kk), kmajor_desc(gs, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    wgmma_fence_operand(dp);

    // keys past Skv need no mask (their rows are never stored); queries past Sq have zero rows and lse +inf
    // (m +inf)
    const bool masked = (p.causal && q0 < k0 + HB - 1) || (p.window > 0 && q0 + HB - 1 - k0 >= p.window);
    uint32_t pf[4][4], df[4][4];  // P^T and dS^T as A fragments, k16 steps over the q tile's queries
    bf16s_blocks<BF16S, 8, 2>([&](auto& steps, int j) {
      {
        const float2 lj = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
        const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
        float2 rj{}, ij{};  // the bf16-score mode's R and 1 / l
        if constexpr (BF16S) {
          rj = *reinterpret_cast<const float2*>(l2 + 2 * HB + 8 * j + 2 * t);
          ij = *reinterpret_cast<const float2*>(l2 + 3 * HB + 8 * j + 2 * t);
        }
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = k0 + r + (e / 2) * 8, i = q0 + 8 * j + 2 * t + e % 2;
          const bool ok = !masked || ((!p.causal || jj <= i) && (p.window == 0 || i - jj < p.window));
          const float li = e % 2 ? lj.y : lj.x, di = e % 2 ? dj.y : dj.x;
          if constexpr (BF16S) {  // y = bf16(u / l); dS' = bf16(bf16(bf16(bf16(g / l) - R) * u) / c)
            const float ri = e % 2 ? rj.y : rj.x, rli = e % 2 ? ij.y : ij.x;
            const float u = ok ? steps.u(steps.score(s[4 * j + e], c, rc), li) : 0.f;
            const float gl = steps.div(bfr(dp[4 * j + e]), rli, di);
            pv[e] = steps.div(u, rli, di);
            ds[e] = steps.div(bfr(__fmul_rn(bfr(__fsub_rn(gl, ri)), u)), rc, c);
          } else {
            pv[e] = ok ? ex2(fmaf(s[4 * j + e], c, -li)) : 0.f;
            ds[e] = pv[e] * (dp[4 * j + e] - di);
          }
        }
        pack_a(pf, j, pv[0], pv[1], pv[2], pv[3]);
        pack_a(df, j, ds[0], ds[1], ds[2], ds[3]);
      }
    });
    wgmma_fence_operand(accv);
    wgmma_fence_operand(acck);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_bf16_rs<hout<D>(), 1>(accv, pf[kk], mnmajor_desc(gs, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4 && FLASH_BWD_PROBE != 2; ++kk)
      wgmma_bf16_rs<hout<D>(), 1>(acck, df[kk], mnmajor_desc(qs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(accv);
    wgmma_fence_operand(acck);
    wgmma_fence_operand(pf);
    wgmma_fence_operand(df);
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && it + S < total) load_q(it + S);
  }

  // D 80 at a group of one q-head a kv-head (zamba2-2.7b's shared block):
  // no cluster to sum over, so the block stores its dK and dV from registers
  // (the staging and the cluster barriers below took 15% of the kernel).  D
  // 64 and 128 keep their code: their main paths run groups of 4.
  if constexpr (D == 80) {
    if (cl == 1) {
      const float f = BF16S ? 1.f : p.scale;  // dS' holds the bf16-score mode's scale already
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = k0 + r + 8 * h;
        if (j >= p.Skv) continue;
        bf16* vrow = dv + b * p.st[SDV_][0] + hk * p.st[SDV_][1] + j * p.st[SDV_][2] + 2 * t;
        bf16* krow = dk + b * p.st[SDK_][0] + hk * p.st[SDK_][1] + j * p.st[SDK_][2] + 2 * t;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * c) =
              __floats2bfloat162_rn(accv[4 * c + 2 * h], accv[4 * c + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * c) =
              __floats2bfloat162_rn(acck[4 * c + 2 * h] * f, acck[4 * c + 2 * h + 1] * f);
        }
      }
      return;
    }
  }

  // The cluster's sum: every block stages its fp32 dV and dK over its tiles
  // and ring (every load issued has landed and been read), then block `rank`
  // sums its slice of rows over the cluster in rank order.
  constexpr int RP = D + 4;  // row pitch in floats: 16-byte rows for the float4 reads
  float* red = reinterpret_cast<float*>(smem);  // [dV, dK][64 keys][RP]
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* cell = red + (r + 8 * h) * RP + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(cell) = make_float2(accv[4 * j + 2 * h], accv[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(cell + HB * RP) = make_float2(acck[4 * j + 2 * h], acck[4 * j + 2 * h + 1]);
    }
  cluster_sync();  // every block's partials are in its shared memory
  const int r_lo = rank * HB / cl, n4 = ((rank + 1) * HB / cl - r_lo) * (D / 4);
  for (int e = tid; e < 2 * n4; e += HTHREADS) {
    const int dkey = e / n4, row = r_lo + e % n4 / (D / 4), col = e % n4 % (D / 4) * 4, j = k0 + row;
    const float* cell = red + (dkey * HB + row) * RP + col;
    float4 sum = ld_dsmem_f4(cell, FLASH_BWD_PROBE == 4 ? rank : 0);
    for (int src = 1; src < (FLASH_BWD_PROBE == 4 ? 1 : cl); ++src) {
      const float4 x = ld_dsmem_f4(cell, src);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (j >= p.Skv) continue;
    const float f = dkey && !BF16S ? p.scale : 1.f;  // dS' holds the bf16-score mode's scale already
    const int which = dkey ? SDK_ : SDV_;
    bf16* dst = (dkey ? dk : dv) + b * p.st[which][0] + hk * p.st[which][1] + j * p.st[which][2] + col;
    __nv_bfloat162 out[2] = {__floats2bfloat162_rn(sum.x * f, sum.y * f), __floats2bfloat162_rn(sum.z * f, sum.w * f)};
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(out);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 2)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv, BwdShape p,
                            int cl) {
  flash_bwd_dkdv_wgmma_body<D, false>(map_q, map_k, map_v, map_do, stats, dk, dv, p, cl);
}

// The bf16-score mode: `stats` holds the dQ kernel's m, l, R and 1 / l of each q tile.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 2)
flash_bwd_dkdv_wgmma_bf16_scores_kernel(const __grid_constant__ CUtensorMap map_q,
                                        const __grid_constant__ CUtensorMap map_k,
                                        const __grid_constant__ CUtensorMap map_v,
                                        const __grid_constant__ CUtensorMap map_do, const float* __restrict__ stats,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, BwdShape p, int cl) {
  flash_bwd_dkdv_wgmma_body<D, true>(map_q, map_k, map_v, map_do, stats, dk, dv, p, cl);
}

// A 4-D tensor map (D, positions, heads, batch) over a bf16 tensor with
// element strides `st` (batch, head, position; D unit), in 64 x 64 boxes,
// 128-byte swizzled, zero-filled past the last position (a store writes
// nothing there).  A dim of extent 1 is never stepped over: it gets a
// stride the encoder takes.
int encode_rows(CUtensorMap* map, const void* base, int D, int S, int H, int B, const long long* st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  const long long pos = st[2], head = H == 1 ? pos * S : st[1], batch = B == 1 ? pos * S * H : st[0];
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pos * 2, (cuuint64_t)head * 2, (cuuint64_t)batch * 2};
  const cuuint32_t box[4] = {64, HB, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// The wgmma route: the dQ kernel (with delta, or in the bf16-score mode R),
// then the dK/dV kernel in clusters of `cl` blocks.  `a.delta` is the stats
// scratch, fp32 [B * H][q tiles][2][64] (bf16-score mode: [4][64]).
template <int D, bool BF16S>
int launch_bwd_wgmma(const BwdArgs& a, const BwdShape& p, int cl, cudaStream_t stream) {
  int dev = 0;
  cudaError_t ce = make_context_current(&dev);
  if (ce != cudaSuccess) return (int)ce;
  CUtensorMap mq, mk, mv, mdo, mo;
  int err = encode_rows(&mq, a.q, D, p.Sq, p.H, p.B, p.st[SQ_]);
  if (err == 0) err = encode_rows(&mk, a.k, D, p.Skv, p.KVH, p.B, p.st[SK_]);
  if (err == 0) err = encode_rows(&mv, a.v, D, p.Skv, p.KVH, p.B, p.st[SV_]);
  if (err == 0) err = encode_rows(&mdo, a.dout, D, p.Sq, p.H, p.B, p.st[SDO_]);
  if (err == 0 && !BF16S) err = encode_rows(&mo, a.o, D, p.Sq, p.H, p.B, p.st[SO_]);
  if (err != 0) return err;
  constexpr int dq_smem = dq_wgmma_smem<D>(), kv_smem = dkdv_wgmma_smem<D>();
  const dim3 dq_grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + HB - 1) / HB));
  bf16* dq = static_cast<bf16*>(a.dq);
  if constexpr (BF16S) {
    if ((ce = allow_smem(flash_bwd_dq_wgmma_bf16_scores_kernel<D>, dq_smem)) != cudaSuccess) return (int)ce;
    flash_bwd_dq_wgmma_bf16_scores_kernel<D><<<dq_grid, HTHREADS, dq_smem, stream>>>(mq, mk, mv, mdo, a.lse,
                                                                                     a.delta, dq, p);
  } else {
    if ((ce = allow_smem(flash_bwd_dq_wgmma_kernel<D>, dq_smem)) != cudaSuccess) return (int)ce;
    flash_bwd_dq_wgmma_kernel<D><<<dq_grid, HTHREADS, dq_smem, stream>>>(mq, mk, mv, mdo, mo, a.lse, a.delta, dq, p);
  }
  if ((ce = cudaGetLastError()) != cudaSuccess) return (int)ce;
  auto kernel = BF16S ? flash_bwd_dkdv_wgmma_bf16_scores_kernel<D> : flash_bwd_dkdv_wgmma_kernel<D>;
  if ((ce = allow_smem(kernel, kv_smem)) != cudaSuccess) return (int)ce;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.B * p.KVH * cl), (unsigned)((p.Skv + HB - 1) / HB));
  cfg.blockDim = dim3(HTHREADS);
  cfg.dynamicSmemBytes = kv_smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cl;  // the blocks of one (batch, kv-head, key tile)
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, kernel, mq, mk, mv, mdo, static_cast<const float*>(a.delta),
                          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), p, cl);
  return ce != cudaSuccess ? (int)ce : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 forward on wgmma, fed by TMA (D 64, 80, 128 and 192, rows TMA can address)
// ---------------------------------------------------------------------------
//
// flash_fwd_wgmma_kernel<D>: what flash_fwd_mma_bf16_kernel computes, on
// Hopper's own path.  A work tile is (batch * q-head, 64 * WGS query rows),
// heaviest causal tiles first; the grid is persistent (as many blocks as
// the SMs hold), each block walking work tiles blockIdx.x, + gridDim.x, ....
// Warpgroup WGS produces, warpgroups 0 .. WGS - 1 consume, each owning 64
// query rows (warp specialisation: setmaxnreg moves the producer's
// registers to the consumers where the block's share of the SM's registers
// leaves them fewer than 240).
// - Loads: the producer's first thread issues every TMA load, over 4-D
//   tensor maps (D, positions, heads, batch) of the tensors as they lie
//   (the model's transposed [b, s, h, d] views), 128-byte swizzled: each
//   warpgroup's Q tile of the work tile (64 rows, ceil(D / 64) boxes; D
//   80's second box zero-filled past column 79, D 192 three boxes) into one
//   of two Q slots (the next work tile's Q lands while the last one's
//   output is stored from the other), then the work tile's K and V tiles of
//   64 keys into a ring of `stages` slots on full / empty mbarriers that
//   runs on across work tiles; each consumer warpgroup's first thread
//   releases a slot once its products have read it, and a Q slot once its
//   output has left it.  Rows past Sq and Skv arrive as zeros.
// - Products: S = Q.K^T on wgmma m64n64k16, Q and K K-major from their
//   tiles; D / 16 k16 steps, five at D 80, whose zero columns are never
//   read.  O += P.V on wgmma m64nDk16 (N 64, 80, 128 or 192) with P in
//   registers as the A operand and V read MN-major from its tile.
// - Online softmax on the S accumulator fragments (rows 16w + lane / 4 and
//   + 8 of warp w; each row's max over its 4 lanes in two shuffles), scale *
//   log2(e) folded into one FMA before ex2.approx, fp32 statistics; p
//   rounded to bf16 into P's fragments while the normaliser sums the
//   unrounded p; masks only on the tiles that need them.  Every consumer
//   warpgroup runs every key tile of the work tile (one its rows cannot
//   see masks to p = 0), so the ring stays in step.
// - Overlap within a warpgroup (the tiling's `overlap`): key tile j + 1's
//   S = Q.K^T is issued together with tile j's O += P.V, and tile j + 1's
//   softmax runs while P.V is in flight (O is rescaled and P packed once it
//   lands: one S, one P and one O in registers).  Without it each tile's
//   products wait for its softmax, and two blocks an SM (or two consumer
//   warpgroups) cover each other's softmax instead.
// - Epilogue: o = O / l, correctly rounded (a reciprocal a row, one
//   correction an element), rounded to bf16, staged in the warpgroup's Q
//   tile in the map's swizzled layout, and written by one TMA store a box
//   (no row past Sq, no column past D is written); lse = m * scale +
//   log(l) for the backward.  Deterministic: the keys of a row are summed
//   by one warpgroup in a fixed order.  A row's fp32 steps are
//   flash_fwd_mma_bf16_kernel's, in its order (64-key tiles, pairwise row
//   sums, the quotient), so where both run the two give the same bits.
// - Bound: at the served prefill shapes the bytes bound (q, k, v, o once)
//   and the operations bound are both 3-15 us; what sets the time is each
//   work tile's latency (its first loads, its epilogue) and, at 64 keys a
//   tile, the shared memory the products read.  The persistent grid hides
//   the first behind the last work tile's products, and two blocks an SM
//   (one consumer warpgroup each) hide it behind each other (PERF.md,
//   scripts/flash_tiles.py).
// Tilings: fwd_choice gives each head dim's shipped consumer warpgroups and
// overlap, measured by scripts/flash_tiles.py (PERF.md), which builds
// copies with -DFLASH_FWD_WGS= and -DFLASH_FWD_OVERLAP= (both) to time one
// choice at every head dim.  fwd_tiling then plans the blocks an SM (two
// where one consumer warpgroup leaves room for a ring of two slots each,
// else one) and the ring (as many slots as fit, at most four).
// flash_fwd_wgmma_config reports what each head dim was built with, and
// flash_attention.py::fwd_plan mirrors the plan.
struct FwdChoice {
  int wgs, overlap;
};

template <int D>
__host__ __device__ constexpr FwdChoice fwd_choice() {
#ifdef FLASH_FWD_WGS
  return FwdChoice{FLASH_FWD_WGS, FLASH_FWD_OVERLAP};
#else
  return D == 64 ? FwdChoice{1, 1} : D == 128 ? FwdChoice{1, 0} : FwdChoice{2, 0};
#endif
}

struct FwdTiling {
  int wgs;      // consumer warpgroups, 64 query rows each
  int overlap;  // 1: the softmax of a key tile runs while the products of its neighbours are in flight
  int bps;      // blocks an SM the registers and shared memory are planned for
  int stages;   // slots of the K/V ring
};

constexpr int FWD_MAX_STAGES = 4;

// Slots of 64-key K/V tiles beside two slots of `wgs` Q tiles when `bps`
// blocks share an SM's 233,472 bytes (1,024 of them reserved a block),
// after 1,024 bytes of alignment slack and the barriers; at most
// FWD_MAX_STAGES.
__host__ __device__ constexpr int fwd_fit(int boxes, int wgs, int bps) {
  const int room = 233472 / bps - 1024 - 1024 - 128 - 2 * wgs * boxes * HBOX;
  const int slots = room / (2 * boxes * HBOX);
  return slots < FWD_MAX_STAGES ? slots : FWD_MAX_STAGES;
}

template <int D>
__host__ __device__ constexpr FwdTiling fwd_tiling() {
  constexpr int boxes = (D + 63) / 64;
  constexpr FwdChoice C = fwd_choice<D>();
  const int bps = C.wgs == 1 && fwd_fit(boxes, 1, 2) >= 2 ? 2 : 1;
  return FwdTiling{C.wgs, C.overlap, bps, fwd_fit(boxes, C.wgs, bps)};
}

template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return 128 * (fwd_tiling<D>().wgs + 1);
}

template <int D>
__host__ __device__ constexpr int fwd_bps() {
  return fwd_tiling<D>().bps;
}

// Registers a thread at launch (what __launch_bounds__ leaves each of the
// block's threads), and a consumer's after setmaxnreg: the producer keeps
// 24, the consumers share the rest, at most 240.  0: no setmaxnreg (one
// consumer warpgroup alone on its SM has 255 already).
template <int D>
__host__ __device__ constexpr int fwd_consumer_regs() {
  constexpr FwdTiling T = fwd_tiling<D>();
  const int at_launch = 65536 / (fwd_threads<D>() * T.bps) / 8 * 8;
  if (at_launch >= 240) return 0;
  const int share = ((T.wgs + 1) * at_launch - 24) / T.wgs / 8 * 8;
  return share < 240 ? share : 240;
}

template <int D>
__host__ __device__ constexpr int fwd_wgmma_smem() {
  constexpr FwdTiling T = fwd_tiling<D>();
  constexpr int boxes = (D + 63) / 64;
  return 1024 + 2 * T.wgs * boxes * HBOX + T.stages * 2 * boxes * HBOX + 2 * (2 + T.stages) * 8;
}

static_assert(fwd_tiling<64>().stages >= 2 && fwd_tiling<80>().stages >= 2 && fwd_tiling<128>().stages >= 2 &&
                  fwd_tiling<192>().stages >= 2,
              "a K/V ring of two slots at least");
static_assert(fwd_tiling<64>().bps * (fwd_wgmma_smem<64>() + 1024) <= 233472 &&
                  fwd_tiling<80>().bps * (fwd_wgmma_smem<80>() + 1024) <= 233472 &&
                  fwd_tiling<128>().bps * (fwd_wgmma_smem<128>() + 1024) <= 233472 &&
                  fwd_tiling<192>().bps * (fwd_wgmma_smem<192>() + 1024) <= 233472,
              "the blocks an SM is planned for fit its shared memory");

template <int D>
__global__ void __launch_bounds__(fwd_threads<D>(), fwd_bps<D>())
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                       float* __restrict__ lse, AttnShape p, int nqt) {
  constexpr FwdTiling T = fwd_tiling<D>();
  constexpr int WGS = T.wgs, S = T.stages, REGS = fwd_consumer_regs<D>();
  constexpr int QT = (D + 63) / 64 * HBOX, STAGE = 2 * QT;  // a Q, K or V tile: ceil(D / 64) boxes of 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;                   // [2][WGS][Q tile]; at a tile's end each warpgroup's output
  unsigned char* ring = smem + 2 * WGS * QT;  // [S][K tile, V tile]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + S * STAGE);  // [2]: the slot's Q tiles have landed
  uint64_t* qempty = qfull + 2;               // [2]: every consumer warpgroup has stored its output from the slot
  uint64_t* full = qempty + 2;                // [S]: the slot's K and V tiles have landed
  uint64_t* empty = full + S;                 // [S]: every consumer warpgroup is done with the slot

  // the warpgroup index, broadcast so the compiler knows it is warp-uniform:
  // wgmma under a branch it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  // work tile u: batch * q-head u % BH, q tile nqt - 1 - u / BH (heaviest causal tiles first); this block
  // takes tiles blockIdx.x, + gridDim.x, ...
  const int BH = p.B * p.H, ntiles = BH * nqt;
  int b = 0, hq = 0, hk = 0, q0 = 0, kt_begin = 0, nk = 0;
  auto take = [&](int u) {
    const int bh = u % BH;
    b = bh / p.H;
    hq = bh % p.H;
    hk = hq / (p.H / p.KVH);
    q0 = (nqt - 1 - u / BH) * (64 * WGS);
    const int q_last = min(q0 + 64 * WGS, p.Sq) - 1;
    int kt_end = (p.Skv + 63) / 64;
    if (p.causal) kt_end = min(kt_end, q_last / 64 + 1);  // top-left: keys up to the tile's last row
    kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / 64 : 0;
    nk = max(kt_end - kt_begin, 0);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], WGS);
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);        // the producer's arrive, plus the slot's bytes
      mbar_init(&empty[i], WGS);     // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WGS) {
    if constexpr (REGS > 0) setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      int g = 0;  // K/V tiles through the ring, over the block's work tiles
      for (int u = blockIdx.x, n = 0; u < ntiles; u += gridDim.x, ++n) {
        take(u);
        const int qs = n % 2, live = min(WGS, (p.Sq - q0 + 63) / 64);  // Q tiles with a row before Sq
        mbar_wait(&qempty[qs], ((n / 2) & 1) ^ 1);  // the slot's previous tile is stored
        mbar_arrive_expect_tx(&qfull[qs], live * QT);
        for (int w = 0; w < live; ++w) load_tile<D>(Qs + (qs * WGS + w) * QT, &map_q, &qfull[qs], q0 + 64 * w, hq, b);
        for (int it = 0; it < nk; ++it, ++g) {
          const int st = g % S, k0 = (kt_begin + it) * 64;
          mbar_wait(&empty[st], ((g / S) & 1) ^ 1);  // the slot's previous round is consumed
          mbar_arrive_expect_tx(&full[st], STAGE);
          load_tile<D>(ring + st * STAGE, &map_k, &full[st], k0, hk, b);
          load_tile<D>(ring + st * STAGE + QT, &map_v, &full[st], k0, hk, b);
        }
      }
    }
    return;
  }
  if constexpr (REGS > 0) setmaxnreg_inc<REGS>();

  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int r = warp * 16 + lane / 4;  // this thread's rows r and r + 8 of the warpgroup's 64
  int w0 = 0;                          // the warpgroup's first row
  unsigned char* Qw = Qs;              // its Q tile (a warpgroup whose rows all lie past Sq: one never loaded)
  const float c = p.scale * 1.4426950408889634f;  // exp(x * scale) = exp2(x * c)

  float acc[D / 2], s[32];  // O; S, then p in place
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  uint32_t pf[4][4];  // P rounded to bf16: the A fragments of O += P.V, a k16 step of keys each
  float m[2], l[2], alpha[2];
  int g0 = 0;  // the ring position of the work tile's first K/V tile

  auto landed = [&](int it) { mbar_wait(&full[(g0 + it) % S], ((g0 + it) / S) & 1); };
  auto release = [&](int it) {
    if (tid == 0) mbar_arrive(&empty[(g0 + it) % S]);
  };
  auto scores = [&](int it) {  // S = Q.K^T of the work tile's it-th key tile (the first k16 step overwrites s)
    const unsigned char* ks = ring + (g0 + it) % S * STAGE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_bf16<0, 0>(s, kmajor_desc(Qw, kk), kmajor_desc(ks, kk), kk > 0);
  };
  auto weigh = [&](int it) {  // O += P.V of the work tile's it-th key tile
    const unsigned char* vs = ring + (g0 + it) % S * STAGE + QT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_bf16_rs<D, 1>(acc, pf[kk], mnmajor_desc(vs, kk), 1);
  };
  // the online softmax of the it-th key tile's scores: p in place of s, the rows' max, alpha and normaliser
  auto softmax = [&](int it) {
    const int k0 = (kt_begin + it) * 64;
    // only the causal diagonal, the window's first keys and the ragged end need the mask
    const bool masked = k0 + 64 > p.Skv || (p.causal && k0 + 63 > w0) || (p.window > 0 && w0 + 63 - k0 >= p.window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = w0 + r + (e / 2) * 8, jj = k0 + 8 * j + 2 * t + e % 2;
          if (!(jj < p.Skv && (!p.causal || jj <= i) && (p.window == 0 || i - jj < p.window))) s[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mc[h] = mx[h] == -INFINITY ? 0.f : mx[h] * c;  // a row with nothing visible yet
      alpha[h] = ex2(m[h] * c - mc[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mc[e / 2]));
      rs[0] += s[4 * j] + s[4 * j + 1];
      rs[1] += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  };
  auto rescale_and_pack = [&] {  // O *= alpha; p rounded to bf16 into P's fragments
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pf[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  for (int u = blockIdx.x, n = 0; u < ntiles; u += gridDim.x, ++n) {
    take(u);
    const int qs = n % 2;
    w0 = q0 + 64 * wg;
    Qw = Qs + (qs * WGS + wg) * QT;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
    mbar_wait(&qfull[qs], (n / 2) & 1);
    if constexpr (T.overlap != 0) {
      if (nk > 0) {
        landed(0);
        wgmma_fence();
        scores(0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(s);
        softmax(0);
        rescale_and_pack();
        for (int it = 1; it < nk; ++it) {
          landed(it);
          wgmma_fence();
          scores(it);
          wgmma_commit();
          weigh(it - 1);
          wgmma_commit();
          wgmma_wait<1>();  // S of tile it has landed; P.V of tile it - 1 stays in flight
          wgmma_fence_operand(s);
          softmax(it);
          wgmma_wait<0>();
          wgmma_fence_operand(acc);
          wgmma_fence_operand(pf);
          release(it - 1);
          rescale_and_pack();
        }
        wgmma_fence();
        weigh(nk - 1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(acc);
        release(nk - 1);
      }
    } else {
      for (int it = 0; it < nk; ++it) {
        landed(it);
        wgmma_fence();
        scores(it);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(s);
        softmax(it);
        rescale_and_pack();
        wgmma_fence();
        weigh(it);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand(acc);
        wgmma_fence_operand(pf);
        release(it);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);  // 0 only for a row that sees no key: NaN, as in _sdpa
    }
    if (lse != nullptr && t == 0) {  // log-sum-exp of the scaled scores, for the backward
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = w0 + r + h * 8;
        if (i < p.Sq) lse[((long long)b * p.H + hq) * p.Sq + i] = m[h] * p.scale + logf(l[h]);
      }
    }
    // o = O / l, correctly rounded (the IEEE quotient; a row that sees no key: 0 / 0 = NaN) from the row's
    // correctly rounded reciprocal y and one Markstein correction, q + (O - l q) y: three instructions an
    // element where the division takes ten (its fast path is the same correction, guarded for operands
    // O and l never take here), in the warpgroup's Q tile (its products are done with it): 16-byte chunk c
    // of row x at c ^ (x % 8), the map's swizzle, which also puts the eight rows a store instruction writes
    // in eight bank groups
    const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    auto quotient = [&](float a, int h) {
      const float q = a * y[h];
      return fmaf(fmaf(-l[h], q, a), y[h], q);
    };
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(Qw + (j / 8) * HBOX + row * 128 + (((j % 8) ^ (row % 8)) * 16) + 4 * t) =
            __floats2bfloat162_rn(quotient(acc[4 * j + 2 * h], h), quotient(acc[4 * j + 2 * h + 1], h));
      }
    fence_proxy_async_shared();
    named_barrier_sync(1 + wg, 128);
    if (tid == 0) {
      if (w0 < p.Sq) {
#pragma unroll
        for (int j = 0; j < (D + 63) / 64; ++j) tma_store_4d(&map_o, Qw + j * HBOX, 64 * j, w0, hq, b);
        tma_store_commit();
        tma_store_wait_read<0>();  // the slot is read before the producer refills it or the block leaves
      }
      mbar_arrive(&qempty[qs]);
    }
    g0 += nk;
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, const AttnShape& p,
                     cudaStream_t stream) {
  constexpr FwdTiling T = fwd_tiling<D>();
  int dev = 0;
  cudaError_t ce = make_context_current(&dev);
  if (ce != cudaSuccess) return (int)ce;
  const long long sq[3] = {p.sqb, p.sqh, p.sqs}, sk[3] = {p.skb, p.skh, p.sks}, sv[3] = {p.svb, p.svh, p.svs},
                  so[3] = {p.sob, p.soh, p.sos};
  CUtensorMap mq, mk, mv, mo;
  int err = encode_rows(&mq, q, D, p.Sq, p.H, p.B, sq);
  if (err == 0) err = encode_rows(&mk, k, D, p.Skv, p.KVH, p.B, sk);
  if (err == 0) err = encode_rows(&mv, v, D, p.Skv, p.KVH, p.B, sv);
  if (err == 0) err = encode_rows(&mo, o, D, p.Sq, p.H, p.B, so);
  if (err != 0) return err;
  constexpr int smem = fwd_wgmma_smem<D>();
  if ((ce = allow_smem(flash_fwd_wgmma_kernel<D>, smem)) != cudaSuccess) return (int)ce;
  // work tiles: batch * q-head x q tiles of 64 * WGS rows, on a grid of at most the card's SMs x bps blocks
  const int nqt = (p.Sq + 64 * T.wgs - 1) / (64 * T.wgs);
  int sms = 0;
  if ((ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)ce;
  long long blocks = (long long)p.B * p.H * nqt;
  if (blocks > (long long)sms * T.bps) blocks = (long long)sms * T.bps;
  flash_fwd_wgmma_kernel<D><<<(unsigned)blocks, fwd_threads<D>(), smem, stream>>>(mq, mk, mv, mo, lse, p, nqt);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_wgmma_config(int* out) {
  constexpr FwdTiling T = fwd_tiling<D>();
  constexpr int smem = fwd_wgmma_smem<D>();
  int blocks = 0;
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_wgmma_kernel<D>, fwd_threads<D>(), smem);
  const int got[6] = {T.wgs, T.overlap, T.stages, T.bps, smem, blocks};
  for (int i = 0; i < 6; ++i) out[i] = got[i];
  return (int)err;
}

// Route codes of flash_attention_fwd (flash_attention.py::FWD_ROUTES; its
// fwd_route picks one by type, score mode, head dim, strides and alignment).
enum FwdRoute { FWD_SIMT = 0, FWD_MMA = 1, FWD_WGMMA = 2 };

template <bool BF16S>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int route, int D,
               const AttnShape& p, cudaStream_t st) {
  if (route == FWD_SIMT) {
    switch (D) {
      case 16: return launch_f32<16, BF16S>(q, k, v, o, lse, p, st);
      case 32: return launch_f32<32, BF16S>(q, k, v, o, lse, p, st);
      case 64: return launch_f32<64, BF16S>(q, k, v, o, lse, p, st);
      case 80: return launch_f32<80, BF16S>(q, k, v, o, lse, p, st);
      case 128: return launch_f32<128, BF16S>(q, k, v, o, lse, p, st);
      case 192: return launch_f32<192, BF16S>(q, k, v, o, lse, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route == FWD_MMA) {
    const int vec16 = rows_16b(q, k, v, o, p);
    switch (D) {
      case 16: return launch_mma<16, BF16S>(q, k, v, o, lse, p, vec16, st);
      case 32: return launch_mma<32, BF16S>(q, k, v, o, lse, p, vec16, st);
      case 64: return launch_mma<64, BF16S>(q, k, v, o, lse, p, vec16, st);
      case 80: return launch_mma<80, BF16S>(q, k, v, o, lse, p, vec16, st);
      case 128: return launch_mma<128, BF16S>(q, k, v, o, lse, p, vec16, st);
      case 192: return launch_mma<192, BF16S>(q, k, v, o, lse, p, vec16, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route == FWD_WGMMA && !BF16S) {
    switch (D) {
      case 64: return launch_fwd_wgmma<64>(q, k, v, o, lse, p, st);
      case 80: return launch_fwd_wgmma<80>(q, k, v, o, lse, p, st);
      case 128: return launch_fwd_wgmma<128>(q, k, v, o, lse, p, st);
      case 192: return launch_fwd_wgmma<192>(q, k, v, o, lse, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The exhaustive checks of the bf16-score mode's scalar steps
// ---------------------------------------------------------------------------

// Whether a step misses `want` in a bit: its ExactSteps value, or its
// FastSteps value where FastSteps does not call for the exact path.
__device__ __forceinline__ bool misses(float exact, float fast, bool need, float want) {
  return __float_as_uint(exact) != __float_as_uint(want) || (!need && __float_as_uint(fast) != __float_as_uint(want));
}

// Adds 1 to *out for each bf16 x (all 65,536 bit patterns) where the
// division by c, bf16(x / c) from bf16_recip(c), misses bfr(__fdiv_rn(x, c)).
__global__ void __launch_bounds__(256) bf16s_check_div_c_kernel(float c, unsigned long long* out) {
  const float x = __uint_as_float((blockIdx.x * 256u + threadIdx.x) << 16), rc = bf16_recip(c);
  FastSteps fast;
  const float got = fast.div(x, rc, c);
  if (misses(ExactSteps().div(x, rc, c), got, fast.need, bfr(__fdiv_rn(x, c)))) atomicAdd(out, 1ull);
}

// The same over every (x, d) pair of bf16 bit patterns, 2^32 (block i takes
// d = pattern i), to out[0]; and div_exact alone (the exact path, also the
// rows' bf16(1 / bf16(l * l))) against the IEEE division, to out[1].
__global__ void __launch_bounds__(256) bf16s_check_div_l_kernel(unsigned long long* out) {
  const float d = __uint_as_float(blockIdx.x << 16), r = bf16_recip(d);
  unsigned n[2] = {0, 0};
  for (unsigned k = threadIdx.x; k < 65536u; k += 256u) {
    const float x = __uint_as_float(k << 16);
    const float want = bfr(__fdiv_rn(x, d));
    FastSteps fast;
    const float got = fast.div(x, r, d);
    n[0] += misses(ExactSteps().div(x, r, d), got, fast.need, want);
    n[1] += __float_as_uint(div_exact(x, d)) != __float_as_uint(want);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n[i] += __shfl_xor_sync(0xffffffffu, n[i], off);
    if (threadIdx.x % 32 == 0 && n[i]) atomicAdd(out + i, (unsigned long long)n[i]);
  }
}

// exp (both flavours) against bfr(expf) over every bf16 t (all 65,536 bit
// patterns: the forward's t = s - m is never above 0, but the backward
// recomputes s in another order than the forward that saved m, so t may be
// a bf16 step above it): mismatches to out[0]; to out[1] the largest
// distance, in units in the last place, between exp_fast(t) and expf(t)
// where both are normal.
__global__ void __launch_bounds__(256) bf16s_check_exp_kernel(unsigned long long* out) {
  const float t = __uint_as_float((blockIdx.x * 256u + threadIdx.x) << 16);
  const float want = expf(t), fast = exp_fast(t);
  FastSteps steps;
  const float got = steps.exp(t);
  if (misses(ExactSteps().exp(t), got, steps.need, bfr(want))) atomicAdd(out, 1ull);
  if (want >= BF16S_TINY && fast >= BF16S_TINY && want < INFINITY && fast < INFINITY) {
    const int a = (int)__float_as_uint(want), b = (int)__float_as_uint(fast);
    atomicMax(out + 1, (unsigned long long)(a > b ? a - b : b - a));
  }
}

}  // namespace

// Runs the bf16-score mode's exhaustive scalar checks on `stream`: the
// division by each of the `nc` divisors c[i] (host floats) over every bf16
// numerator, mismatches to out[i]; the division by every bf16 l, over every
// pair, to out[nc], and its exact path alone to out[nc + 1]; exp, to out[nc
// + 2], and exp_fast's largest distance from expf to out[nc + 3] (`out`: nc
// + 4 zeroed device counters).  Returns the launch error.
extern "C" int flash_bf16s_scalar_check(const float* c, int nc, unsigned long long* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < nc; ++i) bf16s_check_div_c_kernel<<<256, 256, 0, st>>>(c[i], out + i);
  bf16s_check_div_l_kernel<<<65536, 256, 0, st>>>(out + nc);
  bf16s_check_exp_kernel<<<256, 256, 0, st>>>(out + nc + 2);
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted), or on the wgmma route a tensor-map error (NO_ENCODER,
// TENSOR_MAP_ERROR + CUresult).  `route`: FWD_SIMT, float32 (SIMT kernel);
// FWD_MMA, bfloat16 on mma.sync (flash_fwd_mma_bf16_kernel); FWD_WGMMA,
// bfloat16 at D 64, 80, 128 or 192 with rows TMA can address, fp32 scores
// (flash_fwd_wgmma_kernel).  o has q's shape and type.  `lse` (fp32 [B, H,
// Sq], or null) gets the log-sum-exp of each row's scaled scores, for the
// backward.  `bf16_scores` 1 runs the bf16-score mode (the
// *_bf16_scores_kernel variants, on FWD_SIMT and FWD_MMA): `scale` is then
// the divisor bf16(sqrt(D)) and `lse` (fp32 [2, B, H, Sq], or null) gets
// each row's m, then l.  Shapes, strides, alignment and the route's
// conditions are validated by the Python wrapper.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int route,
                                   int B, int H, int KVH, int Sq, int Skv, int D,
                                   long long sqb, long long sqh, long long sqs,
                                   long long skb, long long skh, long long sks,
                                   long long svb, long long svh, long long svs,
                                   long long sob, long long soh, long long sos,
                                   int causal, int window, int bf16_scores, float scale, void* stream) {
  const AttnShape p{B, H, KVH, Sq, Skv, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
                    causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_scores ? launch_fwd<true>(q, k, v, o, lse, route, D, p, st)
                     : launch_fwd<false>(q, k, v, o, lse, route, D, p, st);
}

// What flash_fwd_wgmma_kernel<D> was built with, to out[0 .. 5]: consumer
// warpgroups, overlap within a warpgroup, ring slots, blocks an SM it was
// planned for, shared memory a block, and blocks an SM of the current card
// holds at once.  Returns the CUDA error (cudaErrorInvalidValue for a head
// dim the kernel has no instance of).
extern "C" int flash_fwd_wgmma_config(int D, int* out) {
  switch (D) {
    case 64: return fwd_wgmma_config<64>(out);
    case 80: return fwd_wgmma_config<80>(out);
    case 128: return fwd_wgmma_config<128>(out);
    case 192: return fwd_wgmma_config<192>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

// The levels of R's tree sum over n keys (flash_attention.py::tree_levels);
// levels -1 where n needs more than three (n > 32^4).
TreeLevels tree_levels(int n) {
  TreeLevels t{0, {0, 0, 0}, {0, 0, 0}};
  while (n > 32) {
    if (t.levels == 3) return TreeLevels{-1, {0, 0, 0}, {0, 0, 0}};
    t.lo[t.levels] = ((32 - n % 32) % 32) / 2;
    t.n[t.levels] = n;
    ++t.levels;
    n = (n + 31) / 32;
  }
  return t;
}

}  // namespace

// Route codes of flash_attention_bwd (flash_attention.py::BWD_ROUTES; its
// bwd_route picks one by type, head dim, strides and alignment).
enum BwdRoute { BWD_SIMT = 0, BWD_MMA = 1, BWD_WGMMA = 2 };

// The backward: dq, dk, dv (the inputs' shapes, types and own strides) from
// q, k, v, the forward's o and lse (fp32 [B, H, Sq]) and dO.  `strides` holds
// 24 element strides: batch, head and position of q, k, v, o, dO, dq, dk,
// dv in that order.  `route`: BWD_SIMT (fp32) and BWD_MMA (bf16) launch the
// delta pre-pass, the dQ kernel and the dK/dV kernel(s), with `scratch` fp32
// [B, H, Sq] for delta; BWD_WGMMA (bf16, D 64, 80 or 128, rows TMA can address)
// launches the dQ kernel, which writes lse and delta to `scratch` (fp32 [B *
// H][ceil(Sq / 64)][2][64]; with `bf16_scores`, m, l, R and 1 / l, [4][64]),
// and the dK/dV kernel in clusters of `cluster` blocks (a divisor of H /
// KVH, at most 8).  All on `stream`; returns the
// first launch error (0 when all were accepted) or, on the wgmma route, a
// tensor-map error (NO_ENCODER, TENSOR_MAP_ERROR + CUresult).  Shapes,
// strides, alignment, the route's conditions and the absence of rows that
// see no key are validated by the wrapper.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
                                   const void* dout, void* dq, void* dk, void* dv, float* scratch, int route,
                                   int cluster, int B, int H, int KVH, int Sq, int Skv, int D,
                                   const long long* strides, int causal, int window, int bf16_scores, float scale,
                                   void* stream) {
  BwdShape p{B, H, KVH, Sq, Skv, {}, causal, window, scale, tree_levels(Skv)};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  const BwdArgs a{q, k, v, o, dout, lse, dq, dk, dv, scratch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_scores) {
    if (p.tree.levels < 0) return (int)cudaErrorInvalidValue;
    if (route == BWD_SIMT) {
      switch (D) {
        case 16: return launch_bwd_f32_bf16_scores<16>(a, p, st);
        case 32: return launch_bwd_f32_bf16_scores<32>(a, p, st);
        case 64: return launch_bwd_f32_bf16_scores<64>(a, p, st);
        case 80: return launch_bwd_f32_bf16_scores<80>(a, p, st);
        case 128: return launch_bwd_f32_bf16_scores<128>(a, p, st);
        case 192: return launch_bwd_f32_bf16_scores<192>(a, p, st);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if (route == BWD_WGMMA) {
    switch (D) {
      case 64: return bf16_scores ? launch_bwd_wgmma<64, true>(a, p, cluster, st)
                                  : launch_bwd_wgmma<64, false>(a, p, cluster, st);
      case 80: return bf16_scores ? launch_bwd_wgmma<80, true>(a, p, cluster, st)
                                  : launch_bwd_wgmma<80, false>(a, p, cluster, st);
      case 128: return bf16_scores ? launch_bwd_wgmma<128, true>(a, p, cluster, st)
                                   : launch_bwd_wgmma<128, false>(a, p, cluster, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 delta_grid((unsigned)(B * H), (unsigned)((Sq + 7) / 8));
  if (route == BWD_SIMT) {
    flash_bwd_delta_kernel<float><<<delta_grid, 256, 0, st>>>(static_cast<const float*>(o),
                                                              static_cast<const float*>(dout), scratch, p, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (D) {
      case 16: return launch_bwd_f32<16>(a, p, st);
      case 32: return launch_bwd_f32<32>(a, p, st);
      case 64: return launch_bwd_f32<64>(a, p, st);
      case 80: return launch_bwd_f32<80>(a, p, st);
      case 128: return launch_bwd_f32<128>(a, p, st);
      case 192: return launch_bwd_f32<192>(a, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route == BWD_MMA) {
    if (!bf16_scores) {
      flash_bwd_delta_kernel<bf16><<<delta_grid, 256, 0, st>>>(static_cast<const bf16*>(o),
                                                               static_cast<const bf16*>(dout), scratch, p, D);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    // 16-byte copies where every row the kernels read (q, k, v, dO) starts 16-byte aligned
    int vec16 = 1;
    const int read[] = {SQ_, SK_, SV_, SDO_};
    for (int t : read)
      for (int j = 0; j < 3; ++j) vec16 &= p.st[t][j] % 8 == 0;
    const void* ptrs[] = {q, k, v, dout};
    for (const void* ptr : ptrs) vec16 &= reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    if (bf16_scores) {
      switch (D) {
        case 16: return launch_bwd_mma_bf16_scores<16>(a, p, vec16, st);
        case 32: return launch_bwd_mma_bf16_scores<32>(a, p, vec16, st);
        case 64: return launch_bwd_mma_bf16_scores<64>(a, p, vec16, st);
        case 80: return launch_bwd_mma_bf16_scores<80>(a, p, vec16, st);
        case 128: return launch_bwd_mma_bf16_scores<128>(a, p, vec16, st);
        case 192: return launch_bwd_mma_bf16_scores<192>(a, p, vec16, st);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    switch (D) {
      case 16: return launch_bwd_mma<16>(a, p, vec16, st);
      case 32: return launch_bwd_mma<32>(a, p, vec16, st);
      case 64: return launch_bwd_mma<64>(a, p, vec16, st);
      case 80: return launch_bwd_mma<80>(a, p, vec16, st);
      case 128: return launch_bwd_mma<128>(a, p, vec16, st);
      case 192: return launch_bwd_mma<192>(a, p, vec16, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

namespace {

template <int D, bool BF16S>
int wgmma_occupancy(int dkdv) {
  int blocks = 0;
  const int smem = dkdv ? dkdv_wgmma_smem<D>() : dq_wgmma_smem<D>();
  const void* fn = dkdv ? (BF16S ? (const void*)flash_bwd_dkdv_wgmma_bf16_scores_kernel<D>
                                 : (const void*)flash_bwd_dkdv_wgmma_kernel<D>)
                        : (BF16S ? (const void*)flash_bwd_dq_wgmma_bf16_scores_kernel<D>
                                 : (const void*)flash_bwd_dq_wgmma_kernel<D>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, HTHREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Blocks of the wgmma route's dQ (dkdv 0) or dK/dV (dkdv 1) kernel at head
// dim D (64, 80 or 128), fp32 or bf16 scores, one SM of the current card
// holds at once, or minus the CUDA error.
extern "C" int flash_bwd_wgmma_occupancy(int D, int bf16_scores, int dkdv) {
  switch (D) {
    case 64: return bf16_scores ? wgmma_occupancy<64, true>(dkdv) : wgmma_occupancy<64, false>(dkdv);
    case 80: return bf16_scores ? wgmma_occupancy<80, true>(dkdv) : wgmma_occupancy<80, false>(dkdv);
    case 128: return bf16_scores ? wgmma_occupancy<128, true>(dkdv) : wgmma_occupancy<128, false>(dkdv);
    default: return -(int)cudaErrorInvalidValue;
  }
}
