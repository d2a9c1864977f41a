// Batched GEMM C[e] = A[e] . B[e] (fp32 accumulator, output in the input type) for sm_90a.
//
// Replaces src/repro/kernels/gemm.py::gemm (the Pallas kernel _gemm_kernel):
// C[M, N] = A[M, K] . B[K, N] with the sum kept in fp32 and the result cast to
// a's type.  On the MoE path it is the three capacity-batched expert products
// of moe_ffn_local (einsums ecd,edf->ecf and ecf,efd->ecd), one launch for all
// experts: A, B and C carry a batch stride, and the 2-D gemm is the batch-1
// case.  Ragged edges are handled here, where the Pallas wrapper pads copies
// of the inputs to whole tiles.
//
// Bounds, at the H100 SXM data sheet's 989 TFLOP/s (bf16) and 3.35 TB/s:
//   phi3.5-moe prefill, 16 experts x [320, 4096] . [4096, 6400] (and the down
//     product [320, 6400] . [6400, 4096]): 268 GFLOP over 946 MB, as much
//     bound by operations (0.27 ms) as by bytes (0.28 ms);
//   llama4-scout prefill, 16 x [160, 5120] . [5120, 8192] (and back):
//     215 GFLOP over 1.41 GB, bound by bytes (0.42 ms; operations 0.22 ms);
//   decode (capacity 8): 6.7 GFLOP over 842 MB (phi3.5-moe), bound by bytes,
//     every expert's weights read once a step.
// The weights dominate the bytes: each expert's B (52 MB or 84 MB, more than
// the 50 MB L2) must stream from HBM about once, while the tensor cores run
// near their peak.
//
// Routes.  The wrapper picks one (gemm.py::route, by type, M, K, the
// operands' majors and alignment only); gemm_decode launches route 1's two
// kernels and gemm_fwd one of the others:
//
// 0. fp32: gemm_fma_f32_kernel on the FMA pipes, no TF32 (the reference's
//    2e-4 would not hold): 64 x 64 tiles, 256 threads, 4 x 4 outputs each.
// 1. bf16 with M <= 16 (decode) where K and N are multiples of 8 and every
//    row is 16-byte aligned (every decode step of the MoE models):
//    gemm_decode_bf16_kernel<MT> and gemm_decode_sum_kernel<MT>, a
//    persistent grid over equal shares of the weights, fed by TMA (below).
// 2. bf16 with M <= 16 and rows that TMA cannot address:
//    gemm_mma_bf16_kernel<16, 128> on mma.sync m16n8k16, a 4-stage ring of
//    masked element loads, ldmatrix fragments (B transposed on the way, as it
//    is stored K by N); no path on the card runs it.
// 3. bf16 with M > 16 and rows that TMA cannot address (K or N not a multiple
//    of 8, or a row not 16-byte aligned): gemm_mma_bf16_kernel<64, 256>, the
//    masked mma.sync ring, 64 x 256 tiles of 8 warps; no path on the card
//    runs it.
//    Routes 0-3 read A K-major and B MN-major only; the wrapper copies a
//    transposed view for them (gemm.py::route says when).
// 4-11. bf16 with M > 16 and TMA-addressable rows (every prefill product and
//    every training product): gemm_wgmma_bf16_kernel<CLUSTER, A_MN, B_MN,
//    SHORT>, one instantiation per pair of majors and schedule (the long
//    reduction, then the short), so that the backward reads its transposed
//    operands where they lie.  The forward (4-5) reads A K-major and B
//    MN-major as stored; dA = dC . B^T (6-7) reads B^T K-major, since B is
//    stored [K_fwd, N_fwd] with N_fwd, the reduction, contiguous; dB =
//    A^T . dC (8-9) reads A^T MN-major, since A is stored [capacity, d] with
//    d, the output's row, contiguous; 10-11 are both transposed.  wgmma
//    takes either major for both bf16 operands from shared memory (its
//    transpose bits); the TMA maps are encoded over each tensor as it lies,
//    with the box and 128-byte swizzle of that layout.  When the backward
//    copied both transposed operands first, the copies took 10.13 of its
//    15.54 ms a phi3.5-moe layer (NVIDIA H100 80GB HBM3, 700 W;
//    chip_smoke.py).  The forward's route took over from the 64 x 256
//    mma.sync tile, which took 2.6-3.4x cuBLAS's time at the MoE prefill
//    shapes: mma.sync cannot reach the tensor cores' rate, six ldmatrix fed
//    every sixteen MMAs, and its grid read the weights from HBM again for
//    each row tile.  Here:
//    - wgmma.mma_async m64n128k16 reads both operands from shared memory into
//      fp32 accumulators in registers (64 a thread);
//    - TMA brings the tiles (one thread issues them), 128-byte swizzled.  The
//      tensor maps are 3-D, (inner, rows, expert), so the zero fill past the
//      M, K and N edges stays inside each expert.  A K-major operand is rows
//      of 64 K (one box of 192 or 128 rows); an MN-major one is rows of 64 M
//      or N, one per K, in boxes of 64 x 64 one box apart;
//    - a 5-stage ring of 40 KB stages with full and empty mbarriers: one
//      producer warp keeps the loads in flight, three consumer warpgroups
//      run the products (warp specialisation; setmaxnreg moves registers
//      from the producer's warpgroup to the consumers');
//    - the tile is 192 x 128, one consumer warpgroup per 64 rows.  Rows are
//      the capacity in the forward and dA, so the tile height decides the
//      padded rows:
//        M = 320: 64-row tiles pad nothing but read each weight tile five
//                 times; 128 and 192 rows both pad to 384, and a warpgroup
//                 whose 64 rows are all past M skips its products, so the
//                 192-row tile's second tile runs two warpgroups of three;
//        M = 160: 128-row tiles pad to 256 (38% of the rows wasted), 64- and
//                 192-row tiles to 192 (17%), and one 192-row tile reads
//                 each weight tile once where 64-row tiles read it three
//                 times.
//      So 192 rows, the least padding at both M with the fewest weight reads;
//      128 columns keep three warpgroups' accumulators (64 registers each)
//      and five 40 KB stages (200 KB) within one SM;
//    - the tiles run in the order (row tile, column tile, expert), the row
//      tile fastest, so the row tiles that share an expert's weight tile run
//      at about the same time and read it from HBM once;
//    - blocks pair up in 2-block clusters along N (where the column tiles
//      pair up): each of the two loads half of their common A tile and
//      multicasts it to both, so A crosses from L2 once per pair, and each
//      consumer warpgroup releases a stage in both blocks.  Unclustered, the
//      forward took 1.02-1.28x as long at the MoE prefill shapes.  It is
//      bound by its loads, not by the tensor cores: with its products
//      removed it took 0.95-1.00 of its whole time, with its loads removed
//      0.65-0.75 (NVIDIA H100 80GB HBM3, 700 W; scripts/gemm_probe.py times
//      these probes, GEMM_PROBE below).  Clusters of 2 x 2 that share B as
//      well fit fewer blocks on the card at once and were no faster;
//    - the schedule of the short-reduction, write-heavy product.  dB's
//      reduction is the capacity: 320 at phi3.5-moe's training shape, five
//      64-deep stages, while its output is 16 x 4096 x 6400 bf16, 839 MB,
//      as much bound by those bytes (0.25 ms) as by its operations (0.27
//      ms).  With one block a tile, each block filled its ring, ran 5
//      k-steps and then stored its 48 KB tile from registers: the tensor
//      cores sat idle through the fill and the stores of each of its 17,600
//      tiles: 1.50 ms a gate/up product.  The candidates: (a) a
//      persistent grid, one block an SM walking the tiles, so that the
//      producer loads the next tile's stages while the consumers finish
//      this one and store it; (b) the epilogue through shared memory with a
//      TMA store; (c) a ring only as deep as K needs, so that two blocks fit
//      an SM.  (c) needs a smaller tile: two blocks of three consumer
//      warpgroups cannot hold 64 accumulators a thread in an SM's 64K
//      registers, and 128 x 128 tiles read 28% more from L2 for each output
//      than 192 x 128 in clusters of two.  (b) needs a 48 KB staging tile,
//      so a ring of four stages.  (a) keeps the tile and the ring and
//      changes only the grid: a cluster walks cluster tiles t, t + the
//      clusters the card holds at once (cudaOccupancyMaxActiveClusters),
//      ..., and the ring's phase runs on across tiles.  Measured at dB,
//      gate/up; down (scripts/gemm_probe.py, NVIDIA H100 80GB HBM3, 700 W):
//      (a) alone, stores still from registers, took 1.29 ms (gate/up), all
//      but 0.37 of it in the stores, which wrote 839 MB in 4-byte pieces
//      eight rows apart.  So the short schedule is (a) with (b): a 4-stage
//      ring, the accumulators written to a 128-byte-swizzled tile in shared
//      memory (conflict-free) and one TMA store a 64 x 64 box, whole lines,
//      draining under the next tile's products.  It takes 0.455; 0.499 ms
//      (torch.bmm on the same views 0.481; 0.464), and is now bound by its
//      loads: loads alone 0.441; 0.492, products alone 0.382; 0.430, no
//      stores 0.324; 0.295.  (c) was not built.  Products with K <= 1024
//      take it (gemm.py::SHORT_K); the long reductions keep one block a
//      tile and stores from registers: on the short schedule the forward
//      and dA took 0.96-1.13x as long, and a persistent grid with register
//      stores 1.01-1.19x.
//    Tensor maps are encoded on the host at each call through the driver's
//    cuTensorMapEncodeTiled, found in the loaded libcuda, and passed as
//    __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Element strides of A [batch, M, K] over batch, M and K, of B [batch, K, N]
// over batch, K and N, and of C [batch, M, N] over batch and M (unit over
// N).  The mma.sync and FMA kernels read A with unit stride over K and B
// over N (sak = sbn = 1: the wrapper copies a transposed view for them); the
// wgmma kernel takes either stride of A and of B as the unit one.
struct GemmShape {
  int batch, M, N, K;
  long long sab, sam, sak;
  long long sbb, sbk, sbn;
  long long scb, scm;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fp32 accumulators
// ---------------------------------------------------------------------------

constexpr int BK = 32;     // K depth of one stage: two k16 steps
constexpr int PAD = 8;     // row padding in elements (16 bytes)
constexpr int STAGES = 4;  // depth of the cp.async ring

template <int BM, int BN>
constexpr int mma_smem_bytes() {
  return STAGES * (BM * (BK + PAD) + BK * (BN + PAD)) * (int)sizeof(bf16);
}

// One block per (BN-column tile, BM-row tile, batch entry); the tiles move as
// masked element loads (rows that TMA cannot address).
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
gemm_mma_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C, GemmShape p) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  constexpr int MI = TM / 16, NI = TN / 8;   // mma tiles per warp
  constexpr int LDA = BK + PAD, LDB = BN + PAD;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile must be whole m16 x (2 x n8) tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * BM * LDA;             // [STAGES][BK][LDB]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* Ab = A + blockIdx.z * p.sab;
  const bf16* Bb = B + blockIdx.z * p.sbb;
  bf16* Cb = C + blockIdx.z * p.scb;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * BM * LDA;
    bf16* bs = Bs + stage * BK * LDB;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      bf16* dst = as + r * LDA + kc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gm < p.M && gk + j < p.K) ? Ab[gm * p.sam + gk + j] : __float2bfloat16(0.f);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      bf16* dst = bs + r * LDB + nc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < p.K && gn + j < p.N) ? Bb[gk * p.sbk + gn + j] : __float2bfloat16(0.f);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int ktiles = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage kt-1 is no longer read
    if (kt + STAGES - 1 < ktiles) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * BM * LDA;
    const bf16* bs = Bs + (kt % STAGES) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)  // rows lane % 16, k half lane / 16
        ldmatrix_x4(af[i], as + (wm * TM + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {  // k rows lane % 16, n half lane / 16: two n8 tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + lane % 16) * LDB + wn * TN + j * 8 + (lane / 16) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows lane / 4 and lane / 4 + 8, columns 2 * (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * TM + i * 16 + lane / 4 + h * 8;
        const int gn = n0 + wn * TN + j * 8 + 2 * (lane % 4);
        if (gm >= p.M) continue;
        bf16* out = Cb + gm * p.scm + gn;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (gn < p.N) out[0] = __float2bfloat16(v0);
        if (gn + 1 < p.N) out[1] = __float2bfloat16(v1);
      }
}

template <int BM, int BN, int WM, int WN>
int launch_mma(const bf16* a, const bf16* b, bf16* c, int batch, const GemmShape& p, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<BM, BN>();
  auto kernel = gemm_mma_bf16_kernel<BM, BN, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.N + BN - 1) / BN), (unsigned)((p.M + BM - 1) / BM), (unsigned)batch);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a, b, c, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, M > 16, TMA-addressable: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

// Probes of what bounds the wgmma kernel, for scripts/gemm_probe.py; 0, the
// shipped build, runs the kernel whole.  1 skips the products (the loads
// alone), 2 skips the loads (the products alone, on whatever the ring
// holds), 3 never pairs blocks in a cluster, 4 skips the epilogue's stores,
// 5 runs every product on the long-reduction schedule, 6 every product on
// the short-reduction one (SHORT below).  1, 2 and 4 leave the output wrong.
#ifndef GEMM_PROBE
#define GEMM_PROBE 0
#endif

constexpr int WG_CONSUMERS = 3;                 // consumer warpgroups, 64 rows each
constexpr int WBM = 64 * WG_CONSUMERS;          // 192 rows a tile
constexpr int WBN = 128;                        // columns a tile: one m64n128 product per warpgroup
constexpr int WBK = 64;                         // K a stage: one 128-byte swizzle row of a K-major operand
constexpr int WTHREADS = 128 * (WG_CONSUMERS + 1);
constexpr int BOX = 64 * 64 * 2;                // 8 KB: one swizzled TMA box of 64 x 64, 64 rows of 128 bytes
constexpr int A_STAGE = WG_CONSUMERS * BOX;     // 24 KB: 64 rows of A for each consumer warpgroup
constexpr int B_STAGE = (WBN / 64) * BOX;       // 16 KB
constexpr int STAGE = A_STAGE + B_STAGE;        // 40 KB, a multiple of the 1024-byte swizzle atom
constexpr int C_STAGE = WG_CONSUMERS * 2 * BOX;  // 48 KB: the short schedule's output tile, 64 x 128 a warpgroup

// The two schedules (SHORT: the reduction is a few stages deep, gemm.py::route):
// depth of the ring, and the shared memory a block asks
template <int SHORT>
__host__ __device__ constexpr int wstages() { return SHORT ? 4 : 5; }
template <int SHORT>
__host__ __device__ constexpr int wgmma_smem() {  // + alignment slack, + barriers
  return 1024 + wstages<SHORT>() * STAGE + (SHORT ? C_STAGE : 0) + 2 * wstages<SHORT>() * 8;
}
static_assert(BOX % 1024 == 0 && STAGE % 1024 == 0, "swizzled tiles must stay 1024-byte aligned");
static_assert(wgmma_smem<0>() <= 232448 && wgmma_smem<1>() <= 232448, "ring exceeds the 227 KB a block may use");

// Descriptor of k16 step kk of a 64-deep operand tile at `tile`, by the
// operand's major.  K-major (MN = 0): 128-byte rows of 64 K, eight rows a
// 1024-byte group (SBO), a k16 step 32 bytes along the row.  MN-major
// (MN = 1): 128-byte rows of 64 M or N, one row per K, eight K rows a group
// (SBO), 64-wide blocks of M or N one box apart (LBO), a k16 step 16 rows.
template <int MN>
__device__ __forceinline__ uint64_t operand_desc(const unsigned char* tile, int kk) {
  return MN ? wgmma_desc_sw128(tile + 16 * 128 * kk, BOX, 1024) : wgmma_desc_sw128(tile + 32 * kk, 16, 1024);
}

// This block's share of a stage's A tile (rows m0.., K k0..), multicast to
// the cluster.  K-major: WBM / CLUSTER rows of one box 64 K wide, stored as
// A is.  MN-major (A stored [K, M], M contiguous): in each consumer
// warpgroup's box of 64 K rows x 64 M, its 64 / CLUSTER rows of K.
template <int CLUSTER, int A_MN>
__device__ __forceinline__ void load_a(unsigned char* st, const CUtensorMap* map, uint64_t* bar, int m0, int k0,
                                       int e, int rank) {
  auto load = [&](unsigned char* dst, int c0, int c1) {
    if constexpr (CLUSTER > 1) {
      tma_load_3d_multicast(dst, map, bar, c0, c1, e, (1 << CLUSTER) - 1);
    } else {
      tma_load_3d(dst, map, bar, c0, c1, e);
    }
  };
  if constexpr (A_MN) {
    constexpr int ROWS = WBK / CLUSTER;
#pragma unroll
    for (int j = 0; j < WG_CONSUMERS; ++j) load(st + j * BOX + rank * ROWS * 128, m0 + 64 * j, k0 + rank * ROWS);
  } else {
    constexpr int ROWS = WBM / CLUSTER;
    load(st + rank * ROWS * 128, k0, m0 + rank * ROWS);
  }
}

// A stage's B tile (K k0.., columns n0..): MN-major (stored [K, N]) as two
// boxes of 64 K rows x 64 N; K-major (stored [N, K], K contiguous) as one
// box of 128 N rows x 64 K.
template <int B_MN>
__device__ __forceinline__ void load_b(unsigned char* st, const CUtensorMap* map, uint64_t* bar, int n0, int k0,
                                       int e) {
  if constexpr (B_MN) {
#pragma unroll
    for (int j = 0; j < WBN / 64; ++j) tma_load_3d(st + j * BOX, map, bar, n0 + 64 * j, k0, e);
  } else {
    tma_load_3d(st, map, bar, k0, n0, e);
  }
}

// Each cluster walks cluster tiles t = its index, + the number of clusters,
// ...; a cluster tile is CLUSTER neighbouring 128-column tiles of one
// 192-row tile of one expert, the row tile fastest.  The long schedule
// launches one cluster a tile; the short one as many as the card holds at
// once, each walking many.  Warpgroups 0-2 consume (rows 64w .. 64w + 63 of
// the tile); warpgroup 3 produces, its first thread issuing every TMA load,
// running ahead into the next tile while the consumers finish this one and
// store it.  With CLUSTER = 2 each block loads half of the pair's common A
// tile and multicasts it to both, so A crosses from L2 once for the pair,
// and each consumer warpgroup releases a stage in both blocks (the peer's
// next multicast lands in it).  A_MN and B_MN are the operands' majors
// (wgmma's transpose bits): the tensor maps read each operand where it
// lies.  The long schedule stores its accumulators from registers; the
// short one writes them to a swizzled tile in shared memory that one
// thread of the warpgroup hands to a TMA store, which writes whole lines
// and drains while the warpgroup runs the next tile's products.
template <int CLUSTER, int A_MN, int B_MN, int SHORT>
__global__ void __launch_bounds__(WTHREADS, 1)
gemm_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_c, bf16* __restrict__ C, GemmShape p) {
  constexpr int S = wstages<SHORT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* cstage = smem + S * STAGE;  // SHORT: the output tile, two 64 x 64 boxes a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(cstage + (SHORT ? C_STAGE : 0));
  uint64_t* empty = full + S;
  // the warpgroup index, broadcast so the compiler knows it is warp-uniform:
  // wgmma under a branch it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  const int ktiles = (p.K + WBK - 1) / WBK;
  const int mtiles = (p.M + WBM - 1) / WBM, groups = (p.N + WBN - 1) / WBN / CLUSTER;
  const int tiles = mtiles * groups * p.batch;
  const int rank = blockIdx.x % CLUSTER;  // place in the cluster (CLUSTER x 1 blocks)
  const int first = blockIdx.x / CLUSTER, step = gridDim.x / CLUSTER;
  auto coords = [&](int t, int& m0, int& n0, int& e) {
    m0 = (t % mtiles) * WBM;
    n0 = ((t / mtiles) % groups * CLUSTER + rank) * WBN;
    e = t / mtiles / groups;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                        // the producer's arrive, plus the stage's bytes
      mbar_init(&empty[s], WG_CONSUMERS * CLUSTER);  // one arrive per consumer warpgroup of the cluster
    }
    mbar_fence_init();
  }
  if constexpr (CLUSTER > 1) {
    cluster_sync();  // the peer's barriers are initialised before anything lands in them
  } else {
    __syncthreads();
  }

  // release stage s of this ring in every block of the cluster
  auto release = [&](int s) {
    if (tid != 0) return;
    if constexpr (CLUSTER > 1) {
      for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(&empty[s], c);
    } else {
      mbar_arrive(&empty[s]);
    }
  };

  // kg counts the stages this block has passed through the ring, over every tile
  if (wg == WG_CONSUMERS) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      int kg = 0;
      for (int t = first; t < tiles; t += step) {
        int m0, n0, e;
        coords(t, m0, n0, e);
        for (int kt = 0; kt < ktiles; ++kt, ++kg) {
          const int s = kg % S;
          mbar_wait(&empty[s], ((kg / S) & 1) ^ 1);  // the slot's previous round is consumed, cluster-wide
          unsigned char* st = smem + s * STAGE;
          mbar_arrive_expect_tx(&full[s], GEMM_PROBE == 2 ? 0 : STAGE);
          if constexpr (GEMM_PROBE != 2) {
            load_a<CLUSTER, A_MN>(st, &map_a, &full[s], m0, kt * WBK, e, rank);
            load_b<B_MN>(st + A_STAGE, &map_b, &full[s], n0, kt * WBK, e);
          }
        }
      }
      if constexpr (CLUSTER > 1) {
        // stay until every release of the last rounds has landed: the peer's
        // consumers arrive on this block's barriers, which must outlive them
        for (int i = 0; i < S; ++i, ++kg) mbar_wait(&empty[kg % S], ((kg / S) & 1) ^ 1);
      }
    }
    return;
  }

  setmaxnreg_inc<152>();
  const int warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int kg = 0;
  for (int t = first; t < tiles; t += step) {
    int m0, n0, e;
    coords(t, m0, n0, e);
    if (m0 + 64 * wg >= p.M) {  // every row of this warpgroup lies past M: release each stage, run no products
      for (int kt = 0; kt < ktiles; ++kt, ++kg) {
        mbar_wait(&full[kg % S], (kg / S) & 1);
        release(kg % S);
      }
      continue;
    }
    wgmma_fence_operand(acc);
    // Nothing but wgmma touches acc inside the loop, and no branch encloses
    // it: any other use of the registers while a product is in flight makes
    // ptxas wait for the product (C7517).  The tile's first product
    // overwrites acc (scale-d 0), so the last tile's values need no reset.
    for (int kt = 0; kt < ktiles; ++kt, ++kg) {
      const int s = kg % S;
      mbar_wait(&full[s], (kg / S) & 1);
      const unsigned char* a = smem + s * STAGE + wg * BOX;
      const unsigned char* b = smem + s * STAGE + A_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16 && GEMM_PROBE != 1; ++kk)
        wgmma_m64n128k16_bf16<A_MN, B_MN>(acc, operand_desc<A_MN>(a, kk), operand_desc<B_MN>(b, kk), kt | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done; this one's stay in flight
      if (kt > 0) release((kg - 1) % S);
    }
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    release((kg - 1) % S);
    if constexpr (GEMM_PROBE == 4) continue;

    // accumulator j: columns 8j + 2 (lane % 4) + {0, 1} of rows lane / 4 and lane / 4 + 8 of the warp's 16
    const int r = warp * 16 + lane / 4;  // of the warpgroup's 64 rows
    if constexpr (SHORT) {
      // rows of 128 bytes (64 columns), 16-byte chunk c of row r at chunk c ^ (r % 8): the TMA's 128-byte
      // swizzle, which also puts the eight rows a store instruction writes in eight bank groups
      unsigned char* cs = cstage + wg * 2 * BOX;
      if (tid == 0) tma_store_wait_read<0>();  // the previous tile's store has read the staging tile
      named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(cs + (j / 8) * BOX + row * 128 + (((j % 8) ^ (row % 8)) * 16) +
                                             (lane % 4) * 4) = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                                                       acc[4 * j + 2 * h + 1]);
        }
      fence_proxy_async_shared();
      named_barrier_sync(1 + wg, 128);
      if (tid == 0) {  // rows past M and columns past N are not written
        tma_store_3d(&map_c, cs, n0, m0 + 64 * wg, e);
        tma_store_3d(&map_c, cs + BOX, n0 + 64, m0 + 64 * wg, e);
        tma_store_commit();
      }
    } else {
      const int r0 = m0 + wg * 64 + r;
      bf16* Cb = C + e * p.scb;
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j) {
        const int gn = n0 + 8 * j + 2 * (lane % 4);
        if (gn >= p.N) continue;  // N is a multiple of 8, so gn + 1 < N too
        if (r0 < p.M)
          *reinterpret_cast<__nv_bfloat162*>(Cb + r0 * p.scm + gn) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < p.M)
          *reinterpret_cast<__nv_bfloat162*>(Cb + (r0 + 8) * p.scm + gn) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  if constexpr (SHORT) {
    if (tid == 0) tma_store_wait<0>();  // the last tile's stores have landed
  }
}

// A 3-D map over (inner, rows, batch) of a bf16 tensor whose inner dim is
// unit-stride, as it lies; boxes of 64 inner x `box_rows` rows x 1,
// 128-byte swizzled, zero-filled out of bounds.
int encode_map(CUtensorMap* map, const bf16* base, int inner, int rows, int batch, long long row_stride,
               long long batch_stride, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  if (rows == 1) row_stride = (inner + 7) / 8 * 8;  // never stepped over (a decode step's one row)
  if (batch == 1) batch_stride = row_stride * rows;  // never stepped over; a stride the driver takes
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

template <int CLUSTER, int A_MN, int B_MN, int SHORT>
int launch_wgmma(const bf16* a, const bf16* b, bf16* c, const GemmShape& p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t ce = make_context_current(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  CUtensorMap map_a, map_b, map_c = {};
  int err = A_MN ? encode_map(&map_a, a, p.M, p.K, p.batch, p.sak, p.sab, WBK / CLUSTER)
                 : encode_map(&map_a, a, p.K, p.M, p.batch, p.sam, p.sab, WBM / CLUSTER);
  if (err == 0)
    err = B_MN ? encode_map(&map_b, b, p.N, p.K, p.batch, p.sbk, p.sbb, WBK)
               : encode_map(&map_b, b, p.K, p.N, p.batch, p.sbn, p.sbb, WBN);
  if (err == 0 && SHORT) err = encode_map(&map_c, c, p.N, p.M, p.batch, p.scm, p.scb, 64);
  if (err != 0) return err;
  auto kernel = gemm_wgmma_bf16_kernel<CLUSTER, A_MN, B_MN, SHORT>;
  constexpr int smem = wgmma_smem<SHORT>();
  ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(WTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CLUSTER;  // neighbouring column tiles share their A tile
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const long long tiles = (long long)((p.M + WBM - 1) / WBM) * ((p.N + WBN - 1) / WBN / CLUSTER) * p.batch;
  long long clusters = tiles;
  if constexpr (SHORT) {
    // as many clusters as the card holds at once (one block an SM: the ring takes 208 KB), per device
    static int resident[64] = {};
    if (resident[dev] == 0) {
      ce = cudaOccupancyMaxActiveClusters(&resident[dev], kernel, &cfg);
      if (ce != cudaSuccess) return (int)ce;
      if (resident[dev] <= 0) return (int)cudaErrorInvalidConfiguration;
    }
    clusters = std::min<long long>(tiles, resident[dev]);
  }
  cfg.gridDim = dim3((unsigned)(clusters * CLUSTER));
  ce = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, map_c, c, p);
  return ce != cudaSuccess ? (int)ce : (int)cudaGetLastError();
}

// Column tiles pair up in 2-block clusters where their count is even; an odd
// count runs one block a cluster.  GEMM_PROBE 5 and 6 put every product on
// one schedule.
template <int A_MN, int B_MN, int SHORT>
int launch_wgmma(const bf16* a, const bf16* b, bf16* c, const GemmShape& p, cudaStream_t stream) {
  constexpr int sched = GEMM_PROBE == 5 ? 0 : GEMM_PROBE == 6 ? 1 : SHORT;
  const int ntiles = (p.N + WBN - 1) / WBN;
  return ntiles % 2 == 0 && GEMM_PROBE != 3 ? launch_wgmma<2, A_MN, B_MN, sched>(a, b, c, p, stream)
                                            : launch_wgmma<1, A_MN, B_MN, sched>(a, b, c, p, stream);
}

// ---------------------------------------------------------------------------
// bf16 decode (M <= 16), TMA-addressable: equal shares of the weights
// ---------------------------------------------------------------------------
//
// Every MoE decode step runs three of these products (gate, up, down), each
// 16 experts x [8, d] . [d, f] at capacity 8: 839 MB of weights at
// phi3.5-moe (0.2512 ms at 3.35 TB/s), 1.34 GB at llama4-scout (0.402 ms),
// against 6.7 / 10.7 GFLOP.  Bytes bound the call: every expert's weights
// are read once a step and the tensor cores have nearly nothing to do.
// Route 1's earlier kernel, the mma.sync tile gemm_mma_bf16_kernel<16, 128>
// with 16-byte cp.async copies, ran one block per (128-column tile,
// expert): 800 blocks at phi3.5-moe's gate/up and 512 at its down, 1,024
// and 640 at llama4-scout's, each asking 40 KB of shared memory, so 5 an
// SM and 660 at once: gate/up ran in 1.21 waves (the second 21% full) and
// reached 72% of the bytes bound, down in one wave and 87%, torch.bmm 88%
// (NVIDIA H100 80GB HBM3, 700 W).  Each of its 128 threads also issued its
// own 16-byte copies, 8 KB a stage.  The time went to an uneven share of
// the weights over the SMs.  This design:
// - A persistent grid of one block an SM (the card's count, or fewer where
//   the product has fewer units).  A unit is (expert, 256-column tile, 64
//   rows of K): 32 KB of weights.  The units are ordered expert, column
//   tile, K step (the K step fastest), and block i takes units
//   floor(i U / P) .. floor((i + 1) U / P) - 1 of the U: the SMs' shares
//   differ by at most one unit (0.5% of a share at the MoE shapes), and a
//   block walks K within a tile, so its fp32 sum stays in registers.
// - A block's run of units within one tile is a piece.  A piece that is a
//   whole tile (every K step) is stored as bf16 by its block; a tile split
//   between blocks (one at each boundary between two shares, at most P - 1
//   tiles) has a block's first or last piece in it, whose fp32 partial goes
//   to a scratch [block][first / last][strip][thread][MT / 2], and
//   gemm_decode_sum_kernel sums the partials of each split tile in block
//   order, which is K order, and stores them: one fixed order, nothing
//   atomic, so two calls give the same bits.  The partials are ~2 MB
//   written and read again at the MoE shapes, 0.5% of the weights' bytes.
// - TMA feeds a 6-stage mbarrier ring (34 KB a stage: four 64 x 64 boxes of
//   the weights, 128-byte swizzled, and the unit's 64 K of A, MT rows): up
//   to 200 KB in flight an SM, which the block's first thread refills as
//   each stage is released.  No thread copies bytes itself.
// - The products run on wgmma with the operands swapped, C^T = B^T . A^T:
//   each 64-column strip of the weights is wgmma's M, read MN-major as B
//   lies, and the capacity is its N (8, or 16 for M 9 .. 16), A read
//   K-major: m64n8k16 / m64n16k16, sixteen a stage, fp32 accumulators of 4
//   or 8 registers a strip.  No tensor-core row is wasted on padding, and no
//   fragment passes through ldmatrix.  Ragged N, K and M are zero-filled by
//   TMA and masked at the stores.
// scripts/gemm_probe.py builds copies with -DGEMM_PROBE=7 (the decode
// kernel's loads alone, no products) and 8 (its products alone, no loads):
// when the loads alone take the whole kernel's time, no other choice of
// product (mma.sync on the same feed) can make it faster.  Measured (NVIDIA
// H100 80GB HBM3, 700 W; the L2 cold before each call, as a decode step
// finds it): 0.289 / 0.292 ms at phi3.5-moe's gate/up and down, 0.459 /
// 0.457 at llama4-scout's, 86-88% of the bound, against torch.bmm's 0.282 /
// 0.271 / 0.437 / 0.439 and the mma.sync tile's 0.359 / 0.297 / 0.506 /
// 0.477.  The loads alone take the whole time (the products alone
// 0.06-0.10 ms); every block starts within 0.2 us and its share takes
// 204-283 us, so the slower SMs' ~23 GB/s each sets the time.  Tiles of
// 128 or 512 columns, a ring of 4 and two blocks an SM moved it by -2% to
// +2%.

// GEMM_PROBE 9 and 10 build it with other tiles and rings (9: 512 columns,
// 3 stages; 10: 128 columns, 12 stages), 11 with a ring of 4 (the wrapper's
// gemm.DECODE_TILE must name the columns); 12 has each block's first thread
// write its SM and its start and end on the global timer after the
// partials in `ws`; 13 runs two blocks an SM, each with a ring of 3 (the
// caller sizes the grid).
constexpr int DSTRIPS = GEMM_PROBE == 9 ? 8 : GEMM_PROBE == 10 ? 2 : 4;  // 64-column strips of a tile
constexpr int DNT = 64 * DSTRIPS;         // columns of a tile: 256
constexpr int DKS = 64;                   // rows of K a unit, a stage
constexpr int DSTAGES = GEMM_PROBE == 9 || GEMM_PROBE == 13 ? 3 : GEMM_PROBE == 10 ? 12 : GEMM_PROBE == 11 ? 4 : 6;
constexpr int DBLOCKS_AN_SM = GEMM_PROBE == 13 ? 2 : 1;
constexpr int DTHREADS = 128;             // one warpgroup; its first thread issues the TMA loads

// A stage: the weights' four 64 x 64 boxes, then A's 64 K x MT rows (1 or 2 KB, whole swizzle atoms).
template <int MT>
__host__ __device__ constexpr int dstage_bytes() { return DSTRIPS * BOX + MT * 128; }
template <int MT>
__host__ __device__ constexpr int decode_smem() { return 1024 + DSTAGES * dstage_bytes<MT>() + DSTAGES * 8; }
static_assert(dstage_bytes<8>() % 1024 == 0 && dstage_bytes<16>() % 1024 == 0, "stages stay 1024-byte aligned");
static_assert(decode_smem<16>() <= 232448, "the ring exceeds the 227 KB a block may use");

// The split: `units` = batch * ntiles * steps, walked by `blocks` blocks.
struct DecodePlan {
  int ntiles;       // 256-column tiles an expert: ceil(N / 256)
  int steps;        // K steps a tile: ceil(K / 64)
  long long units;  // batch * ntiles * steps
  int blocks;       // the grid; block i takes units dstart(i) .. dstart(i + 1) - 1
};

__host__ __device__ __forceinline__ long long dstart(const DecodePlan& q, int i) {
  return (long long)i * q.units / q.blocks;
}

// The swapped product of k16 step kk: strip (64 columns of the weights, 64
// K rows of 128 bytes, MN-major) as wgmma's A, the activations (MT rows of
// 64 K, K-major) as its B.
template <int MT>
__device__ __forceinline__ void decode_mma(float (&d)[MT / 2], const unsigned char* strip, const unsigned char* act,
                                           int kk, int accumulate) {
  const uint64_t da = wgmma_desc_sw128(strip + 16 * 128 * kk, BOX, 1024);
  const uint64_t db = wgmma_desc_sw128(act + 32 * kk, 16, 1024);
  if constexpr (MT == 8) {
    wgmma_m64n8k16_bf16<1, 0>(d, da, db, accumulate);
  } else {
    static_assert(MT == 16, "MT is 8 or 16");
    wgmma_m64n16k16_bf16<1, 0>(d, da, db, accumulate);
  }
}

// Stores a tile's sums as bf16: accumulator register 4 jj + 2 h + x of strip
// j is column n0 + 64 j + r + 8 h and row 8 jj + 2 t + x (the m64nMT
// fragment: rows of wgmma's M are C's columns here).
template <int MT>
__device__ __forceinline__ void decode_store(const float (&acc)[DSTRIPS][MT / 2], bf16* __restrict__ C,
                                             const GemmShape& p, int e, int n0) {
  const int tid = threadIdx.x, r = tid / 32 * 16 + tid % 32 / 4, t = tid % 4;
  bf16* Ce = C + e * p.scb;
#pragma unroll
  for (int j = 0; j < DSTRIPS; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * j + r + 8 * h;
      if (n >= p.N) continue;
#pragma unroll
      for (int jj = 0; jj < MT / 8; ++jj)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int m = 8 * jj + 2 * t + x;
          if (m < p.M) Ce[m * p.scm + n] = __float2bfloat16(acc[j][4 * jj + 2 * h + x]);
        }
    }
}

// The scratch of block `blk`'s first (slot 0) or last (slot 1) piece: this
// thread's MT / 2 floats of each strip.
template <int MT>
__device__ __forceinline__ float* decode_slot(float* ws, int blk, int slot, int j) {
  return ws + (((long long)(blk * 2 + slot) * DSTRIPS + j) * DTHREADS + threadIdx.x) * (MT / 2);
}

template <int MT>
__global__ void __launch_bounds__(DTHREADS, DBLOCKS_AN_SM)
gemm_decode_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                        bf16* __restrict__ C, float* __restrict__ ws, GemmShape p, DecodePlan q) {
  constexpr int S = DSTAGES, STG = dstage_bytes<MT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STG);
  const int tid = threadIdx.x;
  const long long u0 = dstart(q, blockIdx.x), u1 = dstart(q, blockIdx.x + 1);
  const int count = (int)(u1 - u0);

  auto load = [&](int g) {  // unit u0 + g into stage g % S
    const long long u = u0 + g;
    const int tile = (int)(u / q.steps), k0 = (int)(u % q.steps) * DKS;
    const int e = tile / q.ntiles, n0 = tile % q.ntiles * DNT;
    uint64_t* bar = &full[g % S];
    unsigned char* st = smem + g % S * STG;
    mbar_arrive_expect_tx(bar, GEMM_PROBE == 8 ? 0 : STG);
    if constexpr (GEMM_PROBE != 8) {
#pragma unroll
      for (int j = 0; j < DSTRIPS; ++j) tma_load_3d(st + j * BOX, &map_b, bar, n0 + 64 * j, k0, e);
      tma_load_3d(st + DSTRIPS * BOX, &map_a, bar, k0, 0, e);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma_prefetch_map(&map_a);
    tma_prefetch_map(&map_b);
    for (int g = 0; g < min(count, S); ++g) load(g);
  }
  uint64_t t_start = 0;
  if constexpr (GEMM_PROBE == 12) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));

  float acc[DSTRIPS][MT / 2];
#pragma unroll
  for (int j = 0; j < DSTRIPS; ++j)
#pragma unroll
    for (int x = 0; x < MT / 2; ++x) acc[j][x] = 0.f;
  for (int g = 0; g < count;) {
    const long long u = u0 + g;
    const int tile = (int)(u / q.steps);
    const long long lo = (long long)tile * q.steps, hi = lo + q.steps;
    const int n = (int)(min(u1, hi) - u);  // units of this piece
    // Nothing but wgmma touches acc inside the loop: the piece's first
    // product overwrites it (scale-d 0), so the last piece's sums need no reset.
    for (int i = 0; i < n; ++i, ++g) {
      mbar_wait(&full[g % S], (g / S) & 1);
      const unsigned char* st = smem + g % S * STG;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DSTRIPS; ++j)
#pragma unroll
        for (int kk = 0; kk < DKS / 16 && GEMM_PROBE != 7; ++kk)
          decode_mma<MT>(acc[j], st + j * BOX, st + DSTRIPS * BOX, kk, i | kk);
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();  // every warp is done with the stage
      if (tid == 0 && g + S < count) load(g + S);
    }
#pragma unroll
    for (int j = 0; j < DSTRIPS; ++j) wgmma_fence_operand(acc[j]);
    if (u == lo && u1 >= hi) {  // a whole tile: its sums are final
      decode_store<MT>(acc, C, p, tile / q.ntiles, tile % q.ntiles * DNT);
    } else {  // this block's first piece (slot 0) or its last (slot 1) of a split tile
#pragma unroll
      for (int j = 0; j < DSTRIPS; ++j) {
        float4* w = reinterpret_cast<float4*>(decode_slot<MT>(ws, blockIdx.x, u == u0 ? 0 : 1, j));
#pragma unroll
        for (int x = 0; x < MT / 8; ++x)
          w[x] = make_float4(acc[j][4 * x], acc[j][4 * x + 1], acc[j][4 * x + 2], acc[j][4 * x + 3]);
      }
    }
  }
  if constexpr (GEMM_PROBE == 12) {
    if (tid == 0) {
      uint64_t t_end, sm;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
      asm volatile("{ .reg .u32 s; mov.u32 s, %%smid; cvt.u64.u32 %0, s; }" : "=l"(sm));
      uint64_t* ts = reinterpret_cast<uint64_t*>(ws + (long long)q.blocks * 2 * DSTRIPS * DTHREADS * (MT / 2)) +
                     3 * blockIdx.x;
      ts[0] = sm;
      ts[1] = t_start;
      ts[2] = t_end;
    }
  }
}

// The tiles split between blocks: block b takes the boundary between shares
// b and b + 1 (grid: blocks - 1, or one block that finds nothing to do).  A
// boundary on a tile's edge splits nothing; of the boundaries inside one
// tile, the first sums it: the pieces of blocks b .. (the last that starts
// inside the tile), in that order, from their first or last slot.
template <int MT>
__global__ void __launch_bounds__(DTHREADS)
gemm_decode_sum_kernel(const float* __restrict__ ws, bf16* __restrict__ C, GemmShape p, DecodePlan q) {
  const int i = blockIdx.x + 1;
  if (i >= q.blocks) return;
  const long long u = dstart(q, i);
  if (u % q.steps == 0) return;
  const int tile = (int)(u / q.steps);
  const long long lo = (long long)tile * q.steps, hi = lo + q.steps;
  if (i > 1 && dstart(q, i - 1) > lo) return;
  float sum[DSTRIPS][MT / 2];
#pragma unroll
  for (int j = 0; j < DSTRIPS; ++j)
#pragma unroll
    for (int x = 0; x < MT / 2; ++x) sum[j][x] = 0.f;
  for (int b = i - 1; b < q.blocks && dstart(q, b) < hi; ++b) {
    const int slot = dstart(q, b) >= lo ? 0 : 1;
#pragma unroll
    for (int j = 0; j < DSTRIPS; ++j) {
      const float4* w = reinterpret_cast<const float4*>(decode_slot<MT>(const_cast<float*>(ws), b, slot, j));
#pragma unroll
      for (int x = 0; x < MT / 8; ++x) {
        const float4 v = w[x];
        sum[j][4 * x] += v.x;
        sum[j][4 * x + 1] += v.y;
        sum[j][4 * x + 2] += v.z;
        sum[j][4 * x + 3] += v.w;
      }
    }
  }
  decode_store<MT>(sum, C, p, tile / q.ntiles, tile % q.ntiles * DNT);
}

// The decode route: the split's kernel, then the sum of the split tiles, on
// `stream`.  `ws` holds blocks * 2 * DSTRIPS * 128 * MT / 2 floats.
template <int MT>
int launch_decode(const bf16* a, const bf16* b, bf16* c, float* ws, int blocks, const GemmShape& p,
                  cudaStream_t stream) {
  int dev = 0;
  cudaError_t ce = make_context_current(&dev);
  if (ce != cudaSuccess) return (int)ce;
  CUtensorMap map_a, map_b;
  int err = encode_map(&map_a, a, p.K, p.M, p.batch, p.sam, p.sab, MT);  // 64 K x MT rows
  if (err == 0) err = encode_map(&map_b, b, p.N, p.K, p.batch, p.sbk, p.sbb, DKS);  // 64 columns x 64 K
  if (err != 0) return err;
  const int ntiles = (p.N + DNT - 1) / DNT, steps = (p.K + DKS - 1) / DKS;
  const DecodePlan q{ntiles, steps, (long long)p.batch * ntiles * steps, blocks};
  if (blocks < 1 || blocks > q.units) return (int)cudaErrorInvalidValue;
  constexpr int smem = decode_smem<MT>();
  ce = cudaFuncSetAttribute(gemm_decode_bf16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  gemm_decode_bf16_kernel<MT><<<blocks, DTHREADS, smem, stream>>>(map_a, map_b, c, ws, p, q);
  if ((ce = cudaGetLastError()) != cudaSuccess) return (int)ce;
  gemm_decode_sum_kernel<MT><<<std::max(blocks - 1, 1), DTHREADS, 0, stream>>>(ws, c, p, q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA pipes, no TF32
// ---------------------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
gemm_fma_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, GemmShape p) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // As[k][m] = A[m0 + m][k0 + k]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];  // Bs[k][n] = B[k0 + k][n0 + n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const float* Ab = A + blockIdx.z * p.sab;
  const float* Bb = B + blockIdx.z * p.sbb;
  float* Cb = C + blockIdx.z * p.scb;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FBK) {
    for (int e = tid; e < FBM * FBK; e += FTHREADS) {
      const int r = e / FBK, k = e % FBK;
      As[k][r] = (m0 + r < p.M && k0 + k < p.K) ? __ldg(Ab + (m0 + r) * p.sam + k0 + k) : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += FTHREADS) {
      const int k = e / FBN, n = e % FBN;
      Bs[k][n] = (k0 + k < p.K && n0 + n < p.N) ? __ldg(Bb + (k0 + k) * p.sbk + n0 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < p.N) Cb[gm * p.scm + gn] = acc[i][j];
    }
  }
}

int launch_f32(const float* a, const float* b, float* c, int batch, const GemmShape& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.N + FBN - 1) / FBN), (unsigned)((p.M + FBM - 1) / FBM), (unsigned)batch);
  gemm_fma_f32_kernel<<<grid, FTHREADS, 0, stream>>>(a, b, c, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernels gemm_fwd launches, by the route code the wrapper passes
// (gemm.py::KERNELS lists them in this order; gemm.py::route picks one).
// WGMMA_<A's major><B's major>_<schedule>: K is K-major, N MN-major (wgmma's
// transpose bits 0 and 1); LONG and SHORT the reduction's schedule.
enum Route {
  FMA_F32 = 0,
  DECODE = 1,  // gemm_decode, its own entry
  MMA_M16_MASKED = 2,
  MMA_M64_MASKED = 3,
  WGMMA_KN_LONG = 4,  // the forward's layout, as both operands are stored
  WGMMA_KN_SHORT = 5,
  WGMMA_KK_LONG = 6,  // B K-major: dA = dC . B^T reads B where it lies
  WGMMA_KK_SHORT = 7,
  WGMMA_NN_LONG = 8,  // A MN-major: dB = A^T . dC reads A where it lies
  WGMMA_NN_SHORT = 9,
  WGMMA_NK_LONG = 10,  // both transposed
  WGMMA_NK_SHORT = 11,
};

// Launches on `stream` and returns 0 when the launch was accepted, else the
// CUDA error of the launch or, on the wgmma route, a tensor-map error
// (NO_ENCODER, TENSOR_MAP_ERROR + CUresult).  c is [batch, M, N] in the
// inputs' type.  Shapes, strides and each route's conditions (type, M,
// alignment) are checked by the Python wrapper.
extern "C" int gemm_fwd(const void* a, const void* b, void* c, int route, int batch, int M, int N, int K,
                        long long sab, long long sam, long long sak, long long sbb, long long sbk, long long sbn,
                        long long scb, long long scm, void* stream) {
  const GemmShape p{batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, scb, scm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  bf16* cb = static_cast<bf16*>(c);
  switch (route) {
    case FMA_F32:
      return launch_f32(static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), batch,
                        p, st);
    case MMA_M16_MASKED: return launch_mma<16, 128, 1, 4>(ab, bb, cb, batch, p, st);
    case MMA_M64_MASKED: return launch_mma<64, 256, 2, 4>(ab, bb, cb, batch, p, st);
    case WGMMA_KN_LONG: return launch_wgmma<0, 1, 0>(ab, bb, cb, p, st);
    case WGMMA_KN_SHORT: return launch_wgmma<0, 1, 1>(ab, bb, cb, p, st);
    case WGMMA_KK_LONG: return launch_wgmma<0, 0, 0>(ab, bb, cb, p, st);
    case WGMMA_KK_SHORT: return launch_wgmma<0, 0, 1>(ab, bb, cb, p, st);
    case WGMMA_NN_LONG: return launch_wgmma<1, 1, 0>(ab, bb, cb, p, st);
    case WGMMA_NN_SHORT: return launch_wgmma<1, 1, 1>(ab, bb, cb, p, st);
    case WGMMA_NK_LONG: return launch_wgmma<1, 0, 0>(ab, bb, cb, p, st);
    case WGMMA_NK_SHORT: return launch_wgmma<1, 0, 1>(ab, bb, cb, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decode route (gemm.py::route's route 1: bf16, M <= 16, K and N
// multiples of 8, every row 16-byte aligned; A K-major, B MN-major):
// gemm_decode_bf16_kernel<MT> over `blocks` blocks (one an SM, or fewer
// where the product has fewer units; gemm.py::decode_plan), MT 8 for M <= 8
// and 16 above, then gemm_decode_sum_kernel<MT>, on `stream`.  `ws` is the
// partials' scratch, fp32 [blocks][2][4][128][MT / 2].  Returns 0 when both
// launches were accepted, else the CUDA error or a tensor-map error.
extern "C" int gemm_decode(const void* a, const void* b, void* c, float* ws, int blocks, int batch, int M, int N,
                           int K, long long sab, long long sam, long long sbb, long long sbk, long long scb,
                           long long scm, void* stream) {
  const GemmShape p{batch, M, N, K, sab, sam, 1, sbb, sbk, 1, scb, scm};
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  bf16* cb = static_cast<bf16*>(c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 16) return (int)cudaErrorInvalidValue;
  return M <= 8 ? launch_decode<8>(ab, bb, cb, ws, blocks, p, st) : launch_decode<16>(ab, bb, cb, ws, blocks, p, st);
}

// Blocks of gemm_decode_bf16_kernel<mt> (mt 8 or 16) one SM of the current
// card holds at once, or minus the CUDA error.
extern "C" int gemm_decode_occupancy(int mt) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (mt == 8 || mt == 16) {
    const int smem = mt == 8 ? decode_smem<8>() : decode_smem<16>();
    err = mt == 8 ? cudaFuncSetAttribute(gemm_decode_bf16_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                  : cudaFuncSetAttribute(gemm_decode_bf16_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = mt == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gemm_decode_bf16_kernel<8>, DTHREADS, smem)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gemm_decode_bf16_kernel<16>, DTHREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}
