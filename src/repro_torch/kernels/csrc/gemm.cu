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
// Routes.  gemm_fwd takes the route the wrapper picked (gemm.py::route, by
// type, M and alignment only) and launches one of five kernels:
//
// 0. fp32: gemm_fma_f32_kernel on the FMA pipes, no TF32 (the reference's
//    2e-4 would not hold): 64 x 64 tiles, 256 threads, 4 x 4 outputs each.
// 1-2. bf16 with M <= 16 (decode): gemm_mma_bf16_kernel<16, 128> on mma.sync
//    m16n8k16, a 4-stage cp.async ring, ldmatrix fragments (B transposed on
//    the way, as it is stored K by N): a 16-row tile wastes half its rows at
//    M = 8 where any wgmma tile (64 rows) would waste seven eighths, and the
//    call is bound by the weights' bytes, which this tile streams once.
//    Route 1 when K and N are multiples of 8 and every row is 16-byte aligned
//    (16-byte cp.async copies, zero-filled past the edges), route 2 otherwise
//    (masked element loads into the same ring).
// 3. bf16 with M > 16 and rows that TMA cannot address (K or N not a multiple
//    of 8, or a row not 16-byte aligned): gemm_mma_bf16_kernel<64, 256>, the
//    masked mma.sync ring, 64 x 256 tiles of 8 warps.
// 4. bf16 with M > 16 and TMA-addressable rows (every prefill product):
//    gemm_wgmma_bf16_kernel, which took this route from the 64 x 256
//    mma.sync tile.  That tile took 2.6-3.4x cuBLAS's time at the MoE
//    prefill shapes (NVIDIA H100 80GB HBM3, 700 W): mma.sync cannot
//    reach the tensor cores' rate, six ldmatrix fed every sixteen MMAs, the
//    copies cost every thread registers and instructions, and the grid ran
//    the N tiles fastest, so the M tiles that share an expert's weights ran
//    far apart and read them from HBM again.  Here:
//    - wgmma.mma_async m64n128k16 reads both operands from shared memory into
//      fp32 accumulators in registers (64 a thread);
//    - TMA brings the tiles (one thread issues them), 128-byte swizzled: A
//      K-major as stored, B MN-major as stored (wgmma's transpose bit, no
//      transposed copy).  The tensor maps are 3-D, (K or N, rows, expert),
//      so the zero fill past the M, K and N edges stays inside each expert;
//    - a 5-stage ring of 40 KB stages with full and empty mbarriers: one
//      producer warp keeps the loads in flight, three consumer warpgroups
//      run the products (warp specialisation; setmaxnreg moves registers
//      from the producer's warpgroup to the consumers');
//    - the tile is 192 x 128, one consumer warpgroup per 64 rows.  Rows are
//      the capacity, so the tile height decides the padded rows:
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
//    - the grid runs the M tiles of one (expert, N tile) next to each other
//      (blockIdx.x), so a weight tile is read from HBM once and from L2 by
//      the other M tile at about the same time;
//    - blocks pair up in 2-block clusters along N (where the column tiles
//      pair up): each of the two loads half of their common A tile and
//      multicasts it to both, so A crosses from L2 once per pair, and each
//      consumer warpgroup releases a stage in both blocks.  Unclustered, the
//      kernel takes 1.02-1.28x as long at the MoE prefill shapes.  It stays
//      bound by its loads, not by the tensor cores: with its products
//      removed it takes 0.95-1.00 of its whole time, with its loads removed
//      0.65-0.75 (NVIDIA H100 80GB HBM3, 700 W; scripts/gemm_probe.py times
//      these probes, GEMM_PROBE below).  Clusters of 2 x 2 that share B as
//      well fit fewer blocks on the card at once and were no faster;
//    - the epilogue rounds to bf16 and masks its stores at the ragged M and N
//      edges (TMA's zero fill covers loads only).
//    Tensor maps are encoded on the host at each call through the driver's
//    cuTensorMapEncodeTiled, found in the loaded libcuda, and passed as
//    __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct GemmShape {
  int M, N, K;
  long long sab, sam;  // element strides of A over batch and row (unit over K)
  long long sbb, sbk;  // of B over batch and row (unit over N)
  long long scb, scm;  // of C over batch and row (unit over N)
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

// One block per (BN-column tile, BM-row tile, batch entry).  VEC: every row of
// A, B and C starts 16-byte aligned and K, N are multiples of 8, so the tiles
// move as 16-byte cp.async copies; otherwise as masked element loads.
template <int BM, int BN, int WM, int WN, bool VEC>
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
      if constexpr (VEC) {
        const int n = gm < p.M ? max(0, min(8, p.K - gk)) : 0;
        cp_async16(dst, n > 0 ? Ab + gm * p.sam + gk : Ab, 2 * n);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (gm < p.M && gk + j < p.K) ? Ab[gm * p.sam + gk + j] : __float2bfloat16(0.f);
      }
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      bf16* dst = bs + r * LDB + nc;
      if constexpr (VEC) {
        const int n = gk < p.K ? max(0, min(8, p.N - gn)) : 0;
        cp_async16(dst, n > 0 ? Bb + gk * p.sbk + gn : Bb, 2 * n);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (gk < p.K && gn + j < p.N) ? Bb[gk * p.sbk + gn + j] : __float2bfloat16(0.f);
      }
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
        if (VEC && gn + 1 < p.N) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (gn < p.N) out[0] = __float2bfloat16(v0);
          if (gn + 1 < p.N) out[1] = __float2bfloat16(v1);
        }
      }
}

template <int BM, int BN, int WM, int WN, bool VEC>
int launch_mma(const bf16* a, const bf16* b, bf16* c, int batch, const GemmShape& p, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<BM, BN>();
  auto kernel = gemm_mma_bf16_kernel<BM, BN, WM, WN, VEC>;
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
// holds), 3 never pairs blocks in a cluster.  1 and 2 compute no product.
#ifndef GEMM_PROBE
#define GEMM_PROBE 0
#endif

constexpr int WG_CONSUMERS = 3;                 // consumer warpgroups, 64 rows each
constexpr int WBM = 64 * WG_CONSUMERS;          // 192 rows a tile
constexpr int WBN = 128;                        // columns a tile: one m64n128 product per warpgroup
constexpr int WBK = 64;                         // K a stage: one 128-byte swizzle row of A
constexpr int WSTAGES = 5;                      // depth of the ring
constexpr int WTHREADS = 128 * (WG_CONSUMERS + 1);
constexpr int A_STAGE = WBM * WBK * 2;          // 24 KB: 192 rows of 64 K
constexpr int B_BOX = WBK * 64 * 2;             // 8 KB: 64 K rows of 64 N columns, one TMA box
constexpr int B_STAGE = (WBN / 64) * B_BOX;     // 16 KB
constexpr int STAGE = A_STAGE + B_STAGE;        // 40 KB, a multiple of the 1024-byte swizzle atom
constexpr int WGMMA_SMEM = 1024 + WSTAGES * STAGE + 2 * WSTAGES * 8;  // + alignment slack, + barriers
// descriptor offsets, bytes: A K-major (eight 128-byte rows a group), B MN-major (64-wide N blocks one box apart)
constexpr uint32_t A_SBO = 1024, B_LBO = B_BOX, B_SBO = 1024;
static_assert(A_STAGE % 1024 == 0 && STAGE % 1024 == 0, "swizzled tiles must stay 1024-byte aligned");
static_assert(WGMMA_SMEM <= 232448, "ring exceeds the 227 KB a block may use");

// One block per (192-row tile, 128-column tile, expert), the row tile fastest.
// Warpgroups 0-2 consume (rows 64w .. 64w + 63 of the tile); warpgroup 3
// produces, its first thread issuing every TMA load.  With CLUSTER = 2 the
// two blocks of a cluster hold neighbouring column tiles of the same rows:
// each loads half of the A tile and multicasts it to both, so A crosses
// from L2 once for the pair, and each consumer warpgroup releases a stage
// in both blocks (the peer's next multicast lands in it).
template <int CLUSTER>
__global__ void __launch_bounds__(WTHREADS, 1)
gemm_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       bf16* __restrict__ C, GemmShape p) {
  constexpr int A_ROWS = WBM / CLUSTER;  // rows of A this block loads for the cluster
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WSTAGES * STAGE);
  uint64_t* empty = full + WSTAGES;
  // the warpgroup index, broadcast so the compiler knows it is warp-uniform:
  // wgmma under a branch it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  const int m0 = blockIdx.x * WBM, n0 = blockIdx.y * WBN, e = blockIdx.z;
  const int ktiles = (p.K + WBK - 1) / WBK;
  const int rank = blockIdx.y % CLUSTER;  // place in the cluster (1 x CLUSTER blocks)

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
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

  if (wg == WG_CONSUMERS) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % WSTAGES;
        mbar_wait(&empty[s], ((kt / WSTAGES) & 1) ^ 1);  // the slot's previous round is consumed, cluster-wide
        unsigned char* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], GEMM_PROBE == 2 ? 0 : STAGE);
        if constexpr (GEMM_PROBE == 2) continue;
        if constexpr (CLUSTER > 1) {
          tma_load_3d_multicast(st + rank * A_ROWS * 128, &map_a, &full[s], kt * WBK, m0 + rank * A_ROWS, e,
                                (1 << CLUSTER) - 1);
        } else {
          tma_load_3d(st, &map_a, &full[s], kt * WBK, m0, e);
        }
#pragma unroll
        for (int j = 0; j < WBN / 64; ++j) tma_load_3d(st + A_STAGE + j * B_BOX, &map_b, &full[s], n0 + 64 * j, kt * WBK, e);
      }
      if constexpr (CLUSTER > 1) {
        // stay until every release of the last rounds has landed: the peer's
        // consumers arrive on this block's barriers, which must outlive them
        for (int kt = ktiles; kt < ktiles + WSTAGES; ++kt) mbar_wait(&empty[kt % WSTAGES], ((kt / WSTAGES) & 1) ^ 1);
      }
    }
    return;
  }

  setmaxnreg_inc<152>();
  if (m0 + 64 * wg >= p.M) {  // every row of this warpgroup lies past M: release each stage, run no products
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[kt % WSTAGES], (kt / WSTAGES) & 1);
      release(kt % WSTAGES);
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma_fence_operand(acc);
  // Nothing but wgmma touches acc inside the loop, and no branch encloses it:
  // any other use of the registers while a product is in flight makes ptxas
  // wait for the product (C7517).
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % WSTAGES;
    mbar_wait(&full[s], (kt / WSTAGES) & 1);
    const unsigned char* a = smem + s * STAGE + wg * 64 * 128;
    const unsigned char* b = smem + s * STAGE + A_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16 && GEMM_PROBE != 1; ++kk)
      wgmma_m64n128k16_bf16_kn(acc, wgmma_desc_sw128(a + 32 * kk, 16, A_SBO),
                               wgmma_desc_sw128(b + 16 * 128 * kk, B_LBO, B_SBO), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done; this one's stay in flight
    if (kt > 0) release((kt - 1) % WSTAGES);
  }
  wgmma_wait<0>();
  wgmma_fence_operand(acc);
  release((ktiles - 1) % WSTAGES);

  // accumulator j: columns 8j + 2 (lane % 4) + {0, 1} of rows lane / 4 and lane / 4 + 8 of the warp's 16
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the CUDA runtime has
// loaded (no link against the driver library needed); null if absent.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Error codes of gemm_fwd beyond the CUDA runtime's: no cuTensorMapEncodeTiled,
// or TENSOR_MAP_ERROR + the driver's CUresult when it refused a map.
constexpr int NO_ENCODER = 9999, TENSOR_MAP_ERROR = 10000;

// A 3-D map over (inner, rows, batch) of a bf16 tensor whose inner dim is
// unit-stride; boxes of 64 inner x `box_rows` rows x 1, 128-byte swizzled,
// zero-filled out of bounds.
int encode_map(CUtensorMap* map, const bf16* base, int inner, int rows, int batch, long long row_stride,
               long long batch_stride, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

template <int CLUSTER>
int launch_wgmma(const bf16* a, const bf16* b, bf16* c, int batch, const GemmShape& p, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int err = encode_map(&map_a, a, p.K, p.M, batch, p.sam, p.sab, WBM / CLUSTER);
  if (err == 0) err = encode_map(&map_b, b, p.N, p.K, batch, p.sbk, p.sbb, WBK);
  if (err != 0) return err;
  auto kernel = gemm_wgmma_bf16_kernel<CLUSTER>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.M + WBM - 1) / WBM), (unsigned)((p.N + WBN - 1) / WBN), (unsigned)batch);
  cfg.blockDim = dim3(WTHREADS);
  cfg.dynamicSmemBytes = WGMMA_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = CLUSTER;  // neighbouring column tiles share their A tile
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, c, p);
  return ce != cudaSuccess ? (int)ce : (int)cudaGetLastError();
}

// Column tiles pair up in 2-block clusters where their count is even; an odd
// count runs one block a cluster.
int launch_wgmma(const bf16* a, const bf16* b, bf16* c, int batch, const GemmShape& p, cudaStream_t stream) {
  const int ntiles = (p.N + WBN - 1) / WBN;
  return ntiles % 2 == 0 && GEMM_PROBE != 3 ? launch_wgmma<2>(a, b, c, batch, p, stream)
                                            : launch_wgmma<1>(a, b, c, batch, p, stream);
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
enum Route { FMA_F32 = 0, MMA_M16 = 1, MMA_M16_MASKED = 2, MMA_M64_MASKED = 3, WGMMA = 4 };

// Launches on `stream` and returns 0 when the launch was accepted, else the
// CUDA error of the launch or, on the wgmma route, a tensor-map error
// (NO_ENCODER, TENSOR_MAP_ERROR + CUresult).  c is [batch, M, N] in the
// inputs' type.  Shapes, strides and each route's conditions (type, M,
// alignment) are checked by the Python wrapper.
extern "C" int gemm_fwd(const void* a, const void* b, void* c, int route, int batch, int M, int N, int K,
                        long long sab, long long sam, long long sbb, long long sbk, long long scb, long long scm,
                        void* stream) {
  const GemmShape p{M, N, K, sab, sam, sbb, sbk, scb, scm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  bf16* cb = static_cast<bf16*>(c);
  switch (route) {
    case FMA_F32:
      return launch_f32(static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), batch,
                        p, st);
    case MMA_M16: return launch_mma<16, 128, 1, 4, true>(ab, bb, cb, batch, p, st);
    case MMA_M16_MASKED: return launch_mma<16, 128, 1, 4, false>(ab, bb, cb, batch, p, st);
    case MMA_M64_MASKED: return launch_mma<64, 256, 2, 4, false>(ab, bb, cb, batch, p, st);
    case WGMMA: return launch_wgmma(ab, bb, cb, batch, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
