// Batched GEMM C[e] = A[e] . B[e] (fp32 accumulator, output in the input type) for sm_90a.
//
// Replaces src/repro/kernels/gemm.py::gemm (the Pallas kernel _gemm_kernel):
// C[M, N] = A[M, K] . B[K, N] with the sum kept in fp32 and the result cast to
// a's type.  On the MoE path it is the three capacity-batched expert products
// of moe_ffn_local (einsums ecd,edf->ecf and ecf,efd->ecd), one launch for all
// experts: the expert is blockIdx.z and A, B and C carry a batch stride.  The
// 2-D gemm is the batch-1 case.  Ragged edges are masked here, where the
// Pallas wrapper pads copies of the inputs to whole tiles.
//
// Bound: at phi3.5-moe's prefill (16 experts x [320, 4096] . [4096, 6400],
// bf16) a call needs 268 GFLOP over 946 MB, so the H100 is about as much
// bound by operations (0.27 ms at 989 TFLOP/s) as by bytes (0.28 ms at
// 3.35 TB/s).  In decode (capacity 8) the same weights give 6.7 GFLOP over
// 842 MB: bound by bytes, 0.25 ms, every expert's weights read once a step.
//
// Design.  bf16 runs on the tensor cores through mma.sync m16n8k16 with fp32
// accumulators (the reference's semantics exactly): each block owns a BM x BN
// output tile, its warps a (BM/WM) x (BN/WN) sub-tile in registers; a K loop
// streams 32-deep A and B slices through a 4-stage ring in shared memory with
// cp.async (16-byte copies, zero-filled past the edges), and ldmatrix feeds
// the fragments (B transposed on the way, as it is stored k-major).  Rows are
// padded by 8 elements so the eight 16-byte rows an ldmatrix phase reads fall
// in distinct banks.  The tile is picked by M: decode's M = 8 takes 16 x 128
// tiles of 4 warps (a 128-row tile would waste 94% of its rows); larger M
// takes 64 x 256 tiles of 8 warps, each warp 32 x 64 (timed faster on the
// card at the MoE prefill shapes than 64 x 128, 128 x 128, 128 x 64 and
// 128 x 256 tiles, and M = 320 or 160 fills whole 64-row tiles).  Inputs
// whose rows are not 16-byte aligned (K or N not a multiple of 8) take the
// same ring filled by masked element loads.  fp32 runs on the FMA pipes, no
// TF32 (the reference's 2e-4 would not hold): 64 x 64 tiles, 256 threads,
// 4 x 4 outputs each.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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

template <bool VEC>
int dispatch_bf16(const bf16* a, const bf16* b, bf16* c, int batch, const GemmShape& p, cudaStream_t stream) {
  if (p.M <= 16) return launch_mma<16, 128, 1, 4, VEC>(a, b, c, batch, p, stream);
  return launch_mma<64, 256, 2, 4, VEC>(a, b, c, batch, p, stream);
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

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted).  dtype 0 is float32, 1 is bfloat16; c is [batch, M, N] in that
// type.  vec (bf16 only) says that K and N are multiples of 8 and every row
// of a, b and c is 16-byte aligned.  Shapes, strides and alignment are
// validated by the Python wrapper.
extern "C" int gemm_fwd(const void* a, const void* b, void* c, int dtype, int batch, int M, int N, int K,
                        long long sab, long long sam, long long sbb, long long sbk, long long scb, long long scm,
                        int vec, void* stream) {
  const GemmShape p{M, N, K, sab, sam, sbb, sbk, scb, scm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), batch,
                      p, st);
  if (dtype == 1) {
    const bf16* ab = static_cast<const bf16*>(a);
    const bf16* bb = static_cast<const bf16*>(b);
    bf16* cb = static_cast<bf16*>(c);
    return vec ? dispatch_bf16<true>(ab, bb, cb, batch, p, st) : dispatch_bf16<false>(ab, bb, cb, batch, p, st);
  }
  return (int)cudaErrorInvalidValue;
}
