// SAME-padded NHWC x HWIO convolution as an implicit GEMM, fp32, for sm_90a.
//
// Replaces src/repro/kernels/im2col_conv.py::conv2d_im2col (the Pallas
// kernel _conv_kernel), the paper's Im2Col+GEMM operator.  Same function:
// y[n, oh, ow, k] = sum_{r, s, c} x[n, oh*stride - pad_t + r,
// ow*stride - pad_l + s, c] * w[r, s, c, k], zero outside the image, with
// HO = ceil(H / stride) and the SAME padding split pad // 2 before, the rest
// after.
//
// Bound: operations.  At the shapes of full-width SynthNet the product does
// hundreds of FLOPs per byte it must move (ar1_conv1: 11x11x256 -> 96 over
// 55x55, 2R*S*C = 61952 FLOPs per output element), far above the fp32 ridge
// of the H100 (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The kernel runs
// on the fp32 FMA pipes, not the tensor cores, so that it keeps the
// reference's full fp32 arithmetic (TF32 would break its 3e-4 tolerance).
//
// Design: the GEMM is M = N*HO*WO output pixels by K output channels, reduced
// over R*S*C.  Each block owns a 128 x 64 output tile and walks the reduction
// in slices of 16.  The patch matrix is never built: each thread gathers its
// slice of the A tile straight from the input, computing the (r, s, c) of its
// reduction column once per slice and zero-filling the padding and the ragged
// edges by bounds checks, so no padded copy of the input exists.  Tiles are
// double-buffered in shared memory with a register prefetch of the next
// slice, and each thread accumulates an 8 x 4 sub-tile in fp32 registers.
// Unlike the Pallas kernel, which holds a whole padded image in VMEM per grid
// step, nothing here depends on the image fitting on chip.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction slice per pipeline step
constexpr int TM = 8;    // output rows per thread
constexpr int TN = 4;    // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_ROWS = THREADS / BK;            // rows of the A tile one pass of the block loads
constexpr int A_PER_THREAD = BM / A_ROWS;       // 8
constexpr int B_PER_THREAD = BK * BN / THREADS; // 4
constexpr int APAD = 4;  // keeps the transposed A stores off one bank, rows 16-byte aligned

static_assert(A_PER_THREAD == TM, "one A row per accumulator row keeps the indexing simple");

struct ConvShape {
  int n, h, w, c;   // input
  int r, s, k;      // filter, output channels
  int stride;
  int ho, wo;       // output spatial
  int pad_t, pad_l; // SAME padding before
};

__global__ void __launch_bounds__(THREADS)
conv2d_im2col_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     float* __restrict__ y, ConvShape p) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = p.n * p.ho * p.wo;
  const int KR = p.r * p.s * p.c;
  const int hw_out = p.ho * p.wo;

  // A gather: this thread owns reduction column a_k of every slice and rows
  // a_m + A_ROWS * i of the tile.  Row geometry is fixed for the whole loop.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int row_off[A_PER_THREAD];  // offset of the pixel (ih0, iw0) of the row's image
  int row_ih[A_PER_THREAD];
  int row_iw[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int m = m0 + a_m + A_ROWS * i;
    if (m < M) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int oh = rem / p.wo;
      const int ow = rem - oh * p.wo;
      row_ih[i] = oh * p.stride - p.pad_t;
      row_iw[i] = ow * p.stride - p.pad_l;
      row_off[i] = ((img * p.h + row_ih[i]) * p.w + row_iw[i]) * p.c;
    } else {
      row_ih[i] = INT_MIN / 2;  // every bounds check fails: the row reads zeros
      row_iw[i] = 0;
      row_off[i] = 0;
    }
  }

  // B load: column b_n of rows b_k + (THREADS / BN) * j of each slice.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_col_ok = n0 + b_n < p.k;

  const int ty = tid / (BN / TN);  // accumulator rows ty*TM ..
  const int tx = tid % (BN / TN);  // accumulator cols tx*TN ..

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float a_reg[A_PER_THREAD];
  float b_reg[B_PER_THREAD];

  auto load_slice = [&](int k0) {
    const int kk = k0 + a_k;
    if (kk < KR) {
      const int c = kk % p.c;
      const int rs = kk / p.c;
      const int s = rs % p.s;
      const int r = rs / p.s;
      const int delta = (r * p.w + s) * p.c + c;
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i) {
        const int ih = row_ih[i] + r;
        const int iw = row_iw[i] + s;
        const bool ok = (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w;
        a_reg[i] = ok ? __ldg(x + row_off[i] + delta) : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i) a_reg[i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) {
      const int kr = k0 + b_k + (THREADS / BN) * j;
      b_reg[j] = (b_col_ok && kr < KR) ? __ldg(wt + (size_t)kr * p.k + n0 + b_n) : 0.0f;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) As[buf][a_k][a_m + A_ROWS * i] = a_reg[i];
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) Bs[buf][b_k + (THREADS / BN) * j][b_n] = b_reg[j];
  };

  const int n_slices = (KR + BK - 1) / BK;
  load_slice(0);
  store_slice(0);
  __syncthreads();

  for (int t = 0; t < n_slices; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_slices) load_slice((t + 1) * BK);  // global loads in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (t + 1 < n_slices) store_slice(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < p.k) y[(size_t)m * p.k + col] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 when
// it was accepted).  Shapes are validated by the Python wrapper; every index
// the kernel forms fits in int32 because the wrapper rejects larger tensors.
extern "C" int conv2d_im2col_f32(const float* x, const float* w, float* y,
                                 int n, int h, int wd, int c, int r, int s, int k,
                                 int stride, int ho, int wo, int pad_t, int pad_l,
                                 void* stream) {
  const ConvShape p{n, h, wd, c, r, s, k, stride, ho, wo, pad_t, pad_l};
  const long long m = (long long)n * ho * wo;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((k + BN - 1) / BN));
  conv2d_im2col_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, w, y, p);
  return (int)cudaGetLastError();
}
