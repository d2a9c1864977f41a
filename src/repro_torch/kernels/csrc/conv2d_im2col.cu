// SAME-padded NHWC x HWIO convolution as an implicit GEMM, fp32, for sm_90a.
//
// Replaces src/repro/kernels/im2col_conv.py::conv2d_im2col (the Pallas
// kernel _conv_kernel), the paper's Im2Col+GEMM operator.  Same function:
// y[n, oh, ow, k] = sum_{r, s, c} x[n, oh*stride - pad_t + r,
// ow*stride - pad_l + s, c] * w[r, s, c, k], zero outside the image, with
// HO = ceil(H / stride) and the SAME padding split pad // 2 before, the rest
// after.
//
// Bound: operations, at every layer of full-width SynthNet (microbatch of 2,
// 67 TFLOP/s fp32 against 3.35 TB/s):
//   [2,220,220,3]   11x11x3->96  s4   0.42 GFLOP   116 FLOP/byte  0.0063 ms
//   [2,27,27,96]    5x5x96->256       1.79 GFLOP   397 FLOP/byte  0.0267 ms
//   [2,13,13,256]   3x3x256->384      0.60 GFLOP   136 FLOP/byte  0.0089 ms
//   [2,13,13,384]   3x3x384->384      0.90 GFLOP   141 FLOP/byte  0.0134 ms
//   [2,13,13,384]   3x3x384->256      0.60 GFLOP   136 FLOP/byte  0.0089 ms
//   [2,220,220,256] 11x11x256->96 s4  36.0 GFLOP   317 FLOP/byte  0.537 ms
// all far above the ridge of 20 FLOP/byte.  The kernel stays on the fp32 FMA
// pipes: TF32 (tensor cores) would break the reference's 3e-4 tolerance.
//
// Design.  The GEMM is M = N*HO*WO output pixels by K output channels,
// reduced over R*S*C.  A block of 256 threads owns a BM x BN output tile
// (BM 128 or 64, BN 128, 96 or 64), each thread a (BM/16) x (BN/16) register
// tile (8x8 down to 4x4 fp32 accumulators).  The patch matrix is never
// built: the A tile (BM pixels x 16 reduction terms) is gathered straight
// from the unpadded input, the padding and the ragged edges zero-filled by
// the copy's source size.
//   - The reduction is walked as (r, s, c) with counters carried from one
//     16-deep slice to the next (a carry when c passes C, another when s
//     passes S), so no division runs inside the loop.
//   - Copies go global -> shared with cp.async through a 4-stage ring, one
//     barrier a stage.  A thread fills slots of 4 consecutive floats: 4
//     reduction terms of one pixel, 4 output channels of one weight row.
//     Where C and K are multiples of 4 and x and w are 16-byte aligned, a
//     slot is one 16-byte copy; otherwise four 4-byte copies, each masked
//     on its own.  Both fill the same shared tiles, and the products read
//     them in the same order, so the two paths give the same bits.
//   - The A tile is pixel-major ([BM][16]): a thread reads its rows 4
//     reduction terms at a time as float4, the threads of a quarter warp
//     reading one address.  A thread's BN/16 columns sit in groups of 4
//     spread 64 apart (at BN 96: 4, and 2 beyond column 64), so a warp's B
//     reads are contiguous.
//   - Where the output tiles alone would leave SMs idle, the reduction is
//     split over blockIdx.z into contiguous ranges of whole slices.  Each
//     split writes an fp32 partial to a workspace [splits, M, K]; a second
//     kernel adds the partials in the order 0 .. splits-1 and writes y.
//     With one split the first kernel writes y itself.  No atomics, so a
//     shape always gives the same bits.
// The tile and the number of splits are chosen per shape on the host
// (kernels/im2col_conv.py::plan, from the shape and the SM count alone):
// first a block on every SM, then the least modelled time, which counts
// rounds of blocks an SM, each block's padded work at the tile's measured
// share of the FMA peak, and the split sum.  At SynthNet's shapes on 132 SMs
// (scripts/conv_probe.py times every other candidate):
//   11x11x3->96 s4:    128 x 96, 5 splits, 240 blocks, 4-byte copies (C = 3);
//                      96 columns: no padded column at K = 96
//   5x5x96->256:       128 x 128, 11 splits, 264 blocks (2 rounds of the
//                      largest tile, whose 8x8 sub-tile reaches the most)
//   3x3x256->384:      128 x 96, 11 splits, 132 blocks (one round; the 338
//   3x3x384->384:      output pixels fill 3 row tiles, the reduction of
//   3x3x384->256:      2304-3456 terms does the rest); 128 x 64 at K = 256
//   11x11x256->96 s4:  128 x 96, 11 splits, 528 blocks (4 rounds of 132)
// Unlike the Pallas kernel, which holds a whole padded image in VMEM per grid
// step, nothing here depends on the image fitting on chip.

#include <climits>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads over every tile
constexpr int BK = 16;        // reduction terms per slice (one ring stage)
constexpr int STAGES = 4;

struct ConvShape {
  int n, h, w, c;   // input
  int r, s, k;      // filter, output channels
  int stride;
  int ho, wo;       // output spatial
  int pad_t, pad_l; // SAME padding before
  int m, kr;        // GEMM rows (N*HO*WO) and reduction length (R*S*C)
};

// 4-byte global -> shared copy that reads src_bytes (0 or 4) and zero-fills the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM * BK + BK * BN) * (int)sizeof(float);
}

// Blocks of a tile an SM must hold at once.  The 128 x 128 tile's 64
// accumulators a thread need more than the 128 registers two blocks would
// leave each thread; the 128 x 96 tile is let use more too, which ran a
// little faster at SynthNet's 11x11 layer.
template <int BM, int BN>
constexpr int min_blocks() {
  return BM == 128 && BN >= 96 ? 1 : 2;
}

// Tile column of a thread's accumulator column j (tx: the thread's index
// across, 0..15).  Columns come in groups of 4 spread 64 apart, and at
// TN = 6 one group of 4 and one of 2 beyond column 64, so that the 16
// threads across read each group as one contiguous run.
template <int TN>
__device__ __forceinline__ int col_of(int j, int tx) {
  if constexpr (TN % 4 == 0) return (j / 4) * 64 + tx * 4 + j % 4;
  else return j < 4 ? tx * 4 + j : 64 + tx * 2 + (j - 4);
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, min_blocks<BM, BN>())
conv2d_im2col_kernel(const float* __restrict__ x, const float* __restrict__ wt, float* __restrict__ out,
                     ConvShape p, int n_slices, int splits) {
  constexpr int TM = BM / 16;                  // accumulator rows per thread
  constexpr int TN = BN / 16;                  // accumulator columns per thread
  // Each copy slot is 4 consecutive floats: one 16-byte copy, or four 4-byte ones.
  constexpr int A_RSTEP = THREADS / (BK / 4);  // rows between one thread's A slots
  constexpr int A_ROWS = BM / A_RSTEP;         // A rows one thread copies
  constexpr int B_NPR = BN / 4;                // slots along one B row
  constexpr int B_TOTAL = BK * B_NPR;
  constexpr int B_ITERS = (B_TOTAL + THREADS - 1) / THREADS;
  static_assert(TN % 4 == 0 ? BN == 64 * (TN / 4) : TN == 6, "column groups of col_of");
  static_assert(BM % A_RSTEP == 0, "whole A rows per thread");

  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                      // [STAGES][BM][BK]
  float* const Bs = smem + STAGES * BM * BK;   // [STAGES][BK][BN]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  // this split's slices: [z * n / splits, (z + 1) * n / splits), as plan() has them
  const int t_begin = (int)((long long)z * n_slices / splits);
  const int nt = (int)((long long)(z + 1) * n_slices / splits) - t_begin;

  // A gather: this thread copies reduction terms a_kofs .. a_kofs + 3 of
  // each slice for rows a_row0 + A_RSTEP * i.  Row geometry is fixed for the
  // whole loop.
  const int a_kofs = (tid % (BK / 4)) * 4;
  const int a_row0 = tid / (BK / 4);
  int a_base[A_ROWS];  // offset of pixel (ih0, iw0) of the row's image; may lie outside it
  int a_ih[A_ROWS];
  int a_iw[A_ROWS];
  const int hw_out = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + a_row0 + A_RSTEP * i;
    if (m < p.m) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int oh = rem / p.wo;
      const int ow = rem - oh * p.wo;
      a_ih[i] = oh * p.stride - p.pad_t;
      a_iw[i] = ow * p.stride - p.pad_l;
      a_base[i] = ((img * p.h + a_ih[i]) * p.w + a_iw[i]) * p.c;
    } else {
      a_ih[i] = INT_MIN / 2;  // every bounds check fails: the row reads zeros
      a_iw[i] = 0;
      a_base[i] = 0;
    }
  }
  // (r, s, c) of this thread's first reduction term and its offset
  // (r*W + s)*C + c, carried from slice to slice; the only divisions are
  // these, once.  One step to the next term: c + 1, carried into s at C and
  // into r at S; the offset grows by 1, and by (W - S)*C more when s wraps.
  int ak = t_begin * BK + a_kofs;
  int ac = ak % p.c;
  int as_ = (ak / p.c) % p.s;
  int ar = ak / p.c / p.s;
  int adelta = (ar * p.w + as_) * p.c + ac;
  const int a_row_wrap = (p.w - p.s) * p.c;

  auto load_slice = [&](int t, int stage) {
    float* as = As + stage * BM * BK + a_row0 * BK + a_kofs;
    if constexpr (VEC) {
      // C % 4 == 0: the 4 terms are 4 channels of one pixel
      const bool k_ok = ak < p.kr;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const int ih = a_ih[i] + ar;
        const int iw = a_iw[i] + as_;
        const bool ok = k_ok && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w;
        cp_async16(as + A_RSTEP * i * BK, ok ? x + a_base[i] + adelta : x, ok ? 16 : 0);
      }
    } else {
      int k = ak, c = ac, s = as_, r = ar, d = adelta;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const int ih = a_ih[i] + r;
          const int iw = a_iw[i] + s;
          const bool ok = k < p.kr && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w;
          cp_async4(as + A_RSTEP * i * BK + e, ok ? x + a_base[i] + d : x, ok ? 4 : 0);
        }
        ++k;
        ++d;
        if (++c == p.c) {
          c = 0;
          if (++s == p.s) {
            s = 0;
            ++r;
            d += a_row_wrap;
          }
        }
      }
    }
    ak += BK;
    ac += BK;
    adelta += BK;
    while (ac >= p.c) {  // at most one pass where C >= 16
      ac -= p.c;
      if (++as_ == p.s) {
        as_ = 0;
        ++ar;
        adelta += a_row_wrap;
      }
    }
    float* bs = Bs + stage * BK * BN;
#pragma unroll
    for (int j = 0; j < B_ITERS; ++j) {
      const int q = tid + THREADS * j;
      if (B_TOTAL % THREADS == 0 || q < B_TOTAL) {
        const int krow = q / B_NPR;
        const int ncol = (q - krow * B_NPR) * 4;
        const int kg = t * BK + krow;
        const float* src = wt + (size_t)kg * p.k + n0 + ncol;
        if constexpr (VEC) {
          const bool ok = kg < p.kr && n0 + ncol < p.k;  // K % 4 == 0: all 4 columns or none
          cp_async16(bs + krow * BN + ncol, ok ? src : wt, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = kg < p.kr && n0 + ncol + e < p.k;
            cp_async4(bs + krow * BN + ncol + e, ok ? src + e : wt, ok ? 4 : 0);
          }
        }
      }
    }
  };

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_slice(t_begin + st, st);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();  // slice t has landed (this thread's copies)
    __syncthreads();              // ... and everyone's; slice t - 1's stage is free
    if (t + STAGES - 1 < nt) load_slice(t_begin + t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* as = As + (t % STAGES) * BM * BK + ty * TM * BK;
    const float* bs = Bs + (t % STAGES) * BK * BN;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[TM];  // rows ty*TM + i, reduction terms kq .. kq + 3
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(as + i * BK + kq);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        float b[TN];
        const float* brow = bs + (kq + k4) * BN;
#pragma unroll
        for (int j = 0; j + 3 < TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(brow + col_of<TN>(j, tx));
          b[j] = v.x, b[j + 1] = v.y, b[j + 2] = v.z, b[j + 3] = v.w;
        }
        if constexpr (TN % 4 == 2) {
          const float2 v = *reinterpret_cast<const float2*>(brow + col_of<TN>(TN - 2, tx));
          b[TN - 2] = v.x, b[TN - 1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = k4 == 0 ? a[i].x : k4 == 1 ? a[i].y : k4 == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* o = out + (size_t)z * p.m * p.k;  // y itself when there is one split
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + col_of<TN>(j, tx);
      if (col < p.k) o[(size_t)m * p.k + col] = acc[i][j];
    }
  }
}

// y = sum of the splits' partials, added in the order 0 .. splits-1.
__global__ void __launch_bounds__(256)
conv_split_sum_kernel(const float* __restrict__ ws, float* __restrict__ y, long long mk, int splits) {
  const long long step = (long long)gridDim.x * blockDim.x;
  if (mk % 4 == 0) {
    const long long mk4 = mk / 4;
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mk4; i += step) {
      float4 a = w4[i];
      for (int s = 1; s < splits; ++s) {
        const float4 b = w4[s * mk4 + i];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      reinterpret_cast<float4*>(y)[i] = a;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mk; i += step) {
      float a = ws[i];
      for (int s = 1; s < splits; ++s) a += ws[s * mk + i];
      y[i] = a;
    }
  }
}

// Lets the kernel take its shared memory on the current device, once per
// device (two host threads may both set it; the value is the same).
template <int BM, int BN, bool VEC>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(conv2d_im2col_kernel<BM, BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<BM, BN>());
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int BM, int BN, bool VEC>
int launch_conv(const float* x, const float* w, float* out, const ConvShape& p, int n_slices, int splits,
                cudaStream_t stream) {
  const cudaError_t attr = allow_smem<BM, BN, VEC>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((p.m + BM - 1) / BM), (unsigned)((p.k + BN - 1) / BN), (unsigned)splits);
  conv2d_im2col_kernel<BM, BN, VEC><<<grid, THREADS, smem_bytes<BM, BN>(), stream>>>(x, w, out, p, n_slices, splits);
  return (int)cudaGetLastError();
}

template <int BM, int BN, bool VEC>
int occupancy() {
  const cudaError_t attr = allow_smem<BM, BN, VEC>();
  if (attr != cudaSuccess) return -(int)attr;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, conv2d_im2col_kernel<BM, BN, VEC>, THREADS, smem_bytes<BM, BN>());
  return err == cudaSuccess ? blocks : -(int)err;
}

// Calls F<BM, BN, VEC>() for the tile (bm, bn); cudaErrorInvalidValue for a tile not compiled.
#define CONV_TILES(F, ...)                                                          \
  switch (bm * 1000 + bn) {                                                        \
    case 128128: return vec ? F<128, 128, true>(__VA_ARGS__) : F<128, 128, false>(__VA_ARGS__); \
    case 128096: return vec ? F<128, 96, true>(__VA_ARGS__) : F<128, 96, false>(__VA_ARGS__);   \
    case 128064: return vec ? F<128, 64, true>(__VA_ARGS__) : F<128, 64, false>(__VA_ARGS__);   \
    case 64128: return vec ? F<64, 128, true>(__VA_ARGS__) : F<64, 128, false>(__VA_ARGS__);    \
    case 64096: return vec ? F<64, 96, true>(__VA_ARGS__) : F<64, 96, false>(__VA_ARGS__);      \
    case 64064: return vec ? F<64, 64, true>(__VA_ARGS__) : F<64, 64, false>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                                    \
  }

int launch_tile(int bm, int bn, bool vec, const float* x, const float* w, float* out, const ConvShape& p,
                int n_slices, int splits, cudaStream_t stream) {
  CONV_TILES(launch_conv, x, w, out, p, n_slices, splits, stream)
}

int occupancy_tile(int bm, int bn, bool vec) { CONV_TILES(occupancy, ) }

}  // namespace

// Launches the plan's kernels on `stream` and returns cudaGetLastError() of
// the launches (0 when both were accepted).  a holds 16 ints: the shape
// (N, H, W, C, R, S, K, stride, HO, WO, pad_t, pad_l) and the plan (BM, BN,
// 16-byte copies, splits).  With splits > 1 the partials go to ws ([splits,
// M, K] fp32, allocated by the caller on the same stream) and a second
// kernel sums them into y.  Shapes and plans are validated by the Python
// wrapper; every index into x, w and y fits in int32 because the wrapper
// rejects larger tensors.
extern "C" int conv2d_im2col_f32(const float* x, const float* w, float* y, float* ws, const int* a, void* stream) {
  const ConvShape p{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11],
                    a[0] * a[8] * a[9], a[4] * a[5] * a[3]};
  const int bm = a[12], bn = a[13], vec = a[14], splits = a[15];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_slices = (p.kr + BK - 1) / BK;
  int err = launch_tile(bm, bn, vec != 0, x, w, splits > 1 ? ws : y, p, n_slices, splits, st);
  if (err != 0 || splits == 1) return err;
  const long long mk = (long long)p.m * p.k;
  const long long items = mk % 4 == 0 ? mk / 4 : mk;
  const unsigned blocks = (unsigned)(items < 256LL * 1056 ? (items + 255) / 256 : 1056);
  conv_split_sum_kernel<<<blocks, 256, 0, st>>>(ws, y, mk, splits);
  return (int)cudaGetLastError();
}

// Blocks of the tile's kernel one SM holds at once on the current device, or
// minus a cudaError.
extern "C" int conv2d_im2col_occupancy(int bm, int bn, int vec) { return occupancy_tile(bm, bn, vec != 0); }
