// Mamba2 SSD chunk scan, emitting the output and the final state, for sm_90a.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel
// _ssd_kernel).  Same function, in the Pallas kernel's fp32 chunk
// arithmetic: for each (batch b, head h) and chunk of CL steps, with
// la = dt * A[h], cum = cumsum(la) and xdt = x * dt,
//   y     = (C.B^T o L) . xdt + exp(cum) * (C . state^T),  L[l,s] = exp(cum_l - cum_s) for l >= s
//   state = state * exp(cum_last) + (exp(cum_last - cum) * xdt)^T . B
// with x [b, l, h, p], dt [b, l, h] fp32, A [h] fp32 and B, C [b, l, n]
// shared by every head.  The Pallas kernel keeps the state in VMEM across a
// sequential chunk grid and drops it at the end; here it is written out as
// final_state [b, h, p, n] fp32, which the LM prefill hands to decode.
//
// Bound: at the mamba2-130m prefill shape (b 4, l 512, 24 heads of 64,
// state 128, chunk 64, bf16) the function needs ~1.5 GFLOP over ~14 MB:
// bytes bound the H100 (4 us at 3.35 TB/s).  This kernel is the simple,
// right version: fp32 FMA on the SIMT pipes over shared memory, so it is
// bound by its own arithmetic and shared-memory traffic, far above either
// bound.  Tensor-core chunk products are later work.
//
// Design: one block per (b, h, p-tile of at most 64 rows of the state); the
// state's rows over p are independent.  A loop over chunks inside the block
// replaces the Pallas kernel's sequential grid axis, and the fp32 state tile
// (64 x 128 x 4 B = 32 KB) stays in shared memory across chunks, never in
// device memory.  Each chunk stages B, C and x*dt as fp32 in shared memory
// (B and C read straight from their [b, l, n] rows, never copied per head
// as the JAX wrapper does), forms the masked decay matrix C.B^T o L once,
// then the output tile and the state update.  Rows are padded to n + 1 so
// that threads walking consecutive rows hit distinct banks.  The block needs
// ~130 KB at the mamba2 shape: dynamic shared memory, raised with
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct SsdShape {
  int b, l, h, p, n, chunk, pt;  // pt: state rows (over p) per block
  long long sxb, sxl, sxh;       // element strides of x (p is unit)
  long long sdb, sdl, sdh;       // of dt
  long long sBb, sBl, sCb, sCl;  // of B and C (n is unit)
};

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
int launch(const void* x, const float* dt, const float* A, const void* B, const void* C, void* y,
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

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted).  dtype 0 is float32, 1 is bfloat16 (x, B, C and y); dt, A and
// state are float32.  y is contiguous [b, l, h, p], state contiguous
// [b, h, p, n].  Shapes and the shared-memory size are validated by the
// Python wrapper.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B, const void* C,
                            void* y, float* state, int dtype, int b, int l, int h, int p, int n, int chunk,
                            int pt, long long sxb, long long sxl, long long sxh, long long sdb, long long sdl,
                            long long sdh, long long sBb, long long sBl, long long sCb, long long sCl,
                            void* stream) {
  const SsdShape s{b, l, h, p, n, chunk, pt, sxb, sxl, sxh, sdb, sdl, sdh, sBb, sBl, sCb, sCl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, B, C, y, state, s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, s, st);
  return (int)cudaErrorInvalidValue;
}
