// Forward flash attention (online softmax, causal / sliding window, GQA) for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _flash_kernel).  Same function: q [B, H, S, D], k/v [B, KVH, S, D],
// q-head i reads kv-head i / (H / KVH) (the reference's (i % h) // group over
// the folded batch*heads axis), scores q.k / sqrt(D) with an optional causal
// mask, and the running max, normaliser and accumulator in fp32; p is
// rounded to the input type before P.V, as the Pallas kernel casts it to
// v.dtype.  Two things the Pallas kernel leaves to its caller are done here:
// a sliding window (key j visible to query i only if i - j < window, the mask
// of blocks._sdpa_chunk) and a ragged S (the edge tiles are masked; the
// reference's S % block assert is a TPU tiling limit, not part of the
// function).
//
// Bound: at the LM prefill shapes (granite-3-2b: B 4, H 32, KVH 8, S 512,
// D 64, bf16) the function needs ~2 GFLOP over ~21 MB, so the H100 is
// bound by bytes (6 us at 3.35 TB/s) well before the bf16 tensor rate.
// This kernel is the simple, right version: fp32 FMA on the SIMT pipes
// (fp32 inputs must not go through TF32, or the reference's 2e-4 fails), so
// it is bound by its own arithmetic, far above either bound.  The fast
// version (mma.sync / wgmma for bf16, TMA loads) is later work.
//
// Design: one block per (batch*q-head, 64-row q tile), 256 threads, each
// thread owning a 4 x 4 patch of the 64 x 64 score tile and 4 rows x D/16
// columns of the output.  The q tile and each 64-row K/V tile are staged in
// shared memory as fp32 (q and K transposed, so the score loop reads one
// float4 of each per step); P goes back through shared memory, transposed,
// for the P.V product.  Row max and row sum are reduced over the 16 threads
// of a row group with warp shuffles.  Causal tiles wholly above the diagonal
// and window tiles wholly before the window are never loaded.  Q tiles are
// scheduled heaviest first.  Strides are arguments: the model passes its
// [b, s, h, d] tensors as transposed views, with no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int PAD = 4;        // row padding that keeps float4 rows 16-byte aligned

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<unsigned*>(&lo) = u.x;
    *reinterpret_cast<unsigned*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

struct AttnShape {
  int B, H, KVH, S;
  long long sqb, sqh, sqs;  // element strides of q over batch, head, position (d is unit)
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int causal, window;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return 2 * D * (BQ + PAD) + BK * (D + PAD) + BK * (BQ + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, AttnShape p) {
  constexpr int LDT = BQ + PAD;  // row length of the transposed tiles
  constexpr int LDV = D + PAD;
  constexpr int V4 = D / 4;                    // 4-element vectors per row
  constexpr int VW = D >= 64 ? 4 : D / 16;     // output columns per vector (D 16: 1, D 32: 2)
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

  const T* qb = q + b * p.sqb + hq * p.sqh;
  const T* kb = k + b * p.skb + hk * p.skh;
  const T* vb = v + b * p.svb + hk * p.svh;
  T* ob = o + b * p.sob + hq * p.soh;

  for (int e = tid; e < BQ * V4; e += THREADS) {
    const int i = e / V4, d = (e % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + i < p.S) val = IO<T>::load4(qb + (long long)(q0 + i) * p.sqs + d);
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
        kv = IO<T>::load4(kb + (long long)(k0 + j) * p.sks + d);
        vv = IO<T>::load4(vb + (long long)(k0 + j) * p.svs + d);
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
        s[r][c] = IO<T>::round(pv);
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
    T* orow = ob + (long long)qi * p.sos;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) IO<T>::store(orow + g * 16 * VW + tx * VW + e, acc[r][g * VW + e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const AttnShape& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.S + BQ - 1) / BQ));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, const AttnShape& p,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, p, stream);
    case 32: return launch<T, 32>(q, k, v, o, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 when it was
// accepted).  dtype 0 is float32, 1 is bfloat16; o has q's shape and type.
// Shapes, strides and alignment are validated by the Python wrapper.
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
  if (dtype == 0) return dispatch_d<float>(D, q, k, v, o, p, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, q, k, v, o, p, st);
  return (int)cudaErrorInvalidValue;
}
