// Fused softmax cross-entropy for Hopper (sm_90a), plain C interface for
// ctypes: a forward and a backward kernel.
//
// Replaces: paddle_tpu/kernels/cross_entropy.py `_fwd_kernel` (driven by
// `_fwd`) and `_bwd_kernel` (driven by `_bwd`), the Pallas TPU kernels behind
// `fused_softmax_cross_entropy`. For logits x [R, V] (fp32, bf16 or f16, any
// row stride, contiguous rows) and int64 labels [R]:
//   forward:  lse[r] = log sum_c exp(x[r, c]),  loss[r] = lse[r] - x[r, label]
//             (fp32; a label outside [0, V) picks nothing: loss = lse);
//   backward: dx[r, c] = (exp(x[r, c] - lse[r]) - [c == label]) * g[r],
//             written contiguous [R, V] in the logits' type.
//
// What bounds it on an H100: both passes do a few operations per element
// and are bound by device memory. At the training shape (R = 8192,
// V = 50304, bf16) the forward reads 824 MB (~0.25 ms at 3.35 TB/s) and the
// backward reads and writes 824 MB each (~0.49 ms).
//
// Design:
//   * one thread block per row; the row is read with 16-byte loads (8 bf16
//     or f16, or 4 fp32 values a thread), neighbouring threads on neighbouring
//     addresses. The TPU kernel pads the vocabulary with -1e30 and rows to
//     128; here nothing is padded: a row's unaligned head and its tail past
//     the last whole vector are read one element at a time, so any V (50257,
//     3000) and any row stride work;
//   * forward: each thread keeps an online (max, sum of exp) over its
//     elements, rescaled once per vector; a warp-shuffle and shared-memory
//     merge of the 256 pairs gives the row's lse; one thread reads the
//     label's logit directly;
//   * backward: an elementwise pass; a row whose input and output are not
//     equally aligned takes the element-at-a-time path whole.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// one 16-byte vector of T, unpacked to / packed from fp32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // element 2i sits in the low half of word i (little-endian)
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&two);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<__half> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 two = __half22float2(h[i]);
      f[2 * i] = two.x;
      f[2 * i + 1] = two.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

// elements before `p` reaches a 16-byte boundary (at most the row length)
template <typename T>
__device__ __forceinline__ int aligned_head(const T* p, int v) {
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  return min(v, ((16 - misalign) & 15) / static_cast<int>(sizeof(T)));
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int v,
              int64_t row_stride) {
  using V = Vec<T>;
  constexpr int E = V::kElems;
  __shared__ float m_part[kWarps];
  __shared__ float s_part[kWarps];

  const int r = blockIdx.x;
  const T* x = logits + int64_t(r) * row_stride;
  float m = kNegInf, s = 0.f;

  const int head = aligned_head(x, v);
  const int nvec = (v - head) / E;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    merge(m, s, to_float(x[i]), 1.f);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float f[E];
    V::unpack(xv[i], f);
    float vmax = f[0];
#pragma unroll
    for (int e = 1; e < E; ++e) vmax = fmaxf(vmax, f[e]);
    if (vmax > m) {
      s *= expf(m - vmax);
      m = vmax;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s += expf(f[e] - m);
  }
  for (int i = head + nvec * E + threadIdx.x; i < v; i += kThreads) {
    merge(m, s, to_float(x[i]), 1.f);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    m_part[warp] = m;
    s_part[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) merge(m, s, m_part[w], s_part[w]);
    const float row_lse = m + logf(s);
    const int64_t label = labels[r];
    const float picked =
        (label >= 0 && label < v) ? to_float(x[label]) : 0.f;
    lse[r] = row_lse;
    loss[r] = row_lse - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int v, int64_t row_stride) {
  using V = Vec<T>;
  constexpr int E = V::kElems;
  const int r = blockIdx.x;
  const T* x = logits + int64_t(r) * row_stride;
  T* y = dlogits + int64_t(r) * v;
  const float row_lse = lse[r];
  const float gr = g[r];
  const int64_t label = labels[r];

  int head = aligned_head(x, v);
  if (aligned_head(y, v) != head) head = v;   // unequal alignment: no vectors
  const int nvec = (v - head) / E;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    store(y + i, (expf(to_float(x[i]) - row_lse) - (i == label ? 1.f : 0.f))
                     * gr);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float f[E];
    V::unpack(xv[i], f);
    const int c0 = head + i * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      f[e] = (expf(f[e] - row_lse) - (c0 + e == label ? 1.f : 0.f)) * gr;
    }
    yv[i] = V::pack(f);
  }
  for (int i = head + nvec * E + threadIdx.x; i < v; i += kThreads) {
    store(y + i, (expf(to_float(x[i]) - row_lse) - (i == label ? 1.f : 0.f))
                     * gr);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (another code returns
// cudaErrorInvalidValue). `row_stride` is the logits' row stride in
// elements (each row itself contiguous); labels are int64. loss and lse are
// fp32 whatever the logits' type. Returns a cudaError_t.
extern "C" int paddle_cross_entropy_fwd(const void* logits,
                                        const void* labels, void* loss,
                                        void* lse, int rows, int v,
                                        long long row_stride, int dtype,
                                        void* stream) {
  if (rows <= 0 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, lo, ls, v, row_stride);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, lo, ls, v,
        row_stride);
  } else if (dtype == 2) {
    ce_fwd_kernel<__half><<<rows, kThreads, 0, s>>>(
        static_cast<const __half*>(logits), lab, lo, ls, v, row_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g is the upstream gradient of the per-row loss, contiguous [rows] fp32;
// dlogits is contiguous [rows, v] in the logits' type.
extern "C" int paddle_cross_entropy_bwd(const void* logits,
                                        const void* labels, const void* lse,
                                        const void* g, void* dlogits,
                                        int rows, int v, long long row_stride,
                                        int dtype, void* stream) {
  if (rows <= 0 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0) {
    ce_bwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, ls, gp,
        static_cast<float*>(dlogits), v, row_stride);
  } else if (dtype == 1) {
    ce_bwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, ls, gp,
        static_cast<__nv_bfloat16*>(dlogits), v, row_stride);
  } else if (dtype == 2) {
    ce_bwd_kernel<__half><<<rows, kThreads, 0, s>>>(
        static_cast<const __half*>(logits), lab, ls, gp,
        static_cast<__half*>(dlogits), v, row_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
