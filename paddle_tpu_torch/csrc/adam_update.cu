// Multi-tensor Adam / AdamW update for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: no Pallas kernel. The reference jits its optimizer update over
// the whole parameter list and XLA fuses it (paddle_tpu/optimizer/
// optimizer.py `_apply_optimize`, the rule in paddle_tpu/optimizer/
// optimizers.py `Adam._adam_core` and `AdamW._single_update`). One launch
// here updates every tensor of a list, in the reference's fp32 formula:
//     m1  = b1 * m1 + (1 - b1) * g
//     m2  = b2 * m2 + (1 - b2) * g * g
//     base = master, or float(p) without one
//     AdamW, decaying tensors: base = base * (1 - lr * coeff), rounded to
//         p's type first where there is no master (the reference casts the
//         decayed base back to p's dtype before the Adam core)
//     lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
//     new = base - lr_t * m1 / (sqrt(m2) + eps)
//     master = new; p = new in p's type (round to nearest even)
// with lr and t (the step, as fp32) read from device memory at run time,
// so a CUDA graph replay sees the values the host set before it.
//
// What bounds it on an H100: bytes. Each element reads g, m1, m2 and the
// master (or p) and writes m1, m2, the master and p: 28 bytes for bf16 or
// f16 parameters with fp32 masters, 28 for fp32 parameters, 22 for bf16 or
// f16 without masters, against ~12 flops. GPT-2 124M's 124,475,904 elements are 3.49 GB,
// ~1.04 ms at 3.35 TB/s. So the design is one streaming pass:
//   * a table of the tensors (pointers, sizes, flags, the first chunk of
//     each) travels in the kernel's parameters (`__grid_constant__`, read
//     in place from the constant bank; up to kMaxTensors a launch, ~27 KB
//     of the 32 KB that CUDA 12.1+ allows), so a capture records it by
//     value and nothing is uploaded per launch;
//   * each CTA takes one fixed chunk of kChunk elements of one tensor,
//     found by a binary search over the first chunks (the same for every
//     thread of the CTA);
//   * each thread moves 4 elements at a time, with 16-byte (fp32) and
//     8-byte (bf16, f16) vector accesses where every pointer of the tensor is
//     aligned for them, element by element otherwise and at the tail;
//   * the bias corrections are computed once per thread from the device
//     scalars.
// The arithmetic is written with the _rn intrinsics, so nothing is
// contracted into an FMA: the kernel gives the plain PyTorch twin's values
// bit for bit (powf is the function PyTorch's pow calls).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 512;
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kChunk = 16384;   // elements a CTA; a multiple of kVec

constexpr unsigned char kDecay = 1;     // AdamW decay applies
constexpr unsigned char kAligned = 2;   // vector accesses are aligned

struct Table {
  void* param[kMaxTensors];
  const void* grad[kMaxTensors];
  float* m1[kMaxTensors];
  float* m2[kMaxTensors];
  float* master[kMaxTensors];    // nullptr: the tensor has no master
  long long numel[kMaxTensors];
  int first_chunk[kMaxTensors + 1];
  unsigned char flags[kMaxTensors];
  int n;
};

struct Consts {
  float b1, b2, omb1, omb2, eps, coeff;
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]);
  const float2 b = __bfloat1622float2(h2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
  h2[0] = __floats2bfloat162_rn(v[0], v[1]);
  h2[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
  const float2 a = __half22float2(h2[0]);
  const float2 b = __half22float2(h2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  uint2 raw;
  __half2* h2 = reinterpret_cast<__half2*>(&raw);
  h2[0] = __floats2half2_rn(v[0], v[1]);
  h2[1] = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// the step's per-launch scalars, from the device scalars lr and t
struct Step {
  float lr_t;    // lr * sqrt(1 - b2^t) / (1 - b1^t)
  float keep;    // 1 - lr * coeff
};

// one element: g in, m1 / m2 / w (the base in, the new value out) updated
template <typename T>
__device__ __forceinline__ void update(const Consts& c, const Step& s,
                                       float g, float& m1, float& m2,
                                       float& w, bool decay,
                                       bool has_master) {
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(__fmul_rn(c.omb2, g), g));
  float base = w;
  if (decay) {
    base = __fmul_rn(base, s.keep);
    if (!has_master) base = to_float(from_float<T>(base));
  }
  const float denom = __fadd_rn(__fsqrt_rn(m2), c.eps);
  w = __fsub_rn(base, __fdiv_rn(__fmul_rn(s.lr_t, m1), denom));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ Table tab,
                   const float* __restrict__ lr_ptr,
                   const float* __restrict__ t_ptr, const Consts c) {
  const int chunk = blockIdx.x;
  // the last tensor whose first chunk is at or before this one (empty
  // tensors are left out of the table by the caller)
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const long long numel = tab.numel[i];
  const long long start =
      static_cast<long long>(chunk - tab.first_chunk[i]) * kChunk;
  const long long end = start + kChunk < numel ? start + kChunk : numel;

  const float lr = *lr_ptr;
  const float t = *t_ptr;
  const float bc1 = __fsub_rn(1.f, powf(c.b1, t));
  const float bc2 = __fsub_rn(1.f, powf(c.b2, t));
  const Step s{__fdiv_rn(__fmul_rn(lr, __fsqrt_rn(bc2)), bc1),
               __fsub_rn(1.f, __fmul_rn(lr, c.coeff))};

  T* __restrict__ p = static_cast<T*>(tab.param[i]);
  const T* __restrict__ g = static_cast<const T*>(tab.grad[i]);
  float* __restrict__ m1 = tab.m1[i];
  float* __restrict__ m2 = tab.m2[i];
  float* __restrict__ master = tab.master[i];
  const bool has_master = master != nullptr;
  const bool decay = tab.flags[i] & kDecay;
  const bool vec = tab.flags[i] & kAligned;

  for (long long at = start + static_cast<long long>(threadIdx.x) * kVec;
       at < end; at += static_cast<long long>(kThreads) * kVec) {
    if (vec && at + kVec <= end) {
      float gv[4], a[4], b[4], w[4];
      load4(g + at, gv);
      load4(m1 + at, a);
      load4(m2 + at, b);
      if (has_master) load4(master + at, w); else load4(p + at, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        update<T>(c, s, gv[e], a[e], b[e], w[e], decay, has_master);
      }
      store4(m1 + at, a);
      store4(m2 + at, b);
      if (has_master) store4(master + at, w);
      store4(p + at, w);
    } else {
      const long long stop = at + kVec < end ? at + kVec : end;
      for (long long k = at; k < stop; ++k) {
        float a = m1[k], b = m2[k];
        float w = has_master ? master[k] : to_float(p[k]);
        update<T>(c, s, to_float(g[k]), a, b, w, decay, has_master);
        m1[k] = a;
        m2[k] = b;
        if (has_master) master[k] = w;
        p[k] = from_float<T>(w);
      }
    }
  }
}

}  // namespace

extern "C" int paddle_adam_update_max_tensors() { return kMaxTensors; }

extern "C" int paddle_adam_update_chunk() { return kChunk; }

// One launch over n tensors (1 <= n <= kMaxTensors, none empty). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16 (every param and grad; another code
// returns cudaErrorInvalidValue); m1, m2 and masters are
// fp32 of each tensor's numel, masters[i] null where tensor i has none.
// first_chunk has n + 1 entries: tensor i owns chunks [first_chunk[i],
// first_chunk[i + 1]) of kChunk elements. flags: bit 0 decay, bit 1
// aligned for vector accesses. lr and t: device fp32 scalars. Returns a
// cudaError_t.
extern "C" int paddle_adam_update(
    int n, void* const* params, const void* const* grads, float* const* m1,
    float* const* m2, float* const* masters, const long long* numel,
    const int* first_chunk, const unsigned char* flags, const float* lr,
    const float* t, float b1, float b2, float omb1, float omb2, float eps,
    float coeff, int dtype, void* stream) {
  if (n <= 0 || n > kMaxTensors || first_chunk[n] <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab;
  tab.n = n;
  for (int i = 0; i < n; ++i) {
    tab.param[i] = params[i];
    tab.grad[i] = grads[i];
    tab.m1[i] = m1[i];
    tab.m2[i] = m2[i];
    tab.master[i] = masters[i];
    tab.numel[i] = numel[i];
    tab.first_chunk[i] = first_chunk[i];
    tab.flags[i] = flags[i];
  }
  tab.first_chunk[n] = first_chunk[n];
  const Consts c{b1, b2, omb1, omb2, eps, coeff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(first_chunk[n]);
  if (dtype == 0) {
    adam_update_kernel<float><<<grid, kThreads, 0, s>>>(tab, lr, t, c);
  } else if (dtype == 1) {
    adam_update_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(tab, lr, t,
                                                                c);
  } else if (dtype == 2) {
    adam_update_kernel<__half><<<grid, kThreads, 0, s>>>(tab, lr, t, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
