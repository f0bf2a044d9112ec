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
// ~1.04 ms at 3.35 TB/s. So the design is one streaming pass, the one
// multi_tensor.cuh sets out (finite_check.cu runs it too):
//   * a table of the tensors (pointers, and the plan: sizes, flags, the
//     first chunk of each) travels in the kernel's parameters
//     (`__grid_constant__`; up to kMaxTensors a launch, ~27 KB of the
//     32 KB that CUDA 12.1+ allows);
//   * each CTA takes one fixed chunk of kChunk elements of one tensor;
//   * each thread moves 4 elements at a time, with 16-byte (fp32) and
//     8-byte (bf16, f16) vector accesses where every pointer of the tensor is
//     aligned for them, element by element otherwise and at the tail;
//   * the bias corrections are computed once per thread from the device
//     scalars.
// The arithmetic is written with the _rn intrinsics, so nothing is
// contracted into an FMA: the kernel gives the plain PyTorch twin's values
// bit for bit (powf is the function PyTorch's pow calls).
//
// The numeric guard (FLAGS_check_numerics; the reference's where(finite,
// new, old) over the whole step, paddle_tpu/optimizer/optimizer.py:131-197)
// takes two more forms of the same kernel, chosen by `mode`:
//   * probe (kProbe): each element's new m1, m2, master and p (rounded to
//     T) computed as the update computes them, nothing written; a CTA
//     whose g or new values hold a NaN or an inf ORs 1 into an int32
//     device flag (one __syncthreads_or, one atomicOr a CTA). Reads 14
//     bytes an element with bf16 params and fp32 masters: g, m1, m2 and
//     the master;
//   * apply (kApply): the update, except that each CTA reads the flag
//     first and returns when it is set.
// The caller zeroes the flag, launches every probe of the step (each dtype
// group, each kMaxTensors slice) and then every apply, so the predicate is
// one for the whole step. Why two passes: no grid barrier can keep 124M
// elements' new values in registers until the predicate is known.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

using mt::kMaxTensors;
using mt::kThreads;
using mt::kVec;
using mt::narrow;
using mt::widen;

constexpr unsigned char kDecay = 1;     // AdamW decay applies (flags bit 0)

constexpr int kPlain = 0;   // the update
constexpr int kProbe = 1;   // the new values' finiteness into the flag
constexpr int kApply = 2;   // the update where the flag is clear

struct Table {
  void* param[kMaxTensors];
  const void* grad[kMaxTensors];
  float* m1[kMaxTensors];
  float* m2[kMaxTensors];
  float* master[kMaxTensors];    // nullptr: the tensor has no master
  mt::Plan plan;
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
    if (!has_master) base = widen(narrow<T>(base));
  }
  const float denom = __fadd_rn(__fsqrt_rn(m2), c.eps);
  w = __fsub_rn(base, __fdiv_rn(__fmul_rn(s.lr_t, m1), denom));
}

// whether an element's gradient and new state are all finite: g, m1, m2,
// the master (where there is one) and p as it would be stored in T
template <typename T>
__device__ __forceinline__ bool all_finite(float g, float m1, float m2,
                                           float w, bool has_master) {
  return isfinite(g) && isfinite(m1) && isfinite(m2) &&
         (!has_master || isfinite(w)) && isfinite(widen(narrow<T>(w)));
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ Table tab,
                   const float* __restrict__ lr_ptr,
                   const float* __restrict__ t_ptr, const Consts c,
                   int* __restrict__ flag) {
  if (kMode == kApply && *flag) return;
  const mt::Span sp = mt::span_of(tab.plan);
  const int i = sp.i;
  const long long start = sp.start, end = sp.end;

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
  const bool decay = tab.plan.flags[i] & kDecay;
  const bool vec = tab.plan.flags[i] & mt::kAligned;

  bool bad = false;
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
        if (kMode == kProbe) {
          bad |= !all_finite<T>(gv[e], a[e], b[e], w[e], has_master);
        }
      }
      if (kMode != kProbe) {
        store4(m1 + at, a);
        store4(m2 + at, b);
        if (has_master) store4(master + at, w);
        store4(p + at, w);
      }
    } else {
      const long long stop = at + kVec < end ? at + kVec : end;
      for (long long k = at; k < stop; ++k) {
        float a = m1[k], b = m2[k];
        float w = has_master ? master[k] : widen(p[k]);
        const float gk = widen(g[k]);
        update<T>(c, s, gk, a, b, w, decay, has_master);
        if (kMode == kProbe) {
          bad |= !all_finite<T>(gk, a, b, w, has_master);
        } else {
          m1[k] = a;
          m2[k] = b;
          if (has_master) master[k] = w;
          p[k] = narrow<T>(w);
        }
      }
    }
  }
  if (kMode == kProbe) {
    // every thread of the CTA reaches this barrier: only kApply returns
    // early
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
  }
}

template <typename T>
void launch(int mode, dim3 grid, cudaStream_t s, const Table& tab,
            const float* lr, const float* t, const Consts& c, int* flag) {
  if (mode == kProbe) {
    adam_update_kernel<T, kProbe><<<grid, kThreads, 0, s>>>(tab, lr, t, c,
                                                           flag);
  } else if (mode == kApply) {
    adam_update_kernel<T, kApply><<<grid, kThreads, 0, s>>>(tab, lr, t, c,
                                                           flag);
  } else {
    adam_update_kernel<T, kPlain><<<grid, kThreads, 0, s>>>(tab, lr, t, c,
                                                           flag);
  }
}

}  // namespace

extern "C" int paddle_adam_update_max_tensors() { return kMaxTensors; }

extern "C" int paddle_adam_update_chunk() { return mt::kChunk; }

// One launch over n tensors (1 <= n <= kMaxTensors, none empty). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16 (every param and grad; another code
// returns cudaErrorInvalidValue); m1, m2 and masters are
// fp32 of each tensor's numel, masters[i] null where tensor i has none.
// first_chunk has n + 1 entries: tensor i owns chunks [first_chunk[i],
// first_chunk[i + 1]) of kChunk elements. flags: bit 0 decay, bit 1
// aligned for vector accesses. lr and t: device fp32 scalars. mode: 0 the
// update, 1 the probe, 2 the update gated on `flag` (an int32 device scalar,
// which modes 1 and 2 need and mode 0 ignores). Returns a cudaError_t.
extern "C" int paddle_adam_update(
    int n, void* const* params, const void* const* grads, float* const* m1,
    float* const* m2, float* const* masters, const long long* numel,
    const int* first_chunk, const unsigned char* flags, const float* lr,
    const float* t, float b1, float b2, float omb1, float omb2, float eps,
    float coeff, int mode, int* flag, int dtype, void* stream) {
  Table tab;
  if (mode < kPlain || mode > kApply || (mode != kPlain && flag == nullptr) ||
      !mt::fill_plan(tab.plan, n, numel, first_chunk, flags)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) {
    tab.param[i] = params[i];
    tab.grad[i] = grads[i];
    tab.m1[i] = m1[i];
    tab.m2[i] = m2[i];
    tab.master[i] = masters[i];
  }
  const Consts c{b1, b2, omb1, omb2, eps, coeff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(first_chunk[n]);
  if (dtype == 0) {
    launch<float>(mode, grid, s, tab, lr, t, c, flag);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(mode, grid, s, tab, lr, t, c, flag);
  } else if (dtype == 2) {
    launch<__half>(mode, grid, s, tab, lr, t, c, flag);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
