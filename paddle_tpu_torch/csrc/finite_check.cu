// Multi-tensor finite check (with an optional unscale) and guarded copy for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: no Pallas kernel. Under FLAGS_check_numerics the reference
// computes one all-finite predicate over a step's gradients and new state
// inside its jitted update and applies where(finite, new, old)
// (paddle_tpu/optimizer/optimizer.py:131-197, paddle_tpu/ops/guardian.py
// `finite_all`); its GradScaler sets found-inf from the gradients and
// multiplies them by 1 / scale (paddle_tpu/amp/grad_scaler.py:92-113,
// Paddle's check_finite_and_unscale op). XLA fuses both. Two kernels here:
//   * multi_tensor_finite_kernel<T, kUnscale>: ORs 1 into an int32 device
//     flag where any element of any tensor of the list is a NaN or an inf
//     (one __syncthreads_or and one atomicOr a CTA); with kUnscale it also
//     multiplies each element in place by an fp32 device scalar rounded to
//     T, in fp32 (in double for double), rounded to T (what PyTorch's
//     multi-tensor product by a tensor of T does), so the GradScaler's
//     found-inf and unscale are one pass;
//   * multi_tensor_copy_if_kernel<T>: dst[i] = src[i] for every tensor of
//     the list unless the flag is set; a CTA that finds it set returns at
//     once. The optimizers without a kernel of their own compute their new
//     state out of place under the guard, check it with the first kernel
//     and copy it in with this one.
//
// What bounds them on an H100: bytes. The check reads each element once
// (and writes it once with the unscale), the copy reads and writes each
// element once, against at most two operations an element. So the design
// is the streaming pass of multi_tensor.cuh, which adam_update.cu runs
// too. T is fp32, bf16, f16 or double (a float64 gradient or state).
// Only the elements' addresses matter, not their order, so a tensor of
// any layout whose elements are dense in memory (a transposed parameter's
// gradient) is passed by the start of its elements.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

using mt::kThreads;
using mt::kVec;

struct FiniteTable {
  void* data[mt::kMaxTensors];
  mt::Plan plan;
};

struct CopyTable {
  void* dst[mt::kMaxTensors];
  const void* src[mt::kMaxTensors];
  mt::Plan plan;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T, bool kUnscale>
__global__ void __launch_bounds__(kThreads)
multi_tensor_finite_kernel(const __grid_constant__ FiniteTable tab,
                           int* __restrict__ flag,
                           const float* __restrict__ scale_ptr) {
  const mt::Span sp = mt::span_of(tab.plan);
  T* __restrict__ x = static_cast<T*>(tab.data[sp.i]);
  const bool vec = tab.plan.flags[sp.i] & mt::kAligned;
  // the scale rounded to T, as the product by a tensor of T takes it, in
  // the type T's arithmetic runs in
  using A = decltype(mt::widen(T()));
  const A scale = kUnscale ? mt::widen(mt::narrow<T>(*scale_ptr)) : A(1);
  bool bad = false;
  for (long long at = sp.start + static_cast<long long>(threadIdx.x) * kVec;
       at < sp.end; at += static_cast<long long>(kThreads) * kVec) {
    if (vec && at + kVec <= sp.end) {
      mt::Vec<T> a = *reinterpret_cast<const mt::Vec<T>*>(x + at);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const A f = mt::widen(a.v[e]);
        bad |= !isfinite(f);
        if (kUnscale) a.v[e] = mt::narrow<T>(mul_rn(f, scale));
      }
      if (kUnscale) *reinterpret_cast<mt::Vec<T>*>(x + at) = a;
    } else {
      const long long stop = at + kVec < sp.end ? at + kVec : sp.end;
      for (long long k = at; k < stop; ++k) {
        const A f = mt::widen(x[k]);
        bad |= !isfinite(f);
        if (kUnscale) x[k] = mt::narrow<T>(mul_rn(f, scale));
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
multi_tensor_copy_if_kernel(const __grid_constant__ CopyTable tab,
                            const int* __restrict__ flag) {
  if (*flag) return;
  const mt::Span sp = mt::span_of(tab.plan);
  T* __restrict__ dst = static_cast<T*>(tab.dst[sp.i]);
  const T* __restrict__ src = static_cast<const T*>(tab.src[sp.i]);
  const bool vec = tab.plan.flags[sp.i] & mt::kAligned;
  for (long long at = sp.start + static_cast<long long>(threadIdx.x) * kVec;
       at < sp.end; at += static_cast<long long>(kThreads) * kVec) {
    if (vec && at + kVec <= sp.end) {
      *reinterpret_cast<mt::Vec<T>*>(dst + at) =
          *reinterpret_cast<const mt::Vec<T>*>(src + at);
    } else {
      const long long stop = at + kVec < sp.end ? at + kVec : sp.end;
      for (long long k = at; k < stop; ++k) dst[k] = src[k];
    }
  }
}

template <typename T>
void launch_finite(const FiniteTable& tab, int* flag, const float* scale,
                   cudaStream_t s) {
  const dim3 grid(tab.plan.first_chunk[tab.plan.n]);
  if (scale != nullptr) {
    multi_tensor_finite_kernel<T, true><<<grid, kThreads, 0, s>>>(tab, flag,
                                                                  scale);
  } else {
    multi_tensor_finite_kernel<T, false><<<grid, kThreads, 0, s>>>(tab, flag,
                                                                   scale);
  }
}

template <typename T>
void launch_copy_if(const CopyTable& tab, const int* flag, cudaStream_t s) {
  const dim3 grid(tab.plan.first_chunk[tab.plan.n]);
  multi_tensor_copy_if_kernel<T><<<grid, kThreads, 0, s>>>(tab, flag);
}

}  // namespace

extern "C" int paddle_finite_check_max_tensors() { return mt::kMaxTensors; }

extern "C" int paddle_finite_check_chunk() { return mt::kChunk; }

// One launch over n tensors of one type (1 <= n <= kMaxTensors, none
// empty), each given by the start of its elements in memory (any layout
// whose elements are dense: the work is elementwise). dtype: 0 float32, 1
// bfloat16, 2 float16, 4 float64 (another code returns
// cudaErrorInvalidValue). first_chunk has n + 1 entries: tensor i owns
// chunks [first_chunk[i], first_chunk[i + 1]) of kChunk elements. flags:
// mt::kAligned where the tensor's pointer allows 4-element vector
// accesses. flag: an int32 device scalar ORed with 1 where an element is
// not finite. scale: an fp32 device scalar every element is multiplied by
// in place, or null for none. Returns a cudaError_t.
extern "C" int paddle_multi_tensor_finite(
    int n, void* const* data, const long long* numel, const int* first_chunk,
    const unsigned char* flags, int* flag, const float* scale, int dtype,
    void* stream) {
  FiniteTable tab;
  if (flag == nullptr ||
      !mt::fill_plan(tab.plan, n, numel, first_chunk, flags)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) tab.data[i] = data[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_finite<float>(tab, flag, scale, s);
  } else if (dtype == 1) {
    launch_finite<__nv_bfloat16>(tab, flag, scale, s);
  } else if (dtype == 2) {
    launch_finite<__half>(tab, flag, scale, s);
  } else if (dtype == 4) {
    launch_finite<double>(tab, flag, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch copying src[i] into dst[i] (n pairs of one type, numel[i]
// elements each, laid out alike; the plan and the codes as above, a
// tensor's flags mt::kAligned where both pointers allow vector accesses)
// unless the int32 device scalar flag is set. Returns a cudaError_t.
extern "C" int paddle_multi_tensor_copy_if(
    int n, void* const* dst, const void* const* src, const long long* numel,
    const int* first_chunk, const unsigned char* flags, const int* flag,
    int dtype, void* stream) {
  CopyTable tab;
  if (flag == nullptr ||
      !mt::fill_plan(tab.plan, n, numel, first_chunk, flags)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) {
    tab.dst[i] = dst[i];
    tab.src[i] = src[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_copy_if<float>(tab, flag, s);
  } else if (dtype == 1) {
    launch_copy_if<__nv_bfloat16>(tab, flag, s);
  } else if (dtype == 2) {
    launch_copy_if<__half>(tab, flag, s);
  } else if (dtype == 4) {
    launch_copy_if<double>(tab, flag, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
