// The streaming pass over a list of tensors shared by the multi-tensor
// kernels (adam_update.cu, finite_check.cu): the plan of the list that
// travels in a kernel's parameters, the search for a CTA's share of it,
// and the element conversions.
//
// A launch covers up to kMaxTensors tensors (none empty). Tensor i owns
// CTAs [first_chunk[i], first_chunk[i + 1]) of kChunk elements each, so
// the grid is first_chunk[n] CTAs of kThreads threads, and each CTA finds
// its tensor by a binary search over the first chunks (the same for every
// thread of the CTA). The plan sits in a `__grid_constant__` table with
// the kernel's pointers, read in place from the constant bank, so a CUDA
// graph capture records it by value and nothing is uploaded per launch.
// Each thread moves kVec elements at a time, as one vector access where
// the tensor's flags say every pointer of it allows one (kAligned), element
// by element otherwise and at the tail.
//
// The wrappers (kernels/adam_update.py `plan_args`) build the same plan
// and check kChunk and kMaxTensors through each library's size queries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace mt {

constexpr int kMaxTensors = 512;
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kChunk = 16384;   // elements a CTA; a multiple of kVec

// bit 1 of a tensor's flags: its pointers allow kVec-element accesses (bit
// 0 is left to the kernel)
constexpr unsigned char kAligned = 2;

struct Plan {
  long long numel[kMaxTensors];
  int first_chunk[kMaxTensors + 1];
  unsigned char flags[kMaxTensors];
  int n;
};

// Copy the caller's plan; false where it is not one (no tensor, too many,
// no CTA).
inline bool fill_plan(Plan& plan, int n, const long long* numel,
                      const int* first_chunk, const unsigned char* flags) {
  if (n <= 0 || n > kMaxTensors || first_chunk[n] <= 0) return false;
  plan.n = n;
  for (int i = 0; i < n; ++i) {
    plan.numel[i] = numel[i];
    plan.first_chunk[i] = first_chunk[i];
    plan.flags[i] = flags[i];
  }
  plan.first_chunk[n] = first_chunk[n];
  return true;
}

// this CTA's tensor and its element range [start, end)
struct Span {
  int i;
  long long start, end;
};

__device__ __forceinline__ Span span_of(const Plan& plan) {
  const int chunk = blockIdx.x;
  int lo = 0, hi = plan.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (plan.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const long long numel = plan.numel[lo];
  const long long start =
      static_cast<long long>(chunk - plan.first_chunk[lo]) * kChunk;
  return {lo, start, start + kChunk < numel ? start + kChunk : numel};
}

// kVec elements of T, moved as one access
template <typename T>
struct alignas(kVec * sizeof(T)) Vec {
  T v[kVec];
};

// An element in the type its arithmetic runs in (fp32; double stays
// double), and back, rounding to nearest even.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ double narrow<double>(float x) { return x; }
// double's arithmetic stays double: only narrow<double> takes one
template <typename T>
__device__ __forceinline__ T narrow(double x);
template <>
__device__ __forceinline__ double narrow<double>(double x) { return x; }

}  // namespace mt
