// Batched low-rank adapter delta for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces no TPU kernel: the reference computes the multi-tenant adapter
// delta with XLA einsums inside its compiled decode and prefill programs
// (paddle_tpu/serving/tenancy.py `_adapter_forward`). In the port those
// programs are CUDA graphs, and the same arithmetic as PyTorch ops (a gather
// of A, a bmm, a gather of B, a bmm, a multiply, an add) would add about six
// launches per projection to a decode replay that launch latency already
// bounds. So the delta is one launch per projection, in place on the
// projection's output y [N, out]:
//
//     for every row n with s = idx[n * idx_stride] != 0:
//       t = round_T(x[n, :] @ A[s, layer])            (A [K, L, in, r])
//       d = round_T(round_T(t @ B[s, layer]) * round_T(scale[s]))
//       y[n, :] = round_T(y[n, :] + d)                (B [K, L, r, out])
//
// with fp32 sums and round_T the rounding to the model's type (bf16 or
// fp32), where the plain twin `lora_delta_reference` and the reference
// round. Rows of slot 0 (the base adapter, all zeros) are not touched, so
// a base tenant stays bit for bit with an adapter-free engine. At decode
// idx is the slots' adapter index (stride 1); at prefill every row is one
// request's, so idx is one device scalar read with stride 0.
//
// What bounds it on an H100: launch latency. At decode (8 rows, in 768,
// out 2304, rank 16, bf16) the bytes are x, y twice and the factors of the
// distinct non-zero adapters, ~0.3 MB, ~0.09 us at 3.35 TB/s; a launch
// costs microseconds. So the design is the simple one: one CTA of 256
// threads per row; the x row staged in shared memory as fp32; warp w
// reduces the dot products t[r] for r = w, w + 8, ... (lanes stride over
// in, then a shuffle tree: a fixed order, so the result is deterministic);
// t[r] held in shared memory, so any rank works; then each thread takes
// output columns o = tid, tid + 256, ... (B's rows read coalesced) and
// writes y in place. A slot-0 row's CTA exits before loading anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the rounding the twin's dtype casts make
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_delta_kernel(T* __restrict__ y, const T* __restrict__ x,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ scale,
                  const int* __restrict__ idx, int in, int out, int rank,
                  int layer, int num_layers, int64_t y_stride,
                  int64_t x_stride, int64_t idx_stride) {
  extern __shared__ float smem[];
  float* xs = smem;          // [in]
  float* ts = smem + in;     // [rank]
  const int64_t n = blockIdx.x;
  const int slot = idx[n * idx_stride];
  if (slot == 0) return;     // the base adapter: y stays as it is
  const T* xr = x + n * x_stride;
  for (int i = threadIdx.x; i < in; i += kThreads) xs[i] = to_float(xr[i]);
  __syncthreads();
  const int64_t factor = static_cast<int64_t>(slot) * num_layers + layer;
  const T* A = a + factor * in * rank;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rank; r += kThreads / 32) {
    float acc = 0.f;
    for (int i = lane; i < in; i += 32) {
      acc = fmaf(xs[i], to_float(A[static_cast<int64_t>(i) * rank + r]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) ts[r] = round_to<T>(acc);
  }
  __syncthreads();
  const T* B = b + factor * rank * out;
  const float sc = round_to<T>(scale[slot]);
  T* yr = y + n * y_stride;
  for (int o = threadIdx.x; o < out; o += kThreads) {
    float u = 0.f;
    for (int r = 0; r < rank; ++r) {
      u = fmaf(ts[r], to_float(B[static_cast<int64_t>(r) * out + o]), u);
    }
    // _rn intrinsics: never contracted into an FMA, so each rounds once,
    // as the twin's separate multiply and add do
    const float d = round_to<T>(__fmul_rn(round_to<T>(u), sc));
    yr[o] = from_float<T>(__fadd_rn(to_float(yr[o]), d));
  }
}

template <typename T>
cudaError_t launch(void* y, const void* x, const void* a, const void* b,
                   const float* scale, const int* idx, int rows, int in,
                   int out, int rank, int layer, int num_layers,
                   int64_t y_stride, int64_t x_stride, int64_t idx_stride,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(in) + rank);
  lora_delta_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(x),
      static_cast<const T*>(a), static_cast<const T*>(b), scale, idx, in,
      out, rank, layer, num_layers, y_stride, x_stride, idx_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y, x, a and b). y [rows, out] and
// x [rows, in] with unit inner stride and row strides y_stride, x_stride
// (elements); a [K, num_layers, in, rank] and b [K, num_layers, rank, out]
// contiguous; scale [K] float32; idx int32, row n's slot at
// idx[n * idx_stride]. (in + rank) floats must fit in 48 KB of shared
// memory. Returns a cudaError_t.
extern "C" int paddle_lora_delta(void* y, const void* x, const void* a,
                                 const void* b, const void* scale,
                                 const void* idx, int rows, int in, int out,
                                 int rank, int layer, int num_layers,
                                 long long y_stride, long long x_stride,
                                 long long idx_stride, int dtype,
                                 void* stream) {
  if (rows <= 0 || in <= 0 || out <= 0 || rank <= 0 || layer < 0 ||
      layer >= num_layers ||
      sizeof(float) * (static_cast<size_t>(in) + rank) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(y, x, a, b, sc, ix, rows, in, out,
                                          rank, layer, num_layers, y_stride,
                                          x_stride, idx_stride, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(
        y, x, a, b, sc, ix, rows, in, out, rank, layer, num_layers, y_stride,
        x_stride, idx_stride, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
