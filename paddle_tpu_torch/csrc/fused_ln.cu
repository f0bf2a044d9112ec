// Fused bias + residual + LayerNorm for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: paddle_tpu/kernels/fused_ln.py `_kernel` (driven by `_run`), the
// TPU kernel of `incubate.nn.functional.fused_bias_dropout_residual_layer_norm`:
//     y = LayerNorm(x + bias + residual) * scale + shift
// for x, residual [R, d] and bias, scale, shift [d], with fp32 statistics
// whatever the input type and y in x's dtype.
//
// What bounds it on an H100: bytes. Each element is read twice (x and
// residual) and written once, with ~10 flops per element: at [8192, 768]
// bf16 that is 37.7 MB, ~11 us at 3.35 TB/s, and the flops are nothing.
// So the design reads every input byte once and keeps the row on chip
// between the statistics and the output, as the TPU kernel keeps its row
// block in VMEM.
//
// Design:
//   * one thread block per row (the TPU's row blocks become independent
//     blocks, so nothing carries between them and a ragged R needs no
//     padding); a block has T = min(1024, d/4) threads and each thread
//     holds N groups of 4 elements in registers (N = 1 for d <= 4096, so
//     d = 768 is 192 threads of one group each);
//   * a group is one 16-byte (fp32) or 8-byte (bf16, f16) load of x and of
//     residual, neighbouring threads on neighbouring groups;
//   * z = (x + bias) + residual in fp32, the row mean by a block
//     reduction (warp shuffles, then one warp over the warps' sums), then
//     the centred variance mean((z - mean)^2) over the HELD values (two
//     passes over registers, not over memory), rsqrtf(var + eps), the
//     affine terms and one store in x's dtype.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

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

__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
  const float2 a = __half22float2(h2[0]);
  const float2 b = __half22float2(h2[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
  h2[0] = __floats2bfloat162_rn(v[0], v[1]);
  h2[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  uint2 raw;
  __half2* h2 = reinterpret_cast<__half2*>(&raw);
  h2[0] = __floats2half2_rn(v[0], v[1]);
  h2[1] = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// sum of `v` over the block; every thread gets the total. `smem` holds 33
// floats and may be reused by the next call.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x / 32) ? smem[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) smem[32] = t;
  }
  __syncthreads();
  const float total = smem[32];
  __syncthreads();
  return total;
}

// T: the type of x, residual and out; A: the type of bias, scale and
// shift; N: groups of 4 elements per thread
template <typename T, typename A, int N>
__global__ void __launch_bounds__(kMaxThreads)
fused_ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const A* __restrict__ bias, const A* __restrict__ scale,
                const A* __restrict__ shift, T* __restrict__ out, int d,
                float eps) {
  __shared__ float smem[33];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const int groups = d / 4;
  float z[N][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    if (g < groups) {
      float xv[4], rv[4], bv[4];
      load4(x + base + 4 * g, xv);
      load4(res + base + 4 * g, rv);
      load4(bias + 4 * g, bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[i][e] = (xv[e] + bv[e]) + rv[e];
        sum += z[i][e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) z[i][e] = 0.f;
    }
  }
  const float mean = block_sum(sum, smem) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (threadIdx.x + i * blockDim.x < groups) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[i][e] -= mean;
        sq += z[i][e] * z[i][e];
      }
    }
  }
  const float var = block_sum(sq, smem) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    if (g < groups) {
      float sv[4], hv[4], y[4];
      load4(scale + 4 * g, sv);
      load4(shift + 4 * g, hv);
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = z[i][e] * rstd * sv[e] + hv[e];
      store4(out + base + 4 * g, y);
    }
  }
}

struct Args {
  const void* x;
  const void* res;
  const void* bias;
  const void* scale;
  const void* shift;
  void* out;
  int rows, d;
  float eps;
};

template <typename T, typename A, int N>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  fused_ln_kernel<T, A, N><<<a.rows, threads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const A*>(a.bias), static_cast<const A*>(a.scale),
      static_cast<const A*>(a.shift), static_cast<T*>(a.out), a.d, a.eps);
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t launch_groups(const Args& a, cudaStream_t stream) {
  const int groups = a.d / 4;
  const int threads = groups < kMaxThreads ? groups : kMaxThreads;
  const int per_thread = (groups + threads - 1) / threads;
  if (per_thread <= 1) return launch<T, A, 1>(a, threads, stream);
  if (per_thread <= 2) return launch<T, A, 2>(a, threads, stream);
  if (per_thread <= 4) return launch<T, A, 4>(a, threads, stream);
  if (per_thread <= 8) return launch<T, A, 8>(a, threads, stream);
  if (per_thread <= 16) return launch<T, A, 16>(a, threads, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_affine(const Args& a, int affine_dtype, cudaStream_t s) {
  switch (affine_dtype) {
    case 0: return launch_groups<T, float>(a, s);
    case 1: return launch_groups<T, __nv_bfloat16>(a, s);
    case 2: return launch_groups<T, __half>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, residual and out);
// affine_dtype the same for bias, scale and shift (another code returns
// cudaErrorInvalidValue). x, residual, out [rows, d] contiguous, bias /
// scale / shift [d]; d % 128 == 0 and d <= 65536. Returns a cudaError_t.
extern "C" int paddle_fused_ln(const void* x, const void* res,
                               const void* bias, const void* scale,
                               const void* shift, void* out, int rows, int d,
                               float eps, int dtype, int affine_dtype,
                               void* stream) {
  if (rows <= 0 || d <= 0 || d % 128 != 0 || d > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, res, bias, scale, shift, out, rows, d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_affine<float>(a, affine_dtype, s);
  } else if (dtype == 1) {
    err = launch_affine<__nv_bfloat16>(a, affine_dtype, s);
  } else if (dtype == 2) {
    err = launch_affine<__half>(a, affine_dtype, s);
  }
  return static_cast<int>(err);
}
