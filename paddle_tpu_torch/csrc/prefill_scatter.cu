// The prompt's K/V scatter into the paged pools, every layer in one launch,
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: no Pallas kernel. The reference's jitted prefill program calls
// paddle_tpu/serving/cache.py `scatter_prefill` (fp pools) and, with int8
// pools, paddle_tpu/quantization/kv_cache.py `quantize_scatter`, and XLA
// fuses those ops into the program. Token p < length of layer l goes to
// pool block block_row[p / bs], offset p % bs, of layer l's K and V pools:
//   * fp pools: the row is copied as it is (pool and rows of one type);
//   * int8 pools: each block of the row first gets scale 0 (a spare block
//     past length keeps 0); a block holding real tokens gets, per head,
//     s = max(amax over its tokens' values, SCALE_EPS), and each value
//     becomes clamp(rint(v * (127 / s)), -127, 127), with 127 / s one
//     correctly rounded division and the product one rounding (`_rn`
//     intrinsics, so nothing is contracted into an FMA); rintf rounds half
//     to even, as torch.round does. The plain twin
//     (kernels/prefill_scatter.py `prefill_scatter_reference`) gives the
//     same bytes.
// Null block 0 is never written: the twin routes padded tokens there, the
// kernel skips them, so the two agree on every block but 0. Offsets past
// length in the last block keep their old bytes, as in the twin.
//
// What bounds it on an H100: bytes. It reads each real token's K and V row
// of every layer once and writes it once (int8: writes a byte an element
// and a scale a block and head), against about 6 operations an element for
// int8. GPT-2 124M at a 1024-token prompt, bf16: 2 x 12 x 1024 x 768 x 2 B
// read and the same written, 75.5 MB, ~0.0225 ms at 3.35 TB/s. So the
// design is one streaming pass, no tensor cores and no TMA:
//   * one CTA of kThreads threads per (entry of the block row, layer, K or
//     V), so one launch covers every layer and both pools; the layers'
//     K and V pointers (the strided views of each layer's fused qkv
//     output, read in place) travel in the kernel's parameters
//     (`__grid_constant__`), so a CUDA graph capture records them by value;
//   * the block row and length are read from device memory when the kernel
//     runs, so a replay follows what the host staged before it;
//   * 16-byte vector loads (8 bf16 or 4 fp32 values, never across a head);
//   * int8: per-head amax into shared memory (the thread's max over its
//     column of the block, then one atomicMax on the float's bits, exact
//     for values >= 0, so the order does not matter), then a second pass
//     over the block's values (served from L1/L2) quantizes and stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 128;
constexpr int kMaxHeads = 256;
constexpr int kThreads = 128;
constexpr float kQmax = 127.f;
constexpr float kScaleEps = 1e-8f;   // quantization/kv_cache.py SCALE_EPS

struct Layers {
  const void* k[kMaxLayers];
  const void* v[kMaxLayers];
};

struct Geometry {
  long long row_stride;    // elements between two tokens of a layer's view
  long long pool_layer;    // elements between two layers of a pool
  int tokens;              // the bucket: rows of each layer's view
  int heads;
  int head_dim;
  int block_size;
  int num_blocks;
};

__device__ __forceinline__ void to_floats(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_floats(const uint4& raw, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ int8_t level(float x, float r) {
  const float q = rintf(__fmul_rn(x, r));
  return static_cast<int8_t>(fminf(fmaxf(q, -kQmax), kQmax));
}

__device__ __forceinline__ void store_levels(int8_t* dst, const float (&v)[8],
                                             float r) {
  uint2 out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = level(v[e], r);
  *reinterpret_cast<uint2*>(dst) = out;
}

__device__ __forceinline__ void store_levels(int8_t* dst, const float (&v)[4],
                                             float r) {
  uint32_t out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = level(v[e], r);
  *reinterpret_cast<uint32_t*>(dst) = out;
}

// T: the rows' type (float or __nv_bfloat16); kInt8: int8 pools + scales
template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
prefill_scatter_kernel(const __grid_constant__ Layers src, void* k_pool,
                       void* v_pool, float* k_scales, float* v_scales,
                       const int* __restrict__ block_row,
                       const int* __restrict__ length, const Geometry g) {
  constexpr int kVec = 16 / sizeof(T);
  const int entry = blockIdx.x;
  const int layer = blockIdx.y;
  const bool is_v = blockIdx.z;
  const int blk = block_row[entry];
  if (blk == 0) return;                      // null block: never written
  const int len = min(*length, g.tokens);
  const int first = entry * g.block_size;
  const int n = max(0, min(g.block_size, len - first));
  const int row = g.heads * g.head_dim;
  const int cols = row / kVec;               // vectors a token
  const T* s = static_cast<const T*>(is_v ? src.v[layer] : src.k[layer])
               + static_cast<long long>(first) * g.row_stride;
  const long long at = layer * g.pool_layer
                       + static_cast<long long>(blk) * g.block_size * row;

  if (!kInt8) {
    T* d = static_cast<T*>(is_v ? v_pool : k_pool) + at;
    for (int i = threadIdx.x; i < n * cols; i += kThreads) {
      const int t = i / cols, c = i - t * cols;
      *reinterpret_cast<uint4*>(d + static_cast<long long>(t) * row
                                + c * kVec) =
          *reinterpret_cast<const uint4*>(s + t * g.row_stride + c * kVec);
    }
    return;
  }

  float* scale = (is_v ? v_scales : k_scales)
                 + (static_cast<long long>(layer) * g.num_blocks + blk)
                       * g.heads;
  if (n == 0) {                              // a spare block of the row
    for (int h = threadIdx.x; h < g.heads; h += kThreads) scale[h] = 0.f;
    return;
  }
  __shared__ unsigned amax_bits[kMaxHeads];
  __shared__ float ratio[kMaxHeads];
  for (int h = threadIdx.x; h < g.heads; h += kThreads) amax_bits[h] = 0u;
  __syncthreads();
  const int head_cols = g.head_dim / kVec;   // vectors a head
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float m = 0.f;
    for (int t = 0; t < n; ++t) {
      float v[kVec];
      to_floats(*reinterpret_cast<const uint4*>(s + t * g.row_stride
                                                + c * kVec), v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    atomicMax(&amax_bits[c / head_cols], __float_as_uint(m));
  }
  __syncthreads();
  for (int h = threadIdx.x; h < g.heads; h += kThreads) {
    const float sc = fmaxf(__uint_as_float(amax_bits[h]), kScaleEps);
    scale[h] = sc;
    ratio[h] = __fdiv_rn(kQmax, sc);
  }
  __syncthreads();
  int8_t* d = static_cast<int8_t*>(is_v ? v_pool : k_pool) + at;
  for (int i = threadIdx.x; i < n * cols; i += kThreads) {
    const int t = i / cols, c = i - t * cols;
    float v[kVec];
    to_floats(*reinterpret_cast<const uint4*>(s + t * g.row_stride
                                              + c * kVec), v);
    store_levels(d + static_cast<long long>(t) * row + c * kVec, v,
                 ratio[c / head_cols]);
  }
}

template <typename T>
void launch(const Layers& src, void* k_pool, void* v_pool, float* k_scales,
            float* v_scales, const int* block_row, const int* length,
            const Geometry& g, int max_blocks, int layers, cudaStream_t s) {
  const dim3 grid(max_blocks, layers, 2);
  if (k_scales != nullptr) {
    prefill_scatter_kernel<T, true><<<grid, kThreads, 0, s>>>(
        src, k_pool, v_pool, k_scales, v_scales, block_row, length, g);
  } else {
    prefill_scatter_kernel<T, false><<<grid, kThreads, 0, s>>>(
        src, k_pool, v_pool, k_scales, v_scales, block_row, length, g);
  }
}

}  // namespace

extern "C" int paddle_prefill_scatter_max_layers() { return kMaxLayers; }

extern "C" int paddle_prefill_scatter_max_heads() { return kMaxHeads; }

// One launch over `layers` layers (1 <= layers <= kMaxLayers). k_src[l] /
// v_src[l]: layer l's [tokens, heads, head_dim] rows, row_stride elements
// apart, each row contiguous; 16-byte aligned bases and row strides, and
// head_dim a multiple of 16 bytes' worth of values. Pools: contiguous
// [layers, num_blocks, block_size, heads, head_dim], of the rows' type
// (k_scales null) or int8 with fp32 scales [layers, num_blocks, heads].
// block_row: max_blocks int32 on the device, max_blocks * block_size >=
// tokens; length: one int32 on the device. dtype: 0 = float32, 1 =
// bfloat16 (the rows). Returns a cudaError_t.
extern "C" int paddle_prefill_scatter(
    int layers, const void* const* k_src, const void* const* v_src,
    void* k_pool, void* v_pool, float* k_scales, float* v_scales,
    const int* block_row, const int* length, int max_blocks, int tokens,
    int heads, int head_dim, int block_size, int num_blocks,
    long long row_stride, int dtype, void* stream) {
  if (layers <= 0 || layers > kMaxLayers || heads <= 0 || heads > kMaxHeads
      || max_blocks <= 0 || (k_scales == nullptr) != (v_scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers src;
  for (int l = 0; l < layers; ++l) {
    src.k[l] = k_src[l];
    src.v[l] = v_src[l];
  }
  const Geometry g{row_stride,
                   static_cast<long long>(num_blocks) * block_size * heads
                       * head_dim,
                   tokens, heads, head_dim, block_size, num_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(src, k_pool, v_pool, k_scales, v_scales, block_row, length,
                  g, max_blocks, layers, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(src, k_pool, v_pool, k_scales, v_scales,
                          block_row, length, g, max_blocks, layers, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
