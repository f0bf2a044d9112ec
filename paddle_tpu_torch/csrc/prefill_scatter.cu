// The prompt's K/V scatter into the paged pools, every layer in one launch,
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: no Pallas kernel. The reference's jitted prefill program calls
// paddle_tpu/serving/cache.py `scatter_prefill` (fp pools) and, with int8
// pools, paddle_tpu/quantization/kv_cache.py `quantize_scatter`, and XLA
// fuses those ops into the program. Token p < length of layer l goes to
// pool block block_row[p / bs], offset p % bs, of layer l's K and V pools:
//   * fp pools: the row is copied as it is (pool and rows of one type),
//     or cast to the pools' type where they differ (an engine whose
//     kv_dtype is another float type than its model's; rows and pools
//     each fp32, bf16 or f16), as the reference's `.astype(k_pools.dtype)`
//     (cache.py:279-281): to fp32 (exact), then rounded to nearest even
//     into the pools' type (a value past 65504 becomes inf in f16 pools);
//     8 values a thread a step (one 16-byte side, two on the other);
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
//   * 16-byte vector loads (8 bf16 or f16, or 4 fp32 values, never across a
//     head);
//   * int8: each row byte is read once. Warp w takes heads w, w + 4, ...;
//     a head's n x head_dim values of the block are its lanes' vectors
//     (vector v of the head: token v / (head_dim / vec), lane v % 32),
//     up to kPV a lane (a power of two, at most 16, chosen at the launch
//     from block_size and head_dim), and a warp holds kRegs / kPV heads
//     at once in registers: every load of that batch is issued before the
//     first is used (GPT-2 124M, bf16, 16-token blocks: kPV = 4, each
//     warp's 3 heads in one batch, 12 vectors a lane). The head's amax
//     (bf16: on the packed pairs, exact) is the lanes' maxima folded by
//     shuffles (max is exact, so the order does not matter), then the
//     levels are computed from the registers and stored (f16: the amax
//     on packed f16 pairs, exact too): a product, a
//     clamp, and an add of 1.5 x 2^23 that rounds half to even, whose low
//     byte is the level. No shared memory and no barrier. A head of more
//     than 32 x 16 vectors (a block of 64 tokens of 128 bf16 values, say)
//     reads the vectors past the registers twice, for its amax and its
//     levels.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxLayers = 128;
constexpr int kMaxHeads = 256;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRegs = 12;            // int8: 16-byte vectors a lane holds
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

// a 16-byte vector of T (8 bf16 or f16, or 4 fp32 values) -> floats
template <typename T>
__device__ __forceinline__ void to_floats(const uint4& raw,
                                          float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f;
      if constexpr (std::is_same<T, __half>::value) {
        f = __half22float2(reinterpret_cast<const __half2*>(&raw)[i]);
      } else {
        f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&raw)[i]);
      }
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// four levels in a word: each x becomes clamp(rint(x * r), -127, 127).
// The product is one rounding (__fmul_rn, as the twin's); after the clamp,
// adding 1.5 x 2^23 rounds to an integer half to even (the sum's ulp is 1),
// as rintf does, and the sum's low byte is that integer's two's complement
__device__ __forceinline__ uint32_t levels4(float a, float b, float c,
                                            float d, float r) {
  auto level = [r](float x) {
    const float q = fminf(fmaxf(__fmul_rn(x, r), -kQmax), kQmax);
    return __float_as_uint(__fadd_rn(q, 12582912.f));
  };
  return __byte_perm(__byte_perm(level(a), level(b), 0x0040),
                     __byte_perm(level(c), level(d), 0x0040), 0x5410);
}

// the levels of a 16-byte vector of T, stored
template <typename T>
__device__ __forceinline__ void store_levels(int8_t* dst, const uint4& raw,
                                             float r) {
  float v[16 / sizeof(T)];
  to_floats<T>(raw, v);
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(levels4(v[0], v[1], v[2], v[3], r),
                   levels4(v[4], v[5], v[6], v[7], r));
  } else {
    *reinterpret_cast<uint32_t*>(dst) = levels4(v[0], v[1], v[2], v[3], r);
  }
}

// the largest |value| of a 16-byte vector, folded into m (bf16 and f16: on
// the packed pairs, exact, converted once by `amax_value`)
__device__ __forceinline__ void fold_amax(__nv_bfloat162& m,
                                          const uint4& raw) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) m = __hmax2(m, __habs2(h2[i]));
}

__device__ __forceinline__ void fold_amax(__half2& m, const uint4& raw) {
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) m = __hmax2(m, __habs2(h2[i]));
}

__device__ __forceinline__ void fold_amax(float& m, const uint4& raw) {
  float v[4];
  to_floats<float>(raw, v);
#pragma unroll
  for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(v[e]));
}

__device__ __forceinline__ float amax_value(const __nv_bfloat162& m) {
  return fmaxf(__low2float(m), __high2float(m));
}

__device__ __forceinline__ float amax_value(const __half2& m) {
  return fmaxf(__low2float(m), __high2float(m));
}

__device__ __forceinline__ float amax_value(float m) { return m; }

// the amax accumulator of rows of T, and its zero
template <typename T>
using AmaxAcc = typename std::conditional<
    std::is_same<T, __nv_bfloat16>::value, __nv_bfloat162,
    typename std::conditional<std::is_same<T, __half>::value, __half2,
                              float>::type>::type;

template <typename T>
__device__ __forceinline__ AmaxAcc<T> amax_zero() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat162_rn(0.f);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half2_rn(0.f);
  } else {
    return 0.f;
  }
}

// 8 values of a row (16-byte aligned) -> floats, and floats -> 8 values of
// a pool row, for the fp pools of another type (the cast's two sides)
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    to_floats<T>(*reinterpret_cast<const uint4*>(p), v);
  } else {
    float a[4], b[4];
    to_floats<float>(*reinterpret_cast<const uint4*>(p), a);
    to_floats<float>(*reinterpret_cast<const uint4*>(p + 4), b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = a[e];
      v[4 + e] = b[e];
    }
  }
}

template <typename P>
__device__ __forceinline__ void store8(P* p, const float (&v)[8]) {
  if constexpr (sizeof(P) == 2) {
    uint4 out;
    uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // .x (the lower address) from the first value; each rounded to
      // nearest even, as torch's .to(bfloat16) and .to(float16)
      if constexpr (std::is_same<P, __half>::value) {
        const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = out;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// one block of int8 pools: warp w quantizes heads w, w + kWarps, ..., kHB
// of them at a time from registers (kPV vectors a lane a head)
template <typename T, int kPV>
__device__ __forceinline__ void quantize_block(const T* s, int8_t* d,
                                               float* scale, int n,
                                               const Geometry& g) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHB = kRegs / kPV > 0 ? kRegs / kPV : 1;  // heads at once
  // the amax accumulator: packed bf16 or f16 pairs, or a float
  using Acc = AmaxAcc<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hv = g.head_dim / kVec;          // vectors of a head's row
  const int per_head = n * hv;               // vectors of a head's block
  const int row = g.heads * g.head_dim;
  // a lane's vectors of a head, v = lane + 32 j: token v / hv and column v
  // % hv, as offsets from the head's first value (the same for every head)
  int src_at[kPV], dst_at[kPV];
  {
    int t = lane / hv, c = lane - t * hv;
    const int dt = 32 / hv, dc = 32 - dt * hv;
#pragma unroll
    for (int j = 0; j < kPV; ++j) {
      src_at[j] = t * static_cast<int>(g.row_stride) + c * kVec;
      dst_at[j] = t * row + c * kVec;
      t += dt;
      c += dc;
      if (c >= hv) {
        c -= hv;
        ++t;
      }
    }
  }
  // past the registers (a head of more than 32 kPV vectors)
  auto src = [&](int h, int v) {
    const int t = v / hv, c = v - t * hv;
    return reinterpret_cast<const uint4*>(s + t * g.row_stride
                                          + h * g.head_dim + c * kVec);
  };
  auto dst = [&](int h, int v) {
    const int t = v / hv, c = v - t * hv;
    return d + static_cast<long long>(t) * row + h * g.head_dim + c * kVec;
  };
  for (int h0 = warp; h0 < g.heads; h0 += kWarps * kHB) {
    uint4 raw[kHB][kPV];
#pragma unroll
    for (int b = 0; b < kHB; ++b) {
      const int h = h0 + b * kWarps;
#pragma unroll
      for (int j = 0; j < kPV; ++j) {
        if (h < g.heads && lane + 32 * j < per_head) {
          raw[b][j] = *reinterpret_cast<const uint4*>(s + h * g.head_dim
                                                      + src_at[j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kHB; ++b) {
      const int h = h0 + b * kWarps;
      if (h >= g.heads) break;               // the same in every lane
      Acc acc = amax_zero<T>();
#pragma unroll
      for (int j = 0; j < kPV; ++j) {
        if (lane + 32 * j < per_head) fold_amax(acc, raw[b][j]);
      }
      for (int v = lane + 32 * kPV; v < per_head; v += 32) {
        fold_amax(acc, *src(h, v));
      }
      float m = amax_value(acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
      }
      const float sc = fmaxf(m, kScaleEps);
      const float r = __fdiv_rn(kQmax, sc);
      if (lane == 0) scale[h] = sc;
#pragma unroll
      for (int j = 0; j < kPV; ++j) {
        if (lane + 32 * j < per_head) {
          store_levels<T>(d + h * g.head_dim + dst_at[j], raw[b][j], r);
        }
      }
      for (int v = lane + 32 * kPV; v < per_head; v += 32) {
        store_levels<T>(dst(h, v), *src(h, v), r);
      }
    }
  }
}

// T: the rows' type (float, __nv_bfloat16 or __half); P: the pools' type
// (T, another of those three, or int8_t); kPV: 0 for fp pools, else int8 pools +
// scales with kPV vectors a lane a head
template <typename T, typename P, int kPV>
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
  const T* s = static_cast<const T*>(is_v ? src.v[layer] : src.k[layer])
               + static_cast<long long>(first) * g.row_stride;
  const long long at = layer * g.pool_layer
                       + static_cast<long long>(blk) * g.block_size * row;

  if constexpr (kPV == 0 && std::is_same<T, P>::value) {
    const int cols = row / kVec;             // vectors a token
    T* d = static_cast<T*>(is_v ? v_pool : k_pool) + at;
    for (int i = threadIdx.x; i < n * cols; i += kThreads) {
      const int t = i / cols, c = i - t * cols;
      *reinterpret_cast<uint4*>(d + static_cast<long long>(t) * row
                                + c * kVec) =
          *reinterpret_cast<const uint4*>(s + t * g.row_stride + c * kVec);
    }
  } else if constexpr (kPV == 0) {
    const int cols = row / 8;                // groups of 8 values a token
    P* d = static_cast<P*>(is_v ? v_pool : k_pool) + at;
    for (int i = threadIdx.x; i < n * cols; i += kThreads) {
      const int t = i / cols, c = i - t * cols;
      float v[8];
      load8(s + t * g.row_stride + c * 8, v);
      store8(d + static_cast<long long>(t) * row + c * 8, v);
    }
  } else {
    float* scale = (is_v ? v_scales : k_scales)
                   + (static_cast<long long>(layer) * g.num_blocks + blk)
                         * g.heads;
    if (n == 0) {                            // a spare block of the row
      for (int h = threadIdx.x; h < g.heads; h += kThreads) scale[h] = 0.f;
      return;
    }
    quantize_block<T, kPV>(s, static_cast<int8_t*>(is_v ? v_pool : k_pool)
                                  + at, scale, n, g);
  }
}

// pools: the fp pools' type code (0 float, 1 bf16, 2 f16) where it is not
// the rows', else -1 (pools of the rows' type, or int8 with scales)
template <typename T>
void launch(const Layers& src, void* k_pool, void* v_pool, float* k_scales,
            float* v_scales, const int* block_row, const int* length,
            const Geometry& g, int max_blocks, int layers, int pools,
            cudaStream_t s) {
  const dim3 grid(max_blocks, layers, 2);
  // int8: the fewest vectors a lane a head (a power of two) that hold a
  // full block's head, at most kRegs
  const int per_lane = (g.block_size * (g.head_dim / (16 / sizeof(T))) + 31)
                       / 32;
#define PADDLE_SCATTER(P, PV)                                               \
  prefill_scatter_kernel<T, P, PV><<<grid, kThreads, 0, s>>>(               \
      src, k_pool, v_pool, k_scales, v_scales, block_row, length, g)
  if (pools == 0) {
    PADDLE_SCATTER(float, 0);
  } else if (pools == 1) {
    PADDLE_SCATTER(__nv_bfloat16, 0);
  } else if (pools == 2) {
    PADDLE_SCATTER(__half, 0);
  } else if (k_scales == nullptr) {
    PADDLE_SCATTER(T, 0);
  } else if (per_lane <= 1) {
    PADDLE_SCATTER(int8_t, 1);
  } else if (per_lane <= 2) {
    PADDLE_SCATTER(int8_t, 2);
  } else if (per_lane <= 4) {
    PADDLE_SCATTER(int8_t, 4);
  } else if (per_lane <= 8) {
    PADDLE_SCATTER(int8_t, 8);
  } else {
    PADDLE_SCATTER(int8_t, 16);
  }
#undef PADDLE_SCATTER
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
// tokens; length: one int32 on the device. dtype: the rows' type r (0 =
// float32, 1 = bfloat16, 2 = float16) where the pools are of that type or
// int8; 3 + 3 p + r for fp pools of another float type p (same codes; cast
// on the write; heads x head_dim a multiple of 8). Another code returns
// cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int paddle_prefill_scatter(
    int layers, const void* const* k_src, const void* const* v_src,
    void* k_pool, void* v_pool, float* k_scales, float* v_scales,
    const int* block_row, const int* length, int max_blocks, int tokens,
    int heads, int head_dim, int block_size, int num_blocks,
    long long row_stride, int dtype, void* stream) {
  if (layers <= 0 || layers > kMaxLayers || heads <= 0 || heads > kMaxHeads
      || max_blocks <= 0 || (k_scales == nullptr) != (v_scales == nullptr)
      || static_cast<long long>(block_size) * row_stride > INT_MAX
      || static_cast<long long>(block_size) * heads * head_dim > INT_MAX) {
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
  if (dtype < 0 || dtype >= 12) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = dtype < 3 ? dtype : (dtype - 3) % 3;
  const int pools = dtype < 3 ? -1 : (dtype - 3) / 3;
  if (pools == rows ||
      (pools >= 0 && (k_scales != nullptr || (heads * head_dim) % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) {
    launch<float>(src, k_pool, v_pool, k_scales, v_scales, block_row, length,
                  g, max_blocks, layers, pools, s);
  } else if (rows == 1) {
    launch<__nv_bfloat16>(src, k_pool, v_pool, k_scales, v_scales,
                          block_row, length, g, max_blocks, layers, pools, s);
  } else {
    launch<__half>(src, k_pool, v_pool, k_scales, v_scales, block_row,
                   length, g, max_blocks, layers, pools, s);
  }
  return static_cast<int>(cudaGetLastError());
}
