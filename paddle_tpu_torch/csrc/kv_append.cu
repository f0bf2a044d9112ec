// The decode step's KV append for Hopper (sm_90a), plain C interface for
// ctypes: one launch a layer writes this step's K and V of every active
// slot into the layer's paged pools, in place.
//
// Replaces: the write half of paddle_tpu/nn/functional/attention.py
// `paged_decode_attention` (:253-271): for fp pools
// `pool.at[write_block, write_off].set(new)`, and for int8 pools
// paddle_tpu/quantization/kv_cache.py:62 `quantize_block_write`. These are
// plain jnp ops in the reference, which XLA fuses into the one compiled
// decode step (there is no Pallas kernel); the port ran them as ~8 eager
// ops per layer (fp: the write positions' index arithmetic, two
// index_put_) or ~40 (int8: dequantize, insert, zero, amax, requantize,
// for each pool), each a launch.
//
// Slot s writes at position p = lens[s] of its block table: block
// tables[s, p / bs], offset p % bs. Inactive slots (active[s] == 0) write
// nothing. (The plain twin sends their garbage to null block 0 instead;
// block 0 is never read unmasked, so the two differ only there.) Active
// slots never share a write block: the engine gives each slot blocks of
// its own (the port has no prefix cache), so no two CTAs write one block.
//
// What bounds it on an H100: launches, then bytes. At S=8, H=12, D=64,
// bs=16 an fp launch moves 8 x 2 x 768 elements and an int8 launch reads
// and rewrites 8 x 2 x 12 blocks of 1 KB -- ~0.4 MB, ~0.1 us at 3.35 TB/s,
// against a few microseconds to launch a grid. So the design is one
// launch per layer for both pools, with the index arithmetic on the
// device, and simple loops.
//
// fp pools (`kv_append_kernel`): grid (slot, pool), 128 threads copy the
// slot's H x D row, read by the strides of the strided view the fused QKV
// projection gives (no copy before the launch).
//
// int8 pools (`kv_append_int8_kernel`): grid (head, pool, slot), one CTA
// per (slot, pool, head) rewrites its write block's bs x D levels and its
// scale, in the reference's order of operations so that levels and
// scales come out bit for bit as the twin's:
//   x = p < off ? level * (scale * c) : p == off ? new : 0, with
//       c = (float)(1.0 / 127.0), the fp32 value torch and jnp make of the
//       Python scalar 1.0 / QMAX;
//   new_sc = max(max |x|, (float)1e-8)  (a max is exact in any order);
//   r = 127.0f / new_sc, one correctly rounded division (this file is
//       built without --use_fast_math, so `/` is IEEE);
//   level = clamp(rintf(x * r), -127, 127)  (rintf rounds half to even,
//       as torch.round and jnp.round do).
// Two passes over the block (amax, then requantize) recompute x from the
// same levels with the same operations, so both passes see one x; a
// thread rewrites only the elements it read, after the CTA's barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr float kQmax = 127.0f;
constexpr float kInvQmax = static_cast<float>(1.0 / 127.0);
constexpr float kScaleEps = static_cast<float>(1e-8);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* k_new;       // [S, H, D] by the strides below
  const void* v_new;
  void* k_pool;            // [num_blocks, bs, H, D]
  void* v_pool;
  float* k_scales;         // [num_blocks, H] (int8 pools only)
  float* v_scales;
  const int* tables;       // [S, M]
  const int* lens;         // [S]
  const bool* active;      // [S]
  int64_t new_stride[2][3];  // (K, V) x (slot, head, dim), in elements
  int heads, head_dim, max_blocks, block_size, num_blocks;
};

// The slot's write block and offset, or false where it writes nothing: an
// inactive slot, or a position outside its table or the pool.
__device__ __forceinline__ bool write_target(const Args& a, int s, int* blk,
                                             int* off) {
  if (!a.active[s]) return false;
  const int len = a.lens[s];
  if (len < 0 || len / a.block_size >= a.max_blocks) return false;
  *blk = a.tables[static_cast<int64_t>(s) * a.max_blocks +
                  len / a.block_size];
  *off = len % a.block_size;
  return *blk >= 0 && *blk < a.num_blocks;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_append_kernel(const Args a) {
  const int s = blockIdx.x;
  const int pool = blockIdx.y;
  int blk, off;
  if (!write_target(a, s, &blk, &off)) return;
  const T* src = static_cast<const T*>(pool == 0 ? a.k_new : a.v_new);
  T* dst = static_cast<T*>(pool == 0 ? a.k_pool : a.v_pool);
  const int64_t* st = a.new_stride[pool];
  const int row = a.heads * a.head_dim;
  dst += (static_cast<int64_t>(blk) * a.block_size + off) * row;
  src += s * st[0];
  for (int e = threadIdx.x; e < row; e += kThreads) {
    const int h = e / a.head_dim;
    const int d = e % a.head_dim;
    dst[e] = src[h * st[1] + d * st[2]];
  }
}

__device__ __forceinline__ float block_max(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = v;
  __syncthreads();
  float m = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, smem[w]);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_append_int8_kernel(const Args a) {
  __shared__ float warp_max[kWarps];
  const int h = blockIdx.x;
  const int pool = blockIdx.y;
  const int s = blockIdx.z;
  int blk, off;
  if (!write_target(a, s, &blk, &off)) return;
  const T* src = static_cast<const T*>(pool == 0 ? a.k_new : a.v_new);
  int8_t* levels = static_cast<int8_t*>(pool == 0 ? a.k_pool : a.v_pool);
  float* scales = pool == 0 ? a.k_scales : a.v_scales;
  const int64_t* st = a.new_stride[pool];
  const int D = a.head_dim;
  const int n = a.block_size * D;
  // element (p, d) of this head's slice of the block sits at
  // ((blk * bs + p) * H + h) * D + d
  levels += static_cast<int64_t>(blk) * a.block_size * a.heads * D +
            static_cast<int64_t>(h) * D;
  src += s * st[0] + h * st[1];
  const float deq = scales[static_cast<int64_t>(blk) * a.heads + h] *
                    kInvQmax;

  auto value = [&](int e) -> float {
    const int p = e / D;
    const int d = e % D;
    if (p < off) {
      return static_cast<float>(levels[static_cast<int64_t>(p) * a.heads * D +
                                       d]) *
             deq;
    }
    return p == off ? to_float(src[d * st[2]]) : 0.f;
  };

  float amax = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    amax = fmaxf(amax, fabsf(value(e)));
  }
  // every thread has read its elements (and the old scale) before the
  // barrier inside block_max; the writes below come after it
  const float new_sc = fmaxf(block_max(amax, warp_max), kScaleEps);
  const float r = kQmax / new_sc;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float q = fminf(fmaxf(rintf(value(e) * r), -kQmax), kQmax);
    levels[static_cast<int64_t>(e / D) * a.heads * D + e % D] =
        static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) {
    scales[static_cast<int64_t>(blk) * a.heads + h] = new_sc;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int slots, int quantized,
                   cudaStream_t stream) {
  if (quantized) {
    kv_append_int8_kernel<T>
        <<<dim3(a.heads, 2, slots), kThreads, 0, stream>>>(a);
  } else {
    kv_append_kernel<T><<<dim3(slots, 2), kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of k_new and v_new (and of the
// pools when quantized == 0). quantized: 0 = pools of that type (scales
// unused, may be null), 1 = int8 pools with fp32 scales [num_blocks, H].
// k_new / v_new [S, H, D] at element strides new_strides = (K slot, K
// head, K dim, V slot, V head, V dim); pools [num_blocks, block_size, H,
// D], tables [S, M] int32, lens [S] int32, active [S] bool, all
// contiguous. Returns a cudaError_t.
extern "C" int paddle_kv_append(const void* k_new, const void* v_new,
                                void* k_pool, void* v_pool, void* k_scales,
                                void* v_scales, const void* tables,
                                const void* lens, const void* active,
                                const int64_t* new_strides, int slots,
                                int heads, int head_dim, int max_blocks,
                                int block_size, int num_blocks, int dtype,
                                int quantized, void* stream) {
  if (slots <= 0 || slots > 65535 || heads <= 0 || heads > 65535 ||
      head_dim <= 0 || max_blocks <= 0 || block_size <= 0 ||
      num_blocks <= 0 || (quantized && (!k_scales || !v_scales))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{k_new,
         v_new,
         k_pool,
         v_pool,
         static_cast<float*>(k_scales),
         static_cast<float*>(v_scales),
         static_cast<const int*>(tables),
         static_cast<const int*>(lens),
         static_cast<const bool*>(active),
         {},
         heads,
         head_dim,
         max_blocks,
         block_size,
         num_blocks};
  for (int i = 0; i < 6; ++i) a.new_stride[i / 3][i % 3] = new_strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch<float>(a, slots, quantized, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(a, slots, quantized, s);
  }
  return static_cast<int>(err);
}
