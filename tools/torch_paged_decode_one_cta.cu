// The paged decode kernel as it stood before the split-K design (commit
// 3dd19f6): one CTA per (head, slot) walking the slot's whole context.
// Kept only so that tools/torch_paged_decode_variants.py can time it in
// turns with the current design (paddle_tpu_torch/csrc/paged_decode.cu);
// nothing of the package builds or calls it.
//
// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py `_decode_kernel`
// (driven by `pallas_paged_attention`), the TPU kernel of one serving decode
// step: each slot's single query token attends over its KV history, which
// lives in a block pool [num_blocks, block_size, H, D] addressed through the
// slot's block table [S, M]; position p of slot s sits at
// (table[s, p / bs], p % bs) and attends iff p <= lens[s].
//
// What bounds it on an H100: bytes. One decode step reads every cached K
// and V element of its layer once (S=8 slots x ~1024 positions x 12 heads x
// 64 dims x 2 B x 2 = ~25 MB a layer, ~7.5 us at 3.35 TB/s) and does ~2 FLOP
// per byte, far below the ~295 FLOP/B where the tensor cores would matter.
// So the design is about keeping enough loads in flight and reading only
// the bytes the softmax needs.
//
// Design:
//   * one thread block per (head, slot); the block loads its own table row
//     and length (there is no scalar prefetch on CUDA) and walks only the
//     positions 0..lens[s], i.e. table entries up to lens[s] / bs: the TPU
//     kernel visits all M entries and masks them, and skipping them gives
//     the same result because masked positions contribute exactly 0;
//   * a token's D-element row of one head is read by D/8 adjacent lanes, 8
//     elements (16 B for bf16) each, so a warp reads whole 128-byte rows;
//     256 threads hold 32 (D=64) or 16 (D=128) tokens, and each thread
//     issues the K and V loads of 4 tokens before it uses any, so a block
//     keeps 64-128 rows of K and of V in flight;
//   * scores q.k / sqrt(D) and the online softmax run in fp32; each token
//     group keeps its own running max, sum and accumulator, and the groups
//     merge through shared memory at the end (a split of the sequence
//     inside the block, no second kernel);
//   * an inactive slot arrives with lens 0 and a table row of null block 0:
//     it reads one position of block 0 and writes finite garbage that the
//     engine never reads.
//
// int8 pools (the `quantized=True` branch of `_decode_kernel`,
// quantization/kv_cache.py): pools are int8 with one fp32 scale per
// (pool block, head), `scales[num_blocks, H]`. Each lane reads its 8
// elements as 8 bytes (a 64-wide row is 64 bytes over 8 lanes) and
// dequantizes them in registers as `k * (scale * (1/127))`, the order the
// TPU kernel and the plain twin use; the scale is read once per token
// from `scales[table[p / bs] * H + h]`. Half the bytes of bf16 pools for
// the same softmax, so the bound halves; everything else is the fp path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;     // elements per lane per token
constexpr int kUnroll = 4;  // tokens per group whose loads are in flight
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[kVec]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// T: the type of q and out; P: the pools' type (T, or int8_t with the
// fp32 scales k_scales / v_scales [num_blocks, H], unused otherwise)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int heads, int max_blocks, int block_size, float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kGroup = D / kVec;             // lanes per token
  constexpr int kGroups = kThreads / kGroup;   // tokens per sweep
  __shared__ float m_part[kGroups];
  __shared__ float l_part[kGroups];
  __shared__ __align__(16) float acc_part[kGroups][D];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int len = max(lens[s], 0);
  const int last = min(len, max_blocks * block_size - 1);
  const int* table = tables + static_cast<int64_t>(s) * max_blocks;
  const int64_t tok_stride = static_cast<int64_t>(heads) * D;
  const int64_t blk_stride = static_cast<int64_t>(block_size) * tok_stride;
  const int64_t head_off = static_cast<int64_t>(h) * D + lane * kVec;

  float qv[kVec];
  load8(q + (static_cast<int64_t>(s) * heads + h) * D + lane * kVec, qv);
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] *= scale;

  float m_run = kNegInf;
  float l_run = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  // `base` is uniform over the block, so every lane runs the same trip
  // count and the shuffles below are convergent
  for (int base = 0; base <= last; base += kGroups * kUnroll) {
    float kx[kUnroll][kVec];
    float vx[kUnroll][kVec];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kGroups + g;
      valid[u] = p <= last;
      if (valid[u]) {
        const int blk = table[p / block_size];
        const int64_t off = blk * blk_stride + (p % block_size) * tok_stride +
                            head_off;
        load8(k_pool + off, kx[u]);
        load8(v_pool + off, vx[u]);
        if constexpr (kQuant) {
          // dequantize in the load: fp K/V exist only in registers
          const int64_t si = static_cast<int64_t>(blk) * heads + h;
          const float ks = k_scales[si] * (1.0f / 127.0f);
          const float vs = v_scales[si] * (1.0f / 127.0f);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kx[u][e] *= ks;
            vx[u][e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kx[u][e] = 0.f;
          vx[u][e] = 0.f;
        }
      }
    }
    float sc[kUnroll];
    float chunk_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) part += qv[e] * kx[u][e];
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      sc[u] = valid[u] ? part : kNegInf;
      chunk_max = fmaxf(chunk_max, sc[u]);
    }
    const float m_new = fmaxf(m_run, chunk_max);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // masked positions get probability exactly 0
      const float p = valid[u] ? expf(sc[u] - m_new) : 0.f;
      l_run += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += p * vx[u][e];
    }
    m_run = m_new;
  }

  // merge the token groups: O = sum_g acc_g e^(m_g - M) / sum_g l_g e^(m_g - M)
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc_part[g][lane * kVec + e] = acc[e];
  if (lane == 0) {
    m_part[g] = m_run;
    l_part[g] = l_run;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float m_all = kNegInf;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) m_all = fmaxf(m_all, m_part[i]);
    float l_all = 0.f;
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const float w = expf(m_part[i] - m_all);
      l_all += l_part[i] * w;
      o += acc_part[i][d] * w;
    }
    store(out + (static_cast<int64_t>(s) * heads + h) * D + d,
          o / fmaxf(l_all, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scales;
  const void* v_scales;
  const void* tables;
  const void* lens;
  void* out;
  int slots, heads, max_blocks, block_size;
  float scale;
};

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.heads, a.slots);
  paged_decode_kernel<T, P, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
      static_cast<const P*>(a.v_pool), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lens),
      static_cast<T*>(a.out), a.heads, a.max_blocks, a.block_size, a.scale);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_dim(const Args& a, int head_dim, cudaStream_t stream) {
  if (head_dim == 64) return launch<T, P, 64>(a, stream);
  if (head_dim == 128) return launch<T, P, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). quantized: 0 = pools of
// q's dtype (scales unused, may be null), 1 = int8 pools with fp32 scales
// [num_blocks, H]. q/out [S, H, D], pools [num_blocks, block_size, H, D],
// tables [S, M] int32, lens [S] int32 (the effective lengths: 0 for
// inactive slots). Returns a cudaError_t.
extern "C" int paddle_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scales,
                                   const void* v_scales, const void* tables,
                                   const void* lens, void* out, int slots,
                                   int heads, int head_dim, int max_blocks,
                                   int block_size, float scale, int dtype,
                                   int quantized, void* stream) {
  if (slots <= 0 || slots > 65535 || heads <= 0 || max_blocks <= 0 ||
      block_size <= 0 || (quantized && (!k_scales || !v_scales))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,     k_pool, v_pool, k_scales,   v_scales,   tables, lens,
               out,   slots,  heads,  max_blocks, block_size, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = quantized ? launch_dim<float, int8_t>(a, head_dim, s)
                    : launch_dim<float, float>(a, head_dim, s);
  } else if (dtype == 1) {
    err = quantized ? launch_dim<__nv_bfloat16, int8_t>(a, head_dim, s)
                    : launch_dim<__nv_bfloat16, __nv_bfloat16>(a, head_dim, s);
  }
  return static_cast<int>(err);
}
