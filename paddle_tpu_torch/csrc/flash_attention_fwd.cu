// FlashAttention-2 forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (driven by
// `_flash_fwd`), the Pallas TPU kernel behind F.scaled_dot_product_attention.
// Computes O = softmax(scale * Q K^T [top-left causal mask]) V and the fp32
// per-row logsumexp over q, k, v laid out [B, N, H, D] (any strides with a
// contiguous last dim, so the q/k/v slices of the fused qkv projection are
// read in place), O written contiguous [B, N, H, D] in the input type, lse
// [B*H, N] fp32.
//
// What bounds it on an H100: at the serving prefill shape (B=1, N<=1024,
// H=12, D=64, bf16) the work is ~1.6 GFLOP and ~6 MB, a couple of
// microseconds at the card's peaks, so the kernel is bound by launch
// latency and by how well 12 heads x N/64 tiles fill 132 SMs. This first
// version does its products in fp32 FMA (no wgmma/TMA): the design keeps
// every tile product in shared memory and registers so nothing of size
// N x N reaches device memory, and leaves the tensor-core path to a later
// change.
//
// Design:
//   * one thread block per (b*h, 64-row q tile): blocks carry nothing
//     across each other, so the TPU's sequential grid over k blocks
//     becomes a loop inside the block;
//   * 4 threads per q row (256 threads); each owns a quarter of the head
//     dimension (interleaved float4 chunks) of q and of the fp32
//     accumulator, and a 2-step shuffle sums the partial dot products;
//   * K/V stream through shared memory in 32-key tiles, converted to fp32
//     once on load; a tile's scores stay in registers; the running max,
//     sum and accumulator are fp32 and rescaled once per tile;
//   * top-left causal: the key loop stops at the tile's last row, and
//     keys past a row's position get probability exactly 0;
//   * ragged edges (N, M not multiples of 64/32) are masked here: rows past
//     N are computed but never stored, keys past M are zero-filled and
//     masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kLanes = 4;
constexpr int kThreads = kBlockQ * kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, int m, int heads,
                 int64_t q_sb, int64_t q_sn, int64_t q_sh,
                 int64_t k_sb, int64_t k_sn, int64_t k_sh,
                 int64_t v_sb, int64_t v_sn, int64_t v_sh, float scale) {
  // float4 chunks of the head dimension owned by one thread
  constexpr int kChunks = D / 4 / kLanes;
  __shared__ __align__(16) float k_tile[kBlockK][D];
  __shared__ __align__(16) float v_tile[kBlockK][D];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qi = q0 + row;
  const bool row_valid = qi < n;

  const T* q_row = q + b * q_sb + h * q_sh + static_cast<int64_t>(qi) * q_sn;
  const T* k_base = k + b * k_sb + h * k_sh;
  const T* v_base = v + b * v_sb + h * v_sh;

  // chunk c of this thread covers dims 4 * (lane + kLanes * c) .. +3
  float4 q_reg[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = 4 * (lane + kLanes * c);
    if (row_valid) {
      q_reg[c] = make_float4(to_float(q_row[d]) * scale,
                             to_float(q_row[d + 1]) * scale,
                             to_float(q_row[d + 2]) * scale,
                             to_float(q_row[d + 3]) * scale);
    } else {
      q_reg[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  // causal: no row of this tile attends past its last row
  const int kv_end = kCausal ? min(m, q0 + kBlockQ) : m;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < m) {
        kx = to_float(k_base[static_cast<int64_t>(kj) * k_sn + d]);
        vx = to_float(v_base[static_cast<int64_t>(kj) * v_sn + d]);
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kv4 = kr[lane + kLanes * c];
        part += q_reg[c].x * kv4.x + q_reg[c].y * kv4.y +
                q_reg[c].z * kv4.z + q_reg[c].w * kv4.w;
      }
      // the 4 threads of a row are adjacent lanes of one warp
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = kj < m && (!kCausal || kj <= qi);
      s[j] = ok ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      // masked keys contribute exactly 0, never exp(-1e30 - -1e30)
      const float p = s[j] > kNegInf ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vr[lane + kLanes * c];
        acc[c].x += p * vv.x;
        acc[c].y += p * vv.y;
        acc[c].z += p * vv.z;
        acc[c].w += p * vv.w;
      }
    }
    l_run = l_run * alpha + p_sum;
    m_run = m_new;
  }

  if (row_valid) {
    const float l_safe = fmaxf(l_run, 1e-30f);
    T* o_row = o + ((static_cast<int64_t>(b) * n + qi) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 4 * (lane + kLanes * c);
      store(o_row + d, acc[c].x / l_safe);
      store(o_row + d + 1, acc[c].y / l_safe);
      store(o_row + d + 2, acc[c].z / l_safe);
      store(o_row + d + 3, acc[c].w / l_safe);
    }
    if (lane == 0) {
      lse[static_cast<int64_t>(bh) * n + qi] = m_run + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n, int m, int heads,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * heads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  if (causal) {
    flash_fwd_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lp, n, m, heads, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale);
  } else {
    flash_fwd_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lp, n, m, heads, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (q: batch, seq, head), (k: ...), (v: ...). Returns a cudaError_t.
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n, int m, int heads, int head_dim,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float scale, int causal, int dtype, void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || heads <= 0 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) {
    err = launch<float, 64>(q, k, v, o, lse, batch, n, m, heads, st, scale,
                            causal, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch<float, 128>(q, k, v, o, lse, batch, n, m, heads, st, scale,
                             causal, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, n, m, heads, st,
                                    scale, causal, s);
  } else if (dtype == 1 && head_dim == 128) {
    err = launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, n, m, heads, st,
                                     scale, causal, s);
  }
  return static_cast<int>(err);
}
