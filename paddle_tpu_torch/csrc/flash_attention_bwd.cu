// FlashAttention-2 backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (driven by `_flash_bwd`), the Pallas TPU kernels behind the
// gradient of F.scaled_dot_product_attention. With S = scale * Q K^T (top-left
// causal mask), P = exp(S - lse) recomputed from the forward's fp32 lse, and
// Delta = rowsum(O * dO) (computed by the caller, as JAX's `_flash_bwd` does):
//   dS = P * (dO V^T - Delta) * scale,  dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// q, k, v and dO are [B, N, H, D] with any strides and a contiguous last dim
// (the q/k/v slices of the fused qkv projection and a reshaped dO are read in
// place); lse and Delta are [B*H, N] fp32; dQ, dK, dV are written contiguous
// [B, N, H, D] in the input type from fp32 accumulators.
//
// What bounds it on an H100: at the training shape (B=8, N=1024, H=12, D=64,
// bf16, causal) dQ does 6*D and dK/dV 8*D FLOPs per unmasked (query, key)
// pair, ~19 and ~26 GFLOP: ~0.02 and ~0.026 ms at the bf16 tensor-core
// peak, above the ~0.02 ms its ~63 MB of traffic takes. This first version
// does its products in fp32 FMA (no wgmma/TMA), so it is bound by the fp32
// FMA rate and the shuffles of its row dot products; the tensor-core path is
// later work.
//
// Design, as the TPU decomposition: two kernels and no atomics.
//   * dQ: one thread block per (b*h, tile of query rows). It loops over
//     32-key tiles of K and V (staged in shared memory as fp32) up to the
//     diagonal; each query row's dQ accumulates in registers.
//   * dK/dV: one thread block per (b*h, tile of key rows). It loops over
//     32-query tiles of Q, dO, lse and Delta from the diagonal down; each key
//     row's dK and dV accumulate in registers.
//   * A row is shared by D/16 adjacent lanes of a warp (4 for D=64, 8 for
//     D=128), each owning four interleaved float4 chunks of it, so a block
//     of 256 threads holds 64 or 32 rows; row dot products finish with a
//     2- or 3-step xor shuffle.
//   * Ragged edges (N, M not multiples of the tiles) are masked here: rows
//     past the end are zero-filled and their probability is exactly 0.
//     Q is pre-scaled by `scale` as in the forward kernel, so S (and with it
//     P against the forward's lse) is computed the same way in both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;    // keys (dQ) or queries (dK/dV) per inner tile
constexpr int kChunks = 4;   // float4 chunks of a row owned by one thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Geometry {
  static constexpr int kLanes = D / (4 * kChunks);   // threads per row
  static constexpr int kRows = kThreads / kLanes;     // rows per block
};

// dims 4 * (lane + L * c) .. +3 of a row belong to chunk c of `lane`
template <int L, typename T>
__device__ __forceinline__ void load_row(float4 (&r)[kChunks], const T* row,
                                         int lane, bool valid, float mul) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = 4 * (lane + L * c);
    r[c] = valid ? make_float4(to_float(row[d]) * mul,
                               to_float(row[d + 1]) * mul,
                               to_float(row[d + 2]) * mul,
                               to_float(row[d + 3]) * mul)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int L, typename T>
__device__ __forceinline__ void store_row(T* row, const float4 (&r)[kChunks],
                                          int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = 4 * (lane + L * c);
    store(row + d, r[c].x);
    store(row + d + 1, r[c].y);
    store(row + d + 2, r[c].z);
    store(row + d + 3, r[c].w);
  }
}

// dot product of a register row with a shared-memory row, summed over the
// L adjacent lanes that share the row (all lanes of the warp take part)
template <int L>
__device__ __forceinline__ float row_dot(const float4 (&r)[kChunks],
                                         const float* srow, int lane) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = s4[lane + L * c];
    part += r[c].x * x.x + r[c].y * x.y + r[c].z * x.z + r[c].w * x.w;
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
  }
  return part;
}

template <int L>
__device__ __forceinline__ void row_axpy(float4 (&acc)[kChunks], float a,
                                         const float* srow, int lane) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = s4[lane + L * c];
    acc[c].x += a * x.x;
    acc[c].y += a * x.y;
    acc[c].z += a * x.z;
    acc[c].w += a * x.w;
  }
}

struct Strides {
  int64_t q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, g_b, g_n, g_h;
};

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n, int m, int heads, Strides st, float scale) {
  constexpr int L = Geometry<D>::kLanes;
  constexpr int R = Geometry<D>::kRows;
  __shared__ __align__(16) float k_tile[kTile][D];
  __shared__ __align__(16) float v_tile[kTile][D];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * R;
  const int lane = threadIdx.x % L;
  const int qi = q0 + threadIdx.x / L;
  const bool row_valid = qi < n;

  float4 q_reg[kChunks], g_reg[kChunks], acc[kChunks];
  load_row<L>(q_reg, q + b * st.q_b + h * st.q_h + int64_t(qi) * st.q_n,
              lane, row_valid, scale);
  load_row<L>(g_reg, g + b * st.g_b + h * st.g_h + int64_t(qi) * st.g_n,
              lane, row_valid, 1.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse_i = row_valid ? lse[int64_t(bh) * n + qi] : 0.f;
  const float delta_i = row_valid ? delta[int64_t(bh) * n + qi] : 0.f;

  const T* k_base = k + b * st.k_b + h * st.k_h;
  const T* v_base = v + b * st.v_b + h * st.v_h;
  // causal: no row of this tile attends past its last row
  const int kv_end = kCausal ? min(m, q0 + R) : m;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < m) {
        kx = to_float(k_base[int64_t(kj) * st.k_n + d]);
        vx = to_float(v_base[int64_t(kj) * st.v_n + d]);
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float s = row_dot<L>(q_reg, k_tile[j], lane);
      const float dp = row_dot<L>(g_reg, v_tile[j], lane);
      const int kj = k0 + j;
      const bool ok = row_valid && kj < m && (!kCausal || kj <= qi);
      const float p = ok ? expf(s - lse_i) : 0.f;
      row_axpy<L>(acc, p * (dp - delta_i) * scale, k_tile[j], lane);
    }
  }
  if (row_valid) {
    store_row<L>(dq + ((int64_t(b) * n + qi) * heads + h) * D, acc, lane);
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int m, int heads, Strides st,
                     float scale) {
  constexpr int L = Geometry<D>::kLanes;
  constexpr int R = Geometry<D>::kRows;
  __shared__ __align__(16) float q_tile[kTile][D];   // pre-scaled by `scale`
  __shared__ __align__(16) float g_tile[kTile][D];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * R;
  const int lane = threadIdx.x % L;
  const int kj = k0 + threadIdx.x / L;
  const bool row_valid = kj < m;

  float4 k_reg[kChunks], v_reg[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  load_row<L>(k_reg, k + b * st.k_b + h * st.k_h + int64_t(kj) * st.k_n,
              lane, row_valid, 1.f);
  load_row<L>(v_reg, v + b * st.v_b + h * st.v_h + int64_t(kj) * st.v_n,
              lane, row_valid, 1.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const T* q_base = q + b * st.q_b + h * st.q_h;
  const T* g_base = g + b * st.g_b + h * st.g_h;
  const float* lse_row = lse + int64_t(bh) * n;
  const float* delta_row = delta + int64_t(bh) * n;
  // causal (n == m): no query row above this tile's first key attends to it;
  // k0 is a multiple of R, itself a multiple of kTile
  const int q_begin = kCausal ? k0 : 0;
  for (int q0 = q_begin; q0 < n; q0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
      const int i = idx / D;
      const int d = idx - i * D;
      const int qi = q0 + i;
      float qx = 0.f, gx = 0.f;
      if (qi < n) {
        qx = to_float(q_base[int64_t(qi) * st.q_n + d]) * scale;
        gx = to_float(g_base[int64_t(qi) * st.g_n + d]);
      }
      q_tile[i][d] = qx;
      g_tile[i][d] = gx;
    }
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < n ? lse_row[qi] : 0.f;
      delta_tile[threadIdx.x] = qi < n ? delta_row[qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float s = row_dot<L>(k_reg, q_tile[i], lane);
      const float dp = row_dot<L>(v_reg, g_tile[i], lane);
      const int qi = q0 + i;
      const bool ok = row_valid && qi < n && (!kCausal || qi >= kj);
      const float p = ok ? expf(s - lse_tile[i]) : 0.f;
      row_axpy<L>(dv_acc, p, g_tile[i], lane);
      // q_tile holds scale * q, so this adds P (dP - Delta) scale q
      row_axpy<L>(dk_acc, p * (dp - delta_tile[i]), q_tile[i], lane);
    }
  }
  if (row_valid) {
    const int64_t off = ((int64_t(b) * m + kj) * heads + h) * D;
    store_row<L>(dk + off, dk_acc, lane);
    store_row<L>(dv + off, dv_acc, lane);
  }
}

template <typename T, int D>
cudaError_t launch(bool dkv, const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* out0, void* out1, int batch, int n, int m, int heads,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int R = Geometry<D>::kRows;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  if (dkv) {
    const dim3 grid((m + R - 1) / R, batch * heads);
    if (causal) {
      flash_bwd_dkv_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, o1, n, m, heads, st, scale);
    } else {
      flash_bwd_dkv_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, o1, n, m, heads, st, scale);
    }
  } else {
    const dim3 grid((n + R - 1) / R, batch * heads);
    if (causal) {
      flash_bwd_dq_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, n, m, heads, st, scale);
    } else {
      flash_bwd_dq_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, n, m, heads, st, scale);
    }
  }
  return cudaGetLastError();
}

int dispatch(bool dkv, const void* q, const void* k, const void* v,
             const void* g, const void* lse, const void* delta, void* out0,
             void* out1, int batch, int n, int m, int heads, int head_dim,
             const long long* s, float scale, int causal, int dtype,
             void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || heads <= 0 ||
      batch * heads > 65535 || (causal && n != m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) {
    err = launch<float, 64>(dkv, q, k, v, g, lse, delta, out0, out1, batch,
                            n, m, heads, st, scale, causal, cs);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch<float, 128>(dkv, q, k, v, g, lse, delta, out0, out1, batch,
                             n, m, heads, st, scale, causal, cs);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch<__nv_bfloat16, 64>(dkv, q, k, v, g, lse, delta, out0, out1,
                                    batch, n, m, heads, st, scale, causal,
                                    cs);
  } else if (dtype == 1 && head_dim == 128) {
    err = launch<__nv_bfloat16, 128>(dkv, q, k, v, g, lse, delta, out0, out1,
                                     batch, n, m, heads, st, scale, causal,
                                     cs);
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 12 element strides in
// the order (q: batch, seq, head), (k: ...), (v: ...), (dO: ...). lse and
// delta are contiguous [batch*heads, n] fp32. Returns a cudaError_t.
extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, int batch, int n, int m,
    int heads, int head_dim, const long long* strides, float scale,
    int causal, int dtype, void* stream) {
  return dispatch(false, q, k, v, g, lse, delta, dq, nullptr, batch, n, m,
                  heads, head_dim, strides, scale, causal, dtype, stream);
}

extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int n,
    int m, int heads, int head_dim, const long long* strides, float scale,
    int causal, int dtype, void* stream) {
  return dispatch(true, q, k, v, g, lse, delta, dk, dv, batch, n, m, heads,
                  head_dim, strides, scale, causal, dtype, stream);
}
