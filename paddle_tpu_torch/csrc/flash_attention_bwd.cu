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
// pair, ~19 and ~26 GFLOP: ~0.020 and ~0.026 ms at the 989 TFLOP/s bf16
// tensor-core peak, just above the ~0.019 and ~0.023 ms their bytes (each
// input read once, each output written once) take at 3.35 TB/s. So every
// product has to run on the tensor cores. Each 64 x 64 tile also takes 4096
// exponentials (16 a clock on an SM's MUFU pipe: 256 clocks) against 384
// (dQ) or 512 (dK/dV) clocks of its products at D = 64: the elementwise
// work is as large as the products, and the warpgroup's pipeline and the
// other CTAs on the SM have to hide it.
//
// Design, as the TPU decomposition: two kernels and no atomics, so the
// result is deterministic.
//
// bf16 and f16 at D = 64 (`flash_bwd_dq_kernel_wgmma<T>`,
// `flash_bwd_dkv_kernel_wgmma<T>`, one source, the element type T a
// template parameter; D = 128 has kernels of its own, below): one CTA
// per ((b, h), 64 rows) of one consumer warpgroup and one producer warp, as
// the forward. The producer issues TMA loads (the forward's 4-D tensor maps
// [D, H, N, B], 128-byte swizzle, 64 x 64 boxes; hopper_sm90.cuh) of the
// CTA's own tiles once and of the streamed tiles into a three-stage ring
// guarded by full and empty mbarriers.
//   * dQ: the CTA owns 64 query rows (Q and dO) and streams K/V tiles of 64
//     keys up to the diagonal, the longest q tiles first. Per tile, S = Q K^T
//     and dP = dO V^T are wgmma from shared memory (all K-major); P =
//     exp2(S * scale * log2 e - lse * log2 e), the P the forward's lse (a
//     natural log) was made from, and dS = P (dP - Delta) are computed on
//     the accumulator registers; dS is packed to T in place and is the
//     register A operand of dQ += dS K (K read MN-major from the same tile:
//     the forward's P V). dQ is scaled and stored from the accumulator.
//   * dK/dV: the CTA owns 64 key rows (K and V) and streams Q/dO tiles of 64
//     queries from the diagonal down, the longest key tiles first. It
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so that
//     P^T and dS^T come out in the register A-fragment layout: dV += P^T dO
//     and dK += dS^T Q are wgmma with A from registers and dO, Q read
//     MN-major from the tiles the first two products read K-major. lse and
//     Delta are indexed by column there: the producer warp stores the
//     tile's 64 values (lse already times log2 e) beside it in shared
//     memory, and its 32 lanes arrive on the tile's full barrier.
//   * Each warpgroup takes its tiles in sequence, and commits the tile's
//     two score products apart, so that P's exponentials run while the
//     second product (dP, or dP^T) is still on the tensor cores; the other
//     CTAs on the SM fill the rest. Pipelining across tiles (tile j's
//     scores issued with tile j-1's accumulating products) and a dV
//     product issued before dS^T was computed each lost on the card
//     (PERF.md section 6, tools/torch_flash_bwd_variants.py).
//   * Masking: TMA zero-fills rows past N or M, but a zero row still gives
//     P = exp(-lse) != 0, so probability is set to exactly 0 for keys past
//     M, queries past N and above the causal diagonal, on the diagonal tile
//     and the edge tiles only. dQ is stored for rows < N, dK/dV for rows
//     < M.
//   * P (for dV) and dS (for dQ and dK) are rounded to T as tensor-core
//     operands; the stated criteria for that are in
//     paddle_tpu_torch/kernels/flash_attention.py (FLASH_BWD_BF16_*,
//     FLASH_BWD_F16_*).
//   * f16 only: |dS / scale| = P |dP - Delta| <= |dP - Delta| passes f16's
//     largest value (65504) where dO is large (a GradScaler's loss scale
//     reaches dO) while dQ and dK still fit. So each accumulator row (a
//     query of dQ, a key of dK) keeps a power of two `ds_mul`, 1 until a
//     tile's |dS| of that row passes kDsMax (2^15): dS is multiplied by it
//     before the rounding, the row's accumulator is rescaled when it
//     drops, and the row's output is divided by it. Powers of two are
//     exact, so where no row passes kDsMax the result is that of the plain
//     rounding. The guard costs almost nothing while no factor drops: a
//     warp (16 whole rows) whose rows are all at factor 1 forms dS as
//     bf16 does, keeping each thread's largest |dS| on the way, and takes
//     one vote: is any value at least kF16Round (32760), that is, would
//     any round to 2^15 or more in f16 (a necessary condition of |dS| >
//     kDsMax)? Only then, and on every tile once one of its rows has
//     dropped its factor, does the warp take the row maxima and drop
//     factors (`fit_f16`); the dQ kernel folds the factors into the
//     product that forms dS. The outputs are those of the fit on every
//     tile, bit for bit. The test runs on the fp32 values before the
//     packing: a vote on the packed values has to hold both sets through
//     it, and that cost more registers than its shorter reduction saved
//     (tools/torch_flash_bwd_variants.py, `packed_test`). bf16 has
//     fp32's range and skips it.
//
// dK/dV at D = 128 (`flash_bwd_dkv_kernel_wgmma_d128<T, kCausal, ...>`,
// bf16 and f16): the one-warpgroup kernel above took 130 KB of shared
// memory and 225 registers (255 in f16) at D = 128, one CTA an SM, each
// streamed Q/dO tile serving 64 key rows (0.402 ms at (4, 2048, 16, 128)
// causal, 35% of its bound). The D = 128 kernel:
//   * a CTA of three warpgroups: two consumers of 64 key rows each (the
//     block's K and V, 64 KB) and a producer whose first warp streams the
//     Q/dO tiles of 64 queries (two stages, 32 KB each) with their lse
//     and Delta. setmaxnreg: 240 registers a consumer thread, 24 a
//     producer's; ptxas keeps dK, dV, S^T, dP^T and the packed P^T, dS^T
//     with no spills in all four instantiations, the f16 dS guard
//     (unchanged) included. Every streamed byte serves 128 key rows;
//   * each consumer takes the D = 64 kernel's steps tile by tile in two
//     turns at the tensor cores (named barriers 1 and 2, as in the D = 128
//     forward): S^T and dP^T, then dV += P^T dO and dK += dS^T Q. A tile
//     without work for a warpgroup (the causal diagonal's first tile for
//     the upper 64 keys, every tile where its keys are past m) takes both
//     turns without products, so a ragged block whose second warpgroup
//     lies past m computes and stores nothing there. Pipelining across
//     tiles (the last tile's dV, dK with this tile's scores, one turn a
//     tile) made ptxas serialize the wgmmas for want of registers and
//     took 0.545 ms (tools/torch_flash_bwd_variants.py);
//   * persistent: one CTA an SM walks work items ((b, h), 128 keys) head
//     by head, the heaviest causal block of a head first, dealt in rounds
//     forward and backward by turns (static: deterministic, no atomics).
//     The producer loads the next item's K, V and first Q/dO tiles while
//     the consumers store dK and dV; a head's items together keep its
//     Q, dO, lse and Delta within L2.
//
// dQ at D = 128 (`flash_bwd_dq_kernel_wgmma_d128<T, kCausal, ...>`, bf16
// and f16): the D = 64 template at D = 128 took 160 registers and 133 KB
// of shared memory, one CTA an SM, each streamed K/V tile serving 64 query
// rows (0.257 ms at (4, 2048, 16, 128) causal, 41% of its bound). The
// D = 128 kernel is the dK/dV kernel's design turned around:
//   * a CTA of three warpgroups: two consumers of 64 query rows each (the
//     block's Q and dO, 64 KB, and a 32 KB dQ tile to store) and a
//     producer whose one thread streams the K/V tiles of 64 keys (two
//     stages, 32 KB each), 162 KB a CTA; setmaxnreg 240 / 24.
//     A consumer keeps dQ, S, dP and the packed dS in registers; every
//     streamed K/V byte serves 128 query rows;
//   * each consumer takes the D = 64 kernel's steps tile by tile in two
//     turns at the tensor cores (named barriers 1 and 2): S and dP
//     (committed apart, so that P's exponentials run while dP is on the
//     tensor cores), then dQ += dS K. A tile without work for a
//     warpgroup (the causal diagonal's last 64 keys for the lower 64 rows,
//     every tile where its rows are past n) takes both turns without
//     products. The f16 dS guard is the D = 64 kernel's, and each row adds
//     its key tiles in the same order, so dQ is that kernel's bit for bit;
//   * persistent: one CTA an SM walks work items ((b, h), 128 query rows)
//     head by head, a head's heaviest causal block (its last queries)
//     first, dealt in rounds forward and backward by turns (static:
//     deterministic, no atomics). The producer loads the next item's
//     first K/V tile, then its Q and dO, while the consumers finish and
//     store dQ: through shared memory by one TMA store a warpgroup (a dQ
//     tensor map), which runs on into the next item.
//
// fp32 (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`): the first design,
// products in fp32 FMA on the CUDA cores, kept by design: the fp32 checks on
// the card (training parity against the CPU, the backward's fp32 cases)
// need products rounded nowhere but in fp32.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 32;    // keys (dQ) or queries (dK/dV) per inner tile
constexpr int kChunks = 4;   // float4 chunks of a row owned by one thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int D>
cudaError_t launch_fp32(bool dkv, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* out0, void* out1, int batch, int n, int m,
                        int heads, const Strides& st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr int R = Geometry<D>::kRows;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  if (dkv) {
    const dim3 grid((m + R - 1) / R, batch * heads);
    if (causal) {
      flash_bwd_dkv_kernel<float, D, true><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, o1, n, m, heads, st, scale);
    } else {
      flash_bwd_dkv_kernel<float, D, false><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, o1, n, m, heads, st, scale);
    }
  } else {
    const dim3 grid((n + R - 1) / R, batch * heads);
    if (causal) {
      flash_bwd_dq_kernel<float, D, true><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, n, m, heads, st, scale);
    } else {
      flash_bwd_dq_kernel<float, D, false><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, gp, lp, dp, o0, n, m, heads, st, scale);
    }
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma products fed by TMA
// ---------------------------------------------------------------------------

constexpr int kStages = 3;                  // depth of the streamed-tile ring
constexpr int kWgmmaThreads = 128 + 32;     // one consumer warpgroup + producer

// Shared memory of a dQ CTA: its Q and dO tiles, and the K/V ring, of
// 2-byte words of either type (only TMA and wgmma read them).
template <int D>
struct __align__(1024) DqSmem {
  static constexpr int kPanels = D / kPanel;
  uint16_t q[kPanels][kRows * kPanel];
  uint16_t g[kPanels][kRows * kPanel];
  uint16_t k[kStages][kPanels][kRows * kPanel];
  uint16_t v[kStages][kPanels][kRows * kPanel];
  uint64_t qg_full;
  uint64_t kv_full[kStages];
  uint64_t empty[kStages];
};

// Shared memory of a dK/dV CTA: its K and V tiles, and the ring of Q/dO
// tiles with their queries' lse (times log2 e) and Delta.
template <int D>
struct __align__(1024) DkvSmem {
  static constexpr int kPanels = D / kPanel;
  uint16_t k[kPanels][kRows * kPanel];
  uint16_t v[kPanels][kRows * kPanel];
  uint16_t q[kStages][kPanels][kRows * kPanel];
  uint16_t g[kStages][kPanels][kRows * kPanel];
  float lse2[kStages][kRows];
  float delta[kStages][kRows];
  uint64_t kv_full;
  uint64_t qg_full[kStages];
  uint64_t empty[kStages];
};

// acc (=) A B^T over D: A and B two 64-row tiles at shared addresses
// `a_addr` and `b_addr`, both K-major, in steps of 16 columns (+32 B within
// a panel, the next panel every 4 steps); the first step overwrites acc
// (issued, not committed)
template <typename T, int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a_addr,
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n64<T>(acc, smem_desc(a_addr + off, 16, 1024),
                 smem_desc(b_addr + off, 16, 1024), kk > 0);
  }
}

// acc += A B over 64 rows of B: A in registers (a[4 kk .. 4 kk + 3] for
// B's rows 16 kk .. 16 kk + 15), B the 64-row tile at `b_addr` read
// MN-major, 2 KB of rows a step (issued, not committed)
template <typename T, int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[16],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs<T, D>(acc, f, smem_desc(b_addr + kk * 2048, kPanelBytes, 1024));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// fp32 pairs to T pairs, in order: an accumulator tile becomes the
// register A operand of the next product
template <typename T>
__device__ __forceinline__ void pack(uint32_t (&dst)[16],
                                     const float (&src)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dst[i] = Elem<T>::pack(src[2 * i], src[2 * i + 1]);
  }
}

// f16's dS ceiling: a row's |dS| times its ds_mul stays at most this
constexpr float kDsMax = 32768.f;
// the least magnitude that rounds to 2^15 or more in f16 (the midpoint of
// 32752 and 2^15 rounds to the even 2^15): the guard's common-path test,
// a necessary condition of |dS| > kDsMax
constexpr float kF16Round = 32760.f;

// f16 only, the guard's rare path: this thread's values of a 64 x 64 tile
// of dS (rows row0 and row0 + 8: element i is row (i / 2) % 2, the
// accumulator layout; the 4 lanes of a row are adjacent), each row already
// times its power of two mul[r]. Where the tile's |dS| of row r passes
// kDsMax, mul[r] drops by the largest power of two that brings it under,
// and the row of ds and of the 64 x N accumulator `acc` is multiplied by
// the drop. Returns whether a row of the warp is below factor 1 (the same
// in every lane).
template <int N>
__device__ __forceinline__ bool fit_f16(float (&ds)[32], float (&mul)[2],
                                        float (&acc)[N]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], fabsf(ds[i]));
  }
  float f[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (mx[r] > kDsMax) {      // the same in the row's 4 lanes
      int e;
      frexpf(mx[r] / kDsMax, &e);          // mx / kDsMax <= 2^e
      f[r] = ldexpf(1.f, -e);
      mul[r] *= f[r];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if ((i / 2) % 2 == r) acc[i] *= f[r];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) ds[i] *= f[(i / 2) % 2];
  return __any_sync(0xffffffffu, mul[0] != 1.f || mul[1] != 1.f);
}

// rows `row0` and `row0 + 8` of a 64 x D accumulator, times mul[0] and
// mul[1], as T into the contiguous [B, rows, H, D] output whose row `row0`
// starts at `out` (rows >= `rows` are not stored)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 2],
                                           int row0, int rows, int heads,
                                           int col0, const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= rows) continue;
    T* o = out + static_cast<int64_t>(8 * r) * heads * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(o + 8 * jj + col0) =
          Elem<T>::pack(acc[4 * jj + 2 * r] * mul[r],
                        acc[4 * jj + 2 * r + 1] * mul[r]);
    }
  }
}

// CTAs an SM that ptxas leaves room for: at D = 64, bf16 takes 3 dQ CTAs
// and 2 dK/dV CTAs without being told; f16 is told so, since ptxas would
// otherwise spend registers on the dS guard past that
template <typename T, int D, bool kCausal>
__global__ void
__launch_bounds__(kWgmmaThreads, kIsHalf<T> && D == 64 ? 3 : 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int n, int m,
                          int heads, float scale) {
  using Smem = DqSmem<D>;
  constexpr int kPanels = Smem::kPanels;
  constexpr uint32_t kTileBytes = kPanels * kPanelBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // heaviest causal tiles first: blockIdx.y varies slowest
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = kCausal ? min(m, q0 + kRows) : m;
  const int n_tiles = (kv_end + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qg_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.empty[s], 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer warp: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(&sm.qg_full, 2 * kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.q[p], &q_map, &sm.qg_full, p * kPanel, h, q0, b);
        tma_load(sm.g[p], &g_map, &sm.qg_full, p * kPanel, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) {
          // the consumers have released the tile this stage held
          mbar_wait(&sm.empty[s], ((j / kStages) + 1) & 1);
        }
        mbar_expect_tx(&sm.kv_full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.k[s][p], &k_map, &sm.kv_full[s], p * kPanel, h,
                   j * kRows, b);
          tma_load(sm.v[s][p], &v_map, &sm.kv_full[s], p * kPanel, h,
                   j * kRows, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: q rows q0 .. q0 + 63; this thread's two rows
  // in the wgmma accumulator layout are row0 and row0 + 8
  const int row0 = q0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];     // lse * log2 e and Delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * n + row;
    lse2[r] = row < n ? lse[at] * kLog2e : 0.f;
    dlt[r] = row < n ? delta[at] : 0.f;
  }

  float dq_acc[D / 2];
  zero(dq_acc);
  float sc[32];        // S of the tile, then P, then dS / scale, in fp32
  float dp[32];        // dP of the tile
  uint32_t da[16];     // dS / scale (times ds_mul), T pairs
  float ds_mul[2] = {1.f, 1.f};   // f16: the rows' dS factors (fit_f16)
  bool scaled = false;   // f16: a row of the warp is below factor 1
  const uint32_t q_addr = smem_u32(sm.q[0]);
  const uint32_t g_addr = smem_u32(sm.g[0]);

  // tile j's K and V have landed. Waited for before wgmma_fence: a spin
  // loop between the fence and the wgmmas makes ptxas serialize them.
  auto wait_kv = [&](int j) {
    mbar_wait(&sm.kv_full[j % kStages], (j / kStages) & 1);
  };
  // dQ += dS K_j
  auto issue_dq = [&](int j) {
    issue_rs<T, D>(dq_acc, da, smem_u32(sm.k[j % kStages][0]));
  };
  // tile j's K and V may be overwritten
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[j % kStages]);
  };

  // Tile by tile: S and dP are committed apart, so that P's exponentials
  // run while dP is still on the tensor cores; other CTAs on the SM fill
  // the rest. Accumulator layout: sc[i] is row row0 + 8 * ((i / 2) % 2),
  // key j * 64 + 8 * (i / 4) + col0 + i % 2.
  mbar_wait(&sm.qg_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kRows;
    const bool edge = key0 + kRows > m || (kCausal && key0 + kRows > q0);
    zero(sc);
    zero(dp);
    wait_kv(j);
    wgmma_fence();
    issue_ss<T, D>(sc, q_addr, smem_u32(sm.k[j % kStages][0]));  // S = Q K^T
    wgmma_commit();
    issue_ss<T, D>(dp, g_addr, smem_u32(sm.v[j % kStages][0]));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
      if (edge) {
        const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
        if (key >= m || (kCausal && key > row0 + 8 * r)) p = 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if constexpr (kIsHalf<T>) {
      // f16: each row's factor in the product that forms its dS (at
      // factor 1 the same rounding as below; a power of two is exact),
      // and this thread's largest |dS| on the way; one vote of the warp
      // takes the fit where a value would round to 2^15 or more, and on
      // every tile once a row of the warp is below factor 1
      const float ndlt[2] = {-dlt[0] * ds_mul[0], -dlt[1] * ds_mul[1]};
      float big = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        sc[i] *= fmaf(dp[i], ds_mul[r], ndlt[r]);
        big = fmaxf(big, fabsf(sc[i]));
      }
      if (__any_sync(0xffffffffu, scaled || big >= kF16Round)) {
        scaled = fit_f16(sc, ds_mul, dq_acc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dlt[(i / 2) % 2];
    }
    pack<T>(da, sc);
    wgmma_fence();
    issue_dq(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(j);
  }

  const float mul[2] = {scale / ds_mul[0], scale / ds_mul[1]};
  store_rows<T, D>(dq + ((static_cast<int64_t>(b) * n + row0) * heads + h) * D,
                   dq_acc, row0, n, heads, col0, mul);
}

template <typename T, int D, bool kCausal>
__global__ void
__launch_bounds__(kWgmmaThreads, kIsHalf<T> && D == 64 ? 2 : 1)
flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap g_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int n,
                           int m,
                           int heads, float scale) {
  using Smem = DkvSmem<D>;
  constexpr int kPanels = Smem::kPanels;
  constexpr uint32_t kTileBytes = kPanels * kPanelBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // heaviest causal tiles (the first keys) first: blockIdx.y varies slowest
  const int k0 = blockIdx.y * kRows;
  // causal (n == m): no query tile above this key tile's diagonal attends
  const int t_begin = kCausal ? blockIdx.y : 0;
  const int n_tiles = (n + kRows - 1) / kRows - t_begin;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.qg_full[s], 1 + 32);   // TMA's bytes + the lse/Delta
      mbar_init(&sm.empty[s], 4);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer warp: lane 0 issues every copy, the 32 lanes store the
    // tile's lse and Delta (0 past n) and arrive on its full barrier
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.k[p], &k_map, &sm.kv_full, p * kPanel, h, k0, b);
        tma_load(sm.v[p], &v_map, &sm.kv_full, p * kPanel, h, k0, b);
      }
    }
    const float* lse_row = lse + static_cast<int64_t>(bh) * n;
    const float* delta_row = delta + static_cast<int64_t>(bh) * n;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int t0 = (t_begin + j) * kRows;
      if (j >= kStages) {
        // the consumers have released the tile this stage held
        mbar_wait(&sm.empty[s], ((j / kStages) + 1) & 1);
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.qg_full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.q[s][p], &q_map, &sm.qg_full[s], p * kPanel, h, t0, b);
          tma_load(sm.g[s][p], &g_map, &sm.qg_full[s], p * kPanel, h, t0, b);
        }
      }
#pragma unroll
      for (int r = lane; r < kRows; r += 32) {
        const bool ok = t0 + r < n;
        sm.lse2[s][r] = ok ? lse_row[t0 + r] * kLog2e : 0.f;
        sm.delta[s][r] = ok ? delta_row[t0 + r] : 0.f;
      }
      mbar_arrive(&sm.qg_full[s]);
    }
    return;
  }

  // the consumer warpgroup: key rows k0 .. k0 + 63; this thread's two rows
  // in the wgmma accumulator layout are row0 and row0 + 8
  const int row0 = k0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  float sc[32];        // S^T of the tile, then its P^T in fp32
  float dp[32];        // dP^T of the tile, then its dS^T / scale
  uint32_t pa[16];     // P^T, T pairs
  uint32_t da[16];     // dS^T / scale (times ds_mul), T pairs
  float ds_mul[2] = {1.f, 1.f};   // f16: the key rows' dS factors
  bool scaled = false;   // f16: a key row of the warp is below factor 1
  const uint32_t k_addr = smem_u32(sm.k[0]);
  const uint32_t v_addr = smem_u32(sm.v[0]);

  // tile j's Q, dO, lse and Delta have landed (waited for before
  // wgmma_fence, as in the dQ kernel)
  auto wait_qg = [&](int j) {
    mbar_wait(&sm.qg_full[j % kStages], (j / kStages) & 1);
  };
  // dV += P^T dO_j, dK += dS^T Q_j
  auto issue_dkv = [&](int j) {
    issue_rs<T, D>(dv_acc, pa, smem_u32(sm.g[j % kStages][0]));
    issue_rs<T, D>(dk_acc, da, smem_u32(sm.q[j % kStages][0]));
  };
  // tile j's Q, dO, lse and Delta may be overwritten
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[j % kStages]);
  };

  // Tile by tile, as the dQ kernel: S^T and dP^T are committed apart, so
  // that P^T's exponentials run while dP^T is still on the tensor cores.
  // Accumulator layout: element i is key row0 + 8 * ((i / 2) % 2), query
  // t0 + 8 * (i / 4) + col0 + i % 2: lse and Delta by column. Pipelined
  // across tiles, P^T, dS^T, the next tile's scores and both accumulators
  // are live at once, and ptxas then spills and serializes the wgmmas at
  // D = 64 or leaves room for one CTA an SM: each such variant lost on the
  // card to this order (PERF.md section 6; tools/torch_flash_bwd_variants.py).
  mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int t0 = (t_begin + j) * kRows;
    const bool edge = t0 + kRows > n || k0 + kRows > m ||
                      (kCausal && t0 < k0 + kRows);
    zero(sc);
    zero(dp);
    wait_qg(j);
    wgmma_fence();
    issue_ss<T, D>(sc, k_addr, smem_u32(sm.q[s][0]));   // S^T = K Q^T
    wgmma_commit();
    issue_ss<T, D>(dp, v_addr, smem_u32(sm.g[s][0]));   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + col0 + (i % 2);
      float p = ex2(fmaf(sc[i], scale_log2, -sm.lse2[s][col]));
      if (edge) {
        const int key = row0 + 8 * ((i / 2) % 2);
        const int query = t0 + col;
        if (query >= n || key >= m || (kCausal && query < key)) p = 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if constexpr (kIsHalf<T>) {
      // f16: the dQ kernel's guard, the rows' factors applied in the fit
      // alone (Delta is by column here, so in the product that forms
      // dS^T they would cost a multiply a value on every tile)
      float big = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + col0 + (i % 2);
        dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
        big = fmaxf(big, fabsf(dp[i]));
      }
      if (__any_sync(0xffffffffu, scaled || big >= kF16Round)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] *= ds_mul[(i / 2) % 2];
        scaled = fit_f16(dp, ds_mul, dk_acc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + col0 + (i % 2);
        dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
      }
    }
    pack<T>(pa, sc);
    pack<T>(da, dp);
    wgmma_fence();
    issue_dkv(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    release(j);
  }

  const int64_t out = ((static_cast<int64_t>(b) * m + row0) * heads + h) * D;
  const float dk_mul[2] = {scale / ds_mul[0], scale / ds_mul[1]};
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dk + out, dk_acc, row0, m, heads, col0, dk_mul);
  store_rows<T, D>(dv + out, dv_acc, row0, m, heads, col0, one);
}

// ---------------------------------------------------------------------------
// dK/dV in bf16 and f16 at D = 128: two consumer warpgroups share every
// streamed Q/dO tile
// ---------------------------------------------------------------------------

// The D = 128 kernel's configuration (tools/torch_flash_bwd_variants.py
// builds others in turns): ring depth, and whether the consumers take
// turns at the tensor cores
constexpr int kDkv128Stages = 2;
constexpr bool kDkv128PingPong = true;
constexpr bool kDkv128Persistent = true;

// both D = 128 kernels: two consumer warpgroups (64 rows each) and a
// producer warpgroup
constexpr int kThreads128 = 3 * 128;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: consumer warpgroup w waits on kBarTurn + w for its turn,
// and (dQ) its threads meet on kBarStore + w around its dQ tile's store
constexpr int kBarTurn = 1;
constexpr int kBarStore = 3;

// Shared memory of a dK/dV CTA at D = 128: the two 64-row halves of its K
// and V tiles, and the ring of Q/dO tiles with their queries' lse (times
// log2 e) and Delta
template <int kS>
struct __align__(1024) DkvSmem128 {
  uint16_t k[2][2][kRows * kPanel];
  uint16_t v[2][2][kRows * kPanel];
  uint16_t q[kS][2][kRows * kPanel];
  uint16_t g[kS][2][kRows * kPanel];
  float lse2[kS][kRows];
  float delta[kS][kRows];
  uint64_t kv_full;
  uint64_t kv_empty;
  uint64_t qg_full[kS];
  uint64_t empty[kS];
};

template <typename T, bool kCausal, int kS, bool kPingPong>
__global__ void __launch_bounds__(kThreads128, 1)
flash_bwd_dkv_kernel_wgmma_d128(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap g_map,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int n, int m, int heads, int batch_heads,
                                float scale) {
  constexpr int D = 128;
  using Smem = DkvSmem128<kS>;
  constexpr uint32_t kTileBytes = 2 * kPanelBytes;   // 64 rows x 128
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  // The CTA's work items, each ((b, h), 128 key rows): item t is key
  // block t % n_kb of head t / n_kb. A head's blocks run together, so its
  // Q, dO, lse and Delta come from HBM once and from L2 for the rest, the
  // heaviest causal block (the first keys) first; rounds of gridDim.x
  // items go to the CTAs in order and in reverse by turns, as in the
  // D = 128 forward.
  const int n_kb = (m + 2 * kRows - 1) / (2 * kRows);
  const int n_items = n_kb * batch_heads;
  struct Item {
    int b, h, bh, k0, t_begin, n_tiles;
  };
  auto item = [&](int r, Item& it) {
    const int c = (r % 2 == 0) ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
    const int t = r * gridDim.x + c;
    if (t >= n_items) return false;
    it.bh = t / n_kb;
    const int kb = t - it.bh * n_kb;
    it.b = it.bh / heads;
    it.h = it.bh - it.b * heads;
    it.k0 = kb * 2 * kRows;
    // causal (n == m): no query tile above the block's diagonal attends
    it.t_begin = kCausal ? 2 * kb : 0;
    it.n_tiles = (n + kRows - 1) / kRows - it.t_begin;
    return true;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, 8);            // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&sm.qg_full[s], 1 + 32);   // TMA's bytes + the lse/Delta
      mbar_init(&sm.empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer warpgroup: its first warp's lane 0 issues every copy,
    // its 32 lanes store each tile's lse and Delta (0 past n) and arrive
    // on the tile's full barrier
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 8) {
      Item it;
      int g = 0;     // the CTA's Q/dO tiles before this item
      for (int r = 0; item(r, it); ++r) {
        if (lane == 0) {
          // the consumers are done with the last item's K and V
          if (r > 0) mbar_wait(&sm.kv_empty, (r - 1) & 1);
          mbar_expect_tx(&sm.kv_full, 4 * kTileBytes);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              tma_load(sm.k[half][p], &k_map, &sm.kv_full, p * kPanel, it.h,
                       it.k0 + half * kRows, it.b);
              tma_load(sm.v[half][p], &v_map, &sm.kv_full, p * kPanel, it.h,
                       it.k0 + half * kRows, it.b);
            }
          }
        }
        const float* lse_row = lse + static_cast<int64_t>(it.bh) * n;
        const float* delta_row = delta + static_cast<int64_t>(it.bh) * n;
        for (int j = 0; j < it.n_tiles; ++j) {
          const int s = (g + j) % kS;
          const int t0 = (it.t_begin + j) * kRows;
          if (g + j >= kS) {
            // the consumers have released the tile this stage held
            mbar_wait(&sm.empty[s], (((g + j) / kS) + 1) & 1);
          }
          if (lane == 0) {
            mbar_expect_tx(&sm.qg_full[s], 2 * kTileBytes);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              tma_load(sm.q[s][p], &q_map, &sm.qg_full[s], p * kPanel, it.h,
                       t0, it.b);
              tma_load(sm.g[s][p], &g_map, &sm.qg_full[s], p * kPanel, it.h,
                       t0, it.b);
            }
          }
#pragma unroll
          for (int rr = lane; rr < kRows; rr += 32) {
            const bool ok = t0 + rr < n;
            sm.lse2[s][rr] = ok ? lse_row[t0 + rr] * kLog2e : 0.f;
            sm.delta[s][rr] = ok ? delta_row[t0 + rr] : 0.f;
          }
          mbar_arrive(&sm.qg_full[s]);
        }
        g += it.n_tiles;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // consumer warpgroup wg: key rows kw .. kw + 63 of each item; this
    // thread's two rows in the wgmma accumulator layout are row0 and
    // row0 + 8
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
    // S^T of the tile, then its P^T in fp32; dP^T of the tile, then its
    // dS^T / scale (each product's first k-step overwrites them: zeroed
    // once, so that they are never read undefined)
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    uint32_t pa[16];     // P^T, T pairs
    uint32_t da[16];     // dS^T / scale (times ds_mul), T pairs
    const uint32_t k_addr = smem_u32(sm.k[wg][0]);
    const uint32_t v_addr = smem_u32(sm.v[wg][0]);

    // turns at the tensor cores, as in the D = 128 forward: warpgroup 0
    // issues its products, then warpgroup 1, and so on
    auto turn_begin = [&]() {
      if constexpr (kPingPong) bar_sync(kBarTurn + wg, 256);
    };
    auto turn_end = [&]() {
      if constexpr (kPingPong) bar_arrive(kBarTurn + 1 - wg, 256);
    };
    // Q/dO tile gj (counted over the CTA's items) may be overwritten; the
    // item's K and V, once this warpgroup's last S^T and dP^T are in
    auto release = [&](int gj) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[gj % kS]);
    };
    auto release_kv = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.kv_empty);
    };

    // warpgroup 0 takes the first turn
    if (kPingPong && wg == 1) bar_arrive(kBarTurn, 256);
    Item it;
    int g = 0;
    for (int r = 0; item(r, it); ++r) {
      const int kw = it.k0 + wg * kRows;
      const int row0 = kw + 16 * warp + lane / 4;
      float ds_mul[2] = {1.f, 1.f};   // f16: the key rows' dS factors
      bool scaled = false;   // f16: a key row of the warp is below factor 1
      zero(dk_acc);
      zero(dv_acc);
      mbar_wait(&sm.kv_full, r & 1);
      if (kw >= m) release_kv();
      // Tile by tile, as the D = 64 kernel, in two turns: S^T and dP^T
      // (committed apart, so that P^T's exponentials run while dP^T is on
      // the tensor cores), then dV += P^T dO and dK += dS^T Q. A tile with
      // no work for this warpgroup (the causal diagonal's first tile for
      // the upper 64 keys, every tile where its keys are past m) takes
      // both turns without products. Accumulator layout: element i is key
      // row0 + 8 * ((i / 2) % 2), query t0 + 8 * (i / 4) + col0 + i % 2.
      for (int j = 0; j < it.n_tiles; ++j) {
        const int s = (g + j) % kS;
        const int t0 = (it.t_begin + j) * kRows;
        mbar_wait(&sm.qg_full[s], ((g + j) / kS) & 1);
        if (kw >= m || (kCausal && t0 + kRows <= kw)) {
          turn_begin();
          turn_end();
          turn_begin();
          turn_end();
          release(g + j);
          continue;
        }
        const bool edge = t0 + kRows > n || kw + kRows > m ||
                          (kCausal && t0 < kw + kRows);
        turn_begin();
        wgmma_fence();
        issue_ss<T, D>(sc, k_addr, smem_u32(sm.q[s][0]));   // S^T = K Q^T
        wgmma_commit();
        issue_ss<T, D>(dp, v_addr, smem_u32(sm.g[s][0]));   // dP^T = V dO^T
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();
        fence_regs(sc);
        if (edge) {
          // masked: 2^-inf = 0 below
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = row0 + 8 * ((i / 2) % 2);
            const int query = t0 + 8 * (i / 4) + col0 + (i % 2);
            if (query >= n || key >= m || (kCausal && query < key)) {
              sc[i] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + col0 + (i % 2);
          sc[i] = ex2(fmaf(sc[i], scale_log2, -sm.lse2[s][col]));
        }
        wgmma_wait<0>();
        fence_regs(dp);
        if (j == it.n_tiles - 1) release_kv();
        if constexpr (kIsHalf<T>) {
          // f16: the D = 64 kernel's guard, unchanged
          float big = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i / 4) + col0 + (i % 2);
            dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
            big = fmaxf(big, fabsf(dp[i]));
          }
          if (__any_sync(0xffffffffu, scaled || big >= kF16Round)) {
#pragma unroll
            for (int i = 0; i < 32; ++i) dp[i] *= ds_mul[(i / 2) % 2];
            scaled = fit_f16(dp, ds_mul, dk_acc);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i / 4) + col0 + (i % 2);
            dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
          }
        }
        pack<T>(pa, sc);
        pack<T>(da, dp);
        turn_begin();
        wgmma_fence();
        issue_rs<T, D>(dv_acc, pa, smem_u32(sm.g[s][0]));   // dV += P^T dO
        issue_rs<T, D>(dk_acc, da, smem_u32(sm.q[s][0]));   // dK += dS^T Q
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        release(g + j);
      }
      g += it.n_tiles;

      const int64_t out =
          ((static_cast<int64_t>(it.b) * m + row0) * heads + it.h) * D;
      const float dk_mul[2] = {scale / ds_mul[0], scale / ds_mul[1]};
      const float one[2] = {1.f, 1.f};
      store_rows<T, D>(dk + out, dk_acc, row0, m, heads, col0, dk_mul);
      store_rows<T, D>(dv + out, dv_acc, row0, m, heads, col0, one);
    }
    // the last bar_arrive of warpgroup 1 on warpgroup 0's barrier
    if (kPingPong && wg == 0) bar_sync(kBarTurn, 256);
  }
}

// CTAs of a D = 128 launch over `items` work items: one an SM, each
// walking its share of the items (`persistent`), else one an item
inline cudaError_t grid_128(int items, bool persistent, int* ctas) {
  *ctas = items;
  if (!persistent) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *ctas = items < sms ? items : sms;
  return cudaSuccess;
}

template <typename T, bool kCausal>
cudaError_t launch_dkv_d128(const CUtensorMap* maps, const float* lse,
                            const float* delta, T* dk, T* dv, int batch,
                            int n, int m, int heads, float scale,
                            cudaStream_t stream) {
  auto* kernel = flash_bwd_dkv_kernel_wgmma_d128<T, kCausal, kDkv128Stages,
                                                 kDkv128PingPong>;
  const int smem = static_cast<int>(sizeof(DkvSmem128<kDkv128Stages>)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = grid_128(batch * heads * ((m + 2 * kRows - 1) / (2 * kRows)),
                 kDkv128Persistent, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads128, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv, n, m, heads,
      batch * heads, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ in bf16 and f16 at D = 128: two consumer warpgroups share every
// streamed K/V tile
// ---------------------------------------------------------------------------

// The D = 128 dQ kernel's configuration (tools/torch_flash_bwd_variants.py
// builds others in turns): ring depth, whether the consumers take turns at
// the tensor cores, whether one CTA an SM walks the work items (else one
// CTA an item), whether a head's items run together (else the heads
// interleave), and whether dQ is stored by TMA through shared memory (else
// by 4-byte stores from the accumulator)
constexpr int kDq128Stages = 2;
constexpr bool kDq128PingPong = true;
constexpr bool kDq128Persistent = true;
constexpr bool kDq128HeadMajor = true;
constexpr bool kDq128TmaStore = true;

// Shared memory of a dQ CTA at D = 128: the two 64-row halves of its Q and
// dO tiles, each warpgroup's dQ tile to store, and the ring of K/V tiles of
// 64 keys
template <int kS>
struct __align__(1024) DqSmem128 {
  uint16_t q[2][2][kRows * kPanel];
  uint16_t g[2][2][kRows * kPanel];
  uint16_t dq[2][2][kRows * kPanel];
  uint16_t k[kS][2][kRows * kPanel];
  uint16_t v[kS][2][kRows * kPanel];
  uint64_t qg_full;
  uint64_t qg_empty;
  uint64_t kv_full[kS];
  uint64_t empty[kS];
};

template <typename T, bool kCausal, int kS, bool kPingPong>
__global__ void __launch_bounds__(kThreads128, 1)
flash_bwd_dq_kernel_wgmma_d128(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const __grid_constant__ CUtensorMap dq_map,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dq, int n, int m, int heads,
                               int batch_heads, float scale) {
  constexpr int D = 128;
  using Smem = DqSmem128<kS>;
  constexpr uint32_t kTileBytes = 2 * kPanelBytes;   // 64 rows x 128
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  // The CTA's work items, each ((b, h), 128 query rows): item t is query
  // block (n_qb - 1 - t % n_qb) of head t / n_qb. A head's blocks run
  // together, so its K, V, lse and Delta come from HBM once and from L2
  // for the rest, the heaviest causal block (the last queries) first;
  // rounds of gridDim.x items go to the CTAs in order and in reverse by
  // turns, as in the D = 128 forward.
  const int n_qb = (n + 2 * kRows - 1) / (2 * kRows);
  const int n_items = n_qb * batch_heads;
  struct Item {
    int b, h, bh, q0, n_tiles;
  };
  auto item = [&](int r, Item& it) {
    const int c = (r % 2 == 0) ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
    const int t = r * gridDim.x + c;
    if (t >= n_items) return false;
    int qb;
    if constexpr (kDq128HeadMajor) {
      it.bh = t / n_qb;
      qb = t - it.bh * n_qb;
    } else {
      qb = t / batch_heads;
      it.bh = t - qb * batch_heads;
    }
    it.b = it.bh / heads;
    it.h = it.bh - it.b * heads;
    it.q0 = (n_qb - 1 - qb) * 2 * kRows;
    // causal: no row of the block attends past its last row
    const int kv_end = kCausal ? min(m, it.q0 + 2 * kRows) : m;
    it.n_tiles = (kv_end + kRows - 1) / kRows;
    return true;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qg_full, 1);
    mbar_init(&sm.qg_empty, 8);            // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      Item it;
      // the item's K/V tile j, the CTA's tile gj, into stage gj % kS
      auto load_kv = [&](int gj, int j) {
        const int s = gj % kS;
        if (gj >= kS) {
          // the consumers have released the tile this stage held
          mbar_wait(&sm.empty[s], ((gj / kS) + 1) & 1);
        }
        mbar_expect_tx(&sm.kv_full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_load(sm.k[s][p], &k_map, &sm.kv_full[s], p * kPanel, it.h,
                   j * kRows, it.b);
          tma_load(sm.v[s][p], &v_map, &sm.kv_full[s], p * kPanel, it.h,
                   j * kRows, it.b);
        }
      };
      int g = 0;     // the CTA's K/V tiles before this item
      for (int r = 0; item(r, it); ++r) {
        // K/V tile 0 first: the Q and dO buffers free only once the last
        // item's last S and dP are in
        load_kv(g, 0);
        if (r > 0) mbar_wait(&sm.qg_empty, (r - 1) & 1);
        mbar_expect_tx(&sm.qg_full, 8 * kPanelBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            tma_load(sm.q[half][p], &q_map, &sm.qg_full, p * kPanel, it.h,
                     it.q0 + half * kRows, it.b);
            tma_load(sm.g[half][p], &g_map, &sm.qg_full, p * kPanel, it.h,
                     it.q0 + half * kRows, it.b);
          }
        }
        for (int j = 1; j < it.n_tiles; ++j) load_kv(g + j, j);
        g += it.n_tiles;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // consumer warpgroup wg: query rows qw .. qw + 63 of each item; this
    // thread's two rows in the wgmma accumulator layout are row0 and
    // row0 + 8
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_addr = smem_u32(sm.q[wg][0]);
    const uint32_t g_addr = smem_u32(sm.g[wg][0]);

    float dq_acc[D / 2];
    // S of the tile, then P, then dS / scale, in fp32; dP of the tile
    // (each product's first k-step overwrites them: zeroed once, so that
    // they are never read undefined)
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    uint32_t da[16];     // dS / scale (times ds_mul), T pairs

    // turns at the tensor cores, as in the D = 128 forward: warpgroup 0
    // issues its products, then warpgroup 1, and so on
    auto turn_begin = [&]() {
      if constexpr (kPingPong) bar_sync(kBarTurn + wg, 256);
    };
    auto turn_end = [&]() {
      if constexpr (kPingPong) bar_arrive(kBarTurn + 1 - wg, 256);
    };
    // K/V tile gj (counted over the CTA's items) may be overwritten; the
    // item's Q and dO, once this warpgroup's last S and dP are in
    auto release = [&](int gj) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[gj % kS]);
    };
    auto release_qg = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.qg_empty);
    };

    // warpgroup 0 takes the first turn
    if (kPingPong && wg == 1) bar_arrive(kBarTurn, 256);
    Item it;
    int g = 0;
    for (int r = 0; item(r, it); ++r) {
      // this warpgroup's rows and its tiles: the item's first n_w (none
      // where its rows are past n)
      const int qw = it.q0 + wg * kRows;
      const int row0 = qw + 16 * warp + lane / 4;
      const int kv_end_w = kCausal ? min(m, qw + kRows) : m;
      const int n_w = qw < n ? (kv_end_w + kRows - 1) / kRows : 0;
      float lse2[2], dlt[2];     // lse * log2 e and Delta of the two rows
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const int64_t at = static_cast<int64_t>(it.bh) * n + row;
        lse2[rr] = row < n ? lse[at] * kLog2e : 0.f;
        dlt[rr] = row < n ? delta[at] : 0.f;
      }
      float ds_mul[2] = {1.f, 1.f};   // f16: the rows' dS factors (fit_f16)
      bool scaled = false;   // f16: a row of the warp is below factor 1
      zero(dq_acc);
      mbar_wait(&sm.qg_full, r & 1);
      if (n_w == 0) release_qg();
      // Tile by tile, as the D = 64 kernel, in two turns: S and dP
      // (committed apart, so that P's exponentials run while dP is on the
      // tensor cores), then dQ += dS K. A tile with no work for this
      // warpgroup (the causal diagonal's last 64 keys for the lower 64
      // rows, every tile where its rows are past n) takes both turns
      // without products, after the tile has landed, so that every
      // consumer warp releases every tile in order. Accumulator layout:
      // sc[i] is row row0 + 8 * ((i / 2) % 2), key j * 64 + 8 * (i / 4) +
      // col0 + i % 2.
      for (int j = 0; j < it.n_tiles; ++j) {
        const int s = (g + j) % kS;
        mbar_wait(&sm.kv_full[s], ((g + j) / kS) & 1);
        if (j >= n_w) {
          turn_begin();
          turn_end();
          turn_begin();
          turn_end();
          release(g + j);
          continue;
        }
        const int key0 = j * kRows;
        const bool edge = key0 + kRows > m || (kCausal && key0 + kRows > qw);
        turn_begin();
        wgmma_fence();
        issue_ss<T, D>(sc, q_addr, smem_u32(sm.k[s][0]));   // S = Q K^T
        wgmma_commit();
        issue_ss<T, D>(dp, g_addr, smem_u32(sm.v[s][0]));   // dP = dO V^T
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();
        fence_regs(sc);
        if (edge) {
          // masked: 2^-inf = 0 below
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
            if (key >= m || (kCausal && key > row0 + 8 * ((i / 2) % 2))) {
              sc[i] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[(i / 2) % 2]));
        }
        wgmma_wait<0>();
        fence_regs(dp);
        if (j == n_w - 1) release_qg();
        if constexpr (kIsHalf<T>) {
          // f16: the D = 64 kernel's guard, unchanged
          const float ndlt[2] = {-dlt[0] * ds_mul[0], -dlt[1] * ds_mul[1]};
          float big = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int rr = (i / 2) % 2;
            sc[i] *= fmaf(dp[i], ds_mul[rr], ndlt[rr]);
            big = fmaxf(big, fabsf(sc[i]));
          }
          if (__any_sync(0xffffffffu, scaled || big >= kF16Round)) {
            scaled = fit_f16(sc, ds_mul, dq_acc);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dlt[(i / 2) % 2];
        }
        pack<T>(da, sc);
        turn_begin();
        wgmma_fence();
        issue_rs<T, D>(dq_acc, da, smem_u32(sm.k[s][0]));   // dQ += dS K
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        release(g + j);
      }
      g += it.n_tiles;

      const float mul[2] = {scale / ds_mul[0], scale / ds_mul[1]};
      if constexpr (kDq128TmaStore) {
        // through shared memory: the warpgroup's 64 x 128 dQ tile in the
        // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
        // then one thread's TMA store (rows past n are not written), which
        // runs on while the next item starts
        const bool issuer = threadIdx.x % 128 == 0;
        if (issuer) bulk_wait_read<0>();   // the last item's store has read it
        bar_sync(kBarStore + wg, 128);
        uint8_t* ob = reinterpret_cast<uint8_t*>(sm.dq[wg][0]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int rw = 16 * warp + lane / 4 + 8 * rr;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            const uint32_t off = (jj / 8) * kPanelBytes + rw * 128 +
                                 (((jj % 8) ^ (rw % 8)) * 16) + col0 * 2;
            *reinterpret_cast<uint32_t*>(ob + off) =
                Elem<T>::pack(dq_acc[4 * jj + 2 * rr] * mul[rr],
                              dq_acc[4 * jj + 2 * rr + 1] * mul[rr]);
          }
        }
        fence_proxy_async();
        bar_sync(kBarStore + wg, 128);
        if (issuer && qw < n) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            tma_store(&dq_map, sm.dq[wg][p], p * kPanel, it.h, qw, it.b);
          }
          bulk_commit();
        }
      } else {
        store_rows<T, D>(
            dq + ((static_cast<int64_t>(it.b) * n + row0) * heads + it.h) * D,
            dq_acc, row0, n, heads, col0, mul);
      }
    }
    // the last bar_arrive of warpgroup 1 on warpgroup 0's barrier
    if (kPingPong && wg == 0) bar_sync(kBarTurn, 256);
    // the last store has run before the CTA's shared memory is freed
    if (kDq128TmaStore && threadIdx.x % 128 == 0) bulk_wait_all();
  }
}

// maps: q, k, v, dO and the output dQ
template <typename T, bool kCausal>
cudaError_t launch_dq_d128(const CUtensorMap* maps, const float* lse,
                           const float* delta, T* dq, int batch, int n, int m,
                           int heads, float scale, cudaStream_t stream) {
  auto* kernel = flash_bwd_dq_kernel_wgmma_d128<T, kCausal, kDq128Stages,
                                                kDq128PingPong>;
  const int smem = static_cast<int>(sizeof(DqSmem128<kDq128Stages>)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = grid_128(batch * heads * ((n + 2 * kRows - 1) / (2 * kRows)),
                 kDq128Persistent, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads128, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, delta, dq, n, m,
      heads, batch * heads, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal>
cudaError_t launch_wgmma_kernel(bool dkv, const CUtensorMap* maps,
                                const float* lse, const float* delta,
                                void* out0, void* out1, int batch, int n,
                                int m, int heads, float scale,
                                cudaStream_t stream) {
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  if constexpr (D == 128) {
    return dkv ? launch_dkv_d128<T, kCausal>(maps, lse, delta, o0, o1, batch,
                                             n, m, heads, scale, stream)
               : launch_dq_d128<T, kCausal>(maps, lse, delta, o0, batch, n,
                                            m, heads, scale, stream);
  } else {
    const int smem = static_cast<int>(dkv ? sizeof(DkvSmem<D>)
                                          : sizeof(DqSmem<D>)) + 1024;
    const dim3 grid(batch * heads, ((dkv ? m : n) + kRows - 1) / kRows);
    cudaError_t err;
    if (dkv) {
      err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_wgmma<T, D, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_kernel_wgmma<T, D, kCausal>
          <<<grid, kWgmmaThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], lse, delta, o0,
                                                  o1, n, m, heads, scale);
    } else {
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel_wgmma<T, D, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_kernel_wgmma<T, D, kCausal>
          <<<grid, kWgmmaThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], lse, delta, o0, n,
                                                  m, heads, scale);
    }
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(bool dkv, const CUtensorMap* maps, const void* lse,
                         const void* delta, void* out0, void* out1,
                         int batch, int n, int m, int heads, float scale,
                         int causal, cudaStream_t stream) {
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  return causal ? launch_wgmma_kernel<T, D, true>(dkv, maps, lp, dp, out0,
                                                  out1, batch, n, m, heads,
                                                  scale, stream)
                : launch_wgmma_kernel<T, D, false>(dkv, maps, lp, dp, out0,
                                                   out1, batch, n, m, heads,
                                                   scale, stream);
}

// the maps over q, k, v, dO (rows n, m, m, n) and, for the D = 128 dQ
// kernel's TMA store, over the contiguous dQ; then the instantiation
template <typename T>
int launch_tc(bool dkv, const void* const (&ptrs)[4], const void* lse,
              const void* delta, void* out0, void* out1, int batch, int n,
              int m, int heads, int head_dim, const long long* s,
              float scale, int causal, cudaStream_t cs) {
  const int rows[4] = {n, m, m, n};
  CUtensorMap maps[5];
  for (int i = 0; i < 4; ++i) {
    const int err = encode_map(&maps[i], Elem<T>::kMap, ptrs[i], head_dim,
                               heads, rows[i], batch, s[3 * i],
                               s[3 * i + 1], s[3 * i + 2]);
    if (err != 0) return err;
  }
  if (!dkv && head_dim == 128) {
    const int64_t row = static_cast<int64_t>(heads) * head_dim;
    const int err = encode_map(&maps[4], Elem<T>::kMap, out0, head_dim,
                               heads, n, batch, row * n, row, head_dim);
    if (err != 0) return err;
  }
  const cudaError_t launched =
      head_dim == 64
          ? launch_wgmma<T, 64>(dkv, maps, lse, delta, out0, out1, batch, n,
                                m, heads, scale, causal, cs)
          : launch_wgmma<T, 128>(dkv, maps, lse, delta, out0, out1, batch,
                                 n, m, heads, scale, causal, cs);
  return static_cast<int>(launched);
}

int dispatch(bool dkv, const void* q, const void* k, const void* v,
             const void* g, const void* lse, const void* delta, void* out0,
             void* out1, int batch, int n, int m, int heads, int head_dim,
             const long long* s, float scale, int causal, int dtype,
             void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || heads <= 0 ||
      batch * heads > 65535 || (causal && n != m) ||
      (head_dim != 64 && head_dim != 128) || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                     s[6], s[7], s[8], s[9], s[10], s[11]};
    const cudaError_t err =
        head_dim == 64
            ? launch_fp32<64>(dkv, q, k, v, g, lse, delta, out0, out1, batch,
                              n, m, heads, st, scale, causal, cs)
            : launch_fp32<128>(dkv, q, k, v, g, lse, delta, out0, out1,
                               batch, n, m, heads, st, scale, causal, cs);
    return static_cast<int>(err);
  }
  const void* const ptrs[4] = {q, k, v, g};
  return dtype == 1
             ? launch_tc<__nv_bfloat16>(dkv, ptrs, lse, delta, out0, out1,
                                        batch, n, m, heads, head_dim, s,
                                        scale, causal, cs)
             : launch_tc<__half>(dkv, ptrs, lse, delta, out0, out1, batch,
                                 n, m, heads, head_dim, s, scale, causal, cs);
}

template <typename T, int D, bool kCausal>
cudaError_t bwd_info(int dkv, int* out) {
  if constexpr (D == 128) {
    if (!dkv) {
      return kernel_info(
          flash_bwd_dq_kernel_wgmma_d128<T, kCausal, kDq128Stages,
                                         kDq128PingPong>,
          kThreads128,
          static_cast<int>(sizeof(DqSmem128<kDq128Stages>)) + 1024, out);
    }
    return kernel_info(
        flash_bwd_dkv_kernel_wgmma_d128<T, kCausal, kDkv128Stages,
                                        kDkv128PingPong>,
        kThreads128,
        static_cast<int>(sizeof(DkvSmem128<kDkv128Stages>)) + 1024, out);
  } else {
    if (!dkv) {
      return kernel_info(flash_bwd_dq_kernel_wgmma<T, D, kCausal>,
                         kWgmmaThreads,
                         static_cast<int>(sizeof(DqSmem<D>)) + 1024, out);
    }
    return kernel_info(flash_bwd_dkv_kernel_wgmma<T, D, kCausal>,
                       kWgmmaThreads,
                       static_cast<int>(sizeof(DkvSmem<D>)) + 1024, out);
  }
}

}  // namespace

// dtype: 0 = float32 (fp32 FMA kernels), 1 = bfloat16, 2 = float16 (wgmma +
// TMA kernels of that type; strides must be multiples of 8 elements and the
// bases 16-byte aligned, which the caller checks); another code returns
// cudaErrorInvalidValue. `strides` holds 12 element strides in
// the order (q: batch, seq, head), (k: ...), (v: ...), (dO: ...). lse and
// delta are contiguous [batch*heads, n] fp32. Returns a cudaError_t; for
// bf16 and f16 also 100000 when the CUDA driver has no cuTensorMapEncodeTiled, and
// 200000 + its CUresult when an encode fails.
// What the tensor-core kernel (dQ, or dK/dV where `dkv`) of (head_dim,
// dtype 1 or 2, causal) takes on this card: out[0] CTAs an SM at its
// launch's shared memory, out[1] registers a thread at launch, out[2]
// local (spilled) bytes a thread, out[3] dynamic shared memory bytes,
// out[4] threads a CTA (`kernel_info`). Returns a cudaError_t.
extern "C" int paddle_flash_attention_bwd_info(int dkv, int head_dim,
                                               int dtype, int causal,
                                               int* out) {
  if ((head_dim != 64 && head_dim != 128) || dtype < 1 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (dtype == 1) {
    err = head_dim == 64
              ? (causal ? bwd_info<__nv_bfloat16, 64, true>(dkv, out)
                        : bwd_info<__nv_bfloat16, 64, false>(dkv, out))
              : (causal ? bwd_info<__nv_bfloat16, 128, true>(dkv, out)
                        : bwd_info<__nv_bfloat16, 128, false>(dkv, out));
  } else {
    err = head_dim == 64 ? (causal ? bwd_info<__half, 64, true>(dkv, out)
                                   : bwd_info<__half, 64, false>(dkv, out))
                         : (causal ? bwd_info<__half, 128, true>(dkv, out)
                                   : bwd_info<__half, 128, false>(dkv, out));
  }
  return static_cast<int>(err);
}

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
