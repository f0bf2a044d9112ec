// FlashAttention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (driven by
// `_flash_fwd`, `pallas_call` at :163), the Pallas TPU kernel behind
// F.scaled_dot_product_attention. Computes O = softmax(scale * Q K^T
// [top-left causal mask]) V and the fp32 natural-log logsumexp per row over
// q, k, v laid out [B, N, H, D] (any strides with a contiguous last dim, so
// the q/k/v slices of the fused qkv projection are read in place); O is
// written contiguous [B, N, H, D] in the input type, lse [B*H, N] fp32 (the
// backward kernels read it).
//
// What bounds it on an H100: each input read once and each output written
// once is 15.1 MB at the training shape (B=8, N=1024, H=12, D=64, bf16,
// causal: 0.01514 ms at 3.35 TB/s) and 1.9 MB at the serving prefill shape
// (B=1: 0.00189 ms); the 4*D FLOPs per unmasked (query, key) pair are 12.9
// and 1.6 GFLOP, 0.013 and 0.0016 ms at the 989 TFLOP/s bf16 tensor-core
// peak. So both products have to run on the tensor cores, and the kernel
// has to keep them fed: the serving shape is 12 heads x 16 tiles of 64 rows,
// barely more tiles than the card has SMs, so each tile's latency counts.
//
// Design of the tensor-core kernel (`flash_fwd_kernel_wgmma<T>`, T bf16 or
// f16: one source, the element type a template parameter):
//   * one CTA per ((b, h), 64 query rows): one consumer warpgroup and one
//     producer warp (two consumer warpgroups, 128 rows, were slower at both
//     main-path shapes; PERF.md section 6). The q-tile index runs in
//     reverse of blockIdx.y, which varies slowest, so the causal triangle's
//     longest tiles start first;
//   * the producer issues TMA loads (cp.async.bulk.tensor, 4-D tensor maps
//     [D, H, N, B] built per call from the caller's strides, 128-byte
//     swizzle, 64 x 64 boxes): Q once, then K and V tiles of 64 keys into a
//     four-stage ring guarded by full and empty mbarriers. TMA zero-fills
//     rows past N or M, so ragged prefill buckets need no masked loads;
//   * S = Q K^T is wgmma m64n64k16 from shared memory (both operands
//     K-major), fp32 accumulate. The online softmax runs on the accumulator
//     registers in the log2 domain (scale * log2 e folded into S, ex2),
//     row max and sum over the 4 lanes that share a row. The row sum l
//     adds P in fp32, before any rounding: the reference's P (its Pallas
//     body keeps P in fp32). P is then rounded to T in registers and is
//     the register A operand of O += P V (wgmma
//     m64n{D}k16, V MN-major in shared memory, transpose bit set), so the
//     score tile never leaves registers;
//   * the warpgroup pipelines its tiles: S_j is issued together with
//     P_{j-1} V_{j-1}, and tile j's softmax runs while that product is on
//     the tensor cores; O is rescaled for tile j after it lands;
//   * causal: the consumer stops at its diagonal tile and masks only that
//     tile (and the tile holding key M-1); masked keys get probability
//     exactly 0, never exp(-inf - -inf);
//   * epilogue: O / l rounded to T, stored for rows < N as T pairs;
//     lse = m * ln 2 + ln l.
// In f16, P below 2^-14 rounds to a subnormal and below 2^-24 to 0 (bf16
// keeps fp32's range); the tolerance against the fp32 twin counts that
// (kernels/flash_attention.py `flash_fwd_f16_tol`).
// What the design leaves for later: no second consumer warpgroup to
// ping-pong with (one's softmax under the other's products), and O is
// stored with 4-byte stores rather than through shared memory and TMA.
//
// fp32 inputs keep the first design (`flash_fwd_kernel`, fp32 FMA on the
// CUDA cores, K/V staged in shared memory as fp32): the fp32 checks on the
// card (greedy parity and training parity against the CPU, the backward's
// fp32 cases) need products rounded nowhere but in fp32, which 2-byte
// tensor-core operands would not give.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// fp32: one thread block per (b*h, 64-row q tile), fp32 FMA
// ---------------------------------------------------------------------------
//   * 4 threads per q row (256 threads); each owns a quarter of the head
//     dimension (interleaved float4 chunks) of q and of the fp32
//     accumulator, and a 2-step shuffle sums the partial dot products;
//   * K/V stream through shared memory in 32-key tiles; a tile's scores
//     stay in registers; the running max, sum and accumulator are rescaled
//     once per tile;
//   * top-left causal: the key loop stops at the tile's last row, and keys
//     past a row's position get probability exactly 0; rows past N are
//     computed but never stored, keys past M are zero-filled and masked.

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kLanes = 4;
constexpr int kThreads = kBlockQ * kLanes;
constexpr float kNegInf = -1e30f;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* q_row =
      q + b * q_sb + h * q_sh + static_cast<int64_t>(qi) * q_sn;
  const float* k_base = k + b * k_sb + h * k_sh;
  const float* v_base = v + b * v_sb + h * v_sh;

  // chunk c of this thread covers dims 4 * (lane + kLanes * c) .. +3
  float4 q_reg[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = 4 * (lane + kLanes * c);
    if (row_valid) {
      q_reg[c] = make_float4(q_row[d] * scale, q_row[d + 1] * scale,
                             q_row[d + 2] * scale, q_row[d + 3] * scale);
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
        kx = k_base[static_cast<int64_t>(kj) * k_sn + d];
        vx = v_base[static_cast<int64_t>(kj) * v_sn + d];
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
    float* o_row = o + ((static_cast<int64_t>(b) * n + qi) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 4 * (lane + kLanes * c);
      o_row[d] = acc[c].x / l_safe;
      o_row[d + 1] = acc[c].y / l_safe;
      o_row[d + 2] = acc[c].z / l_safe;
      o_row[d + 3] = acc[c].w / l_safe;
    }
    if (lane == 0) {
      lse[static_cast<int64_t>(bh) * n + qi] = m_run + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int n, int m, int heads,
                        const int64_t* st, float scale, int causal,
                        cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * heads);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  if (causal) {
    flash_fwd_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lp, n, m, heads, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale);
  } else {
    flash_fwd_kernel<D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lp, n, m, heads, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma products fed by TMA
// ---------------------------------------------------------------------------

// kRows (64): q rows per warpgroup, and keys per tile (hopper_sm90.cuh)
constexpr int kStages = 4;       // K/V ring depth

// Shared memory of one CTA. Every tile is a stack of 64-column panels of
// 64 rows x 128 B, written by TMA in the 128-byte swizzle: the layout the
// wgmma descriptors of hopper_sm90.cuh name. Panels start on 1 KB
// boundaries (the swizzle repeats every 8 rows = 1 KB). Elements are 2-byte
// words of either type: only TMA and wgmma read them.
template <int D>
struct __align__(1024) FwdSmem {
  static constexpr int kPanels = D / kPanel;
  uint16_t q[kPanels][kRows * kPanel];
  uint16_t k[kStages][kPanels][kRows * kPanel];
  uint16_t v[kStages][kPanels][kRows * kPanel];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

// one consumer warpgroup and one producer warp
constexpr int kWgmmaThreads = 128 + 32;

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kWgmmaThreads, 2)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       T* __restrict__ o,
                       float* __restrict__ lse, int n, int m, int heads,
                       float scale_log2) {
  using Smem = FwdSmem<D>;
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
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer warp: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.q[p], &q_map, &sm.q_full, p * kPanel, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) {
          // the consumers have released the tile this stage held
          mbar_wait(&sm.empty[s], ((j / kStages) + 1) & 1);
        }
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.k[s][p], &k_map, &sm.k_full[s], p * kPanel, h,
                   j * kRows, b);
        }
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.v[s][p], &v_map, &sm.v_full[s], p * kPanel, h,
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

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max (log2 domain, scaled) and this thread's partial sum, rows
  // row0 and row0 + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float sc[32];        // S of the newest tile, then its P in fp32
  uint32_t pa[16];     // P of the tile whose P V is next, T pairs

  const uint32_t q_addr = smem_u32(sm.q[0]);

  // tile j's K, or V, has landed. Waited for before wgmma_fence: a spin
  // loop between the fence and the wgmmas makes ptxas serialize them.
  auto wait_k = [&](int j) {
    mbar_wait(&sm.k_full[j % kStages], (j / kStages) & 1);
  };
  auto wait_v = [&](int j) {
    mbar_wait(&sm.v_full[j % kStages], (j / kStages) & 1);
  };
  // S_j = Q K_j^T over D in steps of 16: +32 B within a panel, next panel
  // every 4 steps (issued, not committed)
  auto issue_s = [&](int j) {
    const uint32_t k_addr = smem_u32(sm.k[j % kStages][0]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n64<T>(sc, smem_desc(q_addr + off, 16, 1024),
                   smem_desc(k_addr + off, 16, 1024), kk > 0);
    }
  };
  // O += P_j V_j over the tile's 64 keys in steps of 16 (2 KB of V rows):
  // P's registers for keys 16 kk .. 16 kk + 15 are pa[4 kk .. 4 kk + 3],
  // the wgmma A-fragment layout (issued, not committed)
  auto issue_pv = [&](int j) {
    const uint32_t v_addr = smem_u32(sm.v[j % kStages][0]);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<T, D>(o_acc, a,
                     smem_desc(v_addr + kk * 2048, kPanelBytes, 1024));
    }
  };
  // tile j's K and V may be overwritten
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[j % kStages]);
  };
  // online softmax of tile j on sc, in place: sc becomes P (fp32), the
  // running max and sums move on; returns the factor O must be rescaled by
  // in alpha. Accumulator layout: sc[i] is row row0 + 8 * ((i / 2) % 2),
  // key j * 64 + 8 * (i / 4) + col0 + i % 2.
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int key0 = j * kRows;
    const bool edge = key0 + kRows > m || (kCausal && key0 + kRows > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float t = sc[i] * scale_log2;
      if (edge) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
        if (key >= m || (kCausal && key > row)) t = -INFINITY;
      }
      sc[i] = t;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], t);
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a row are adjacent
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no unmasked key yet keeps p = 0 and alpha = 0 without
      // evaluating -inf - -inf
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = ex2(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(sc[i] - base[(i / 2) % 2]);   // masked: 2^-inf = 0
      rs[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = Elem<T>::pack(sc[2 * i], sc[2 * i + 1]);
    }
  };

  // Software pipeline within the warpgroup: S_j is issued together with
  // P_{j-1} V_{j-1}, and tile j's softmax runs while that product is still
  // on the tensor cores. Only then is O rescaled for tile j.
  float alpha[2];
  mbar_wait(&sm.q_full, 0);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wait_k(0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, alpha);
  pack_p();
  for (int j = 1; j < n_tiles; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wait_k(j);
    wait_v(j - 1);
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    issue_pv(j - 1);
    wgmma_commit();
    wgmma_wait<1>();           // S_j is in; P_{j-1} V_{j-1} may still run
    fence_regs(sc);
    softmax(j, alpha);
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(sc);            // pa is rewritten only after the wait
    release(j - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];
    pack_p();
  }
  wait_v(n_tiles - 1);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);
  release(n_tiles - 1);

  // epilogue: rows row0 and row0 + 8, columns 8 jj + col0, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    T* o_row = o + ((static_cast<int64_t>(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(o_row + 8 * jj + col0) =
          Elem<T>::pack(o_acc[4 * jj + 2 * r] * inv,
                        o_acc[4 * jj + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0) {
      lse[static_cast<int64_t>(bh) * n + row] = m_run[r] * kLn2 + logf(l_safe);
    }
  }
}

template <typename T, int D, bool kCausal>
cudaError_t launch_wgmma_kernel(const CUtensorMap* maps, void* o, void* lse,
                                int batch, int n, int m, int heads,
                                float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(FwdSmem<D>)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<T, D, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (n + kRows - 1) / kRows);
  flash_fwd_kernel_wgmma<T, D, kCausal>
      <<<grid, kWgmmaThreads, smem, stream>>>(
          maps[0], maps[1], maps[2], static_cast<T*>(o),
          static_cast<float*>(lse), n, m, heads, scale * kLog2e);
  return cudaGetLastError();
}

// the maps over q, k and v, then the instantiation for causal and D
template <typename T>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int batch, int n, int m, int heads, int head_dim,
                 const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {n, m, m};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_map(&maps[i], Elem<T>::kMap, ptrs[i], head_dim,
                               heads, rows[i], batch, st[3 * i],
                               st[3 * i + 1], st[3 * i + 2]);
    if (err != 0) return err;
  }
  cudaError_t launched;
  if (head_dim == 64) {
    launched = causal ? launch_wgmma_kernel<T, 64, true>(
                            maps, o, lse, batch, n, m, heads, scale, stream)
                      : launch_wgmma_kernel<T, 64, false>(
                            maps, o, lse, batch, n, m, heads, scale, stream);
  } else {
    launched = causal ? launch_wgmma_kernel<T, 128, true>(
                            maps, o, lse, batch, n, m, heads, scale, stream)
                      : launch_wgmma_kernel<T, 128, false>(
                            maps, o, lse, batch, n, m, heads, scale, stream);
  }
  return static_cast<int>(launched);
}

}  // namespace

// dtype: 0 = float32 (fp32 FMA kernel), 1 = bfloat16, 2 = float16 (wgmma +
// TMA kernel of that type; strides must be multiples of 8 elements and the
// bases 16-byte aligned, which the caller checks); another code returns
// cudaErrorInvalidValue.
// Strides are in elements, in the order (q: batch, seq, head), (k: ...),
// (v: ...). Returns a cudaError_t; for bf16 and f16 also 100000 when the
// CUDA driver has no cuTensorMapEncodeTiled, and 200000 + its CUresult when
// an encode fails.
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n, int m, int heads, int head_dim,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float scale, int causal, int dtype, void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || heads <= 0 ||
      batch * heads > 65535 || (head_dim != 64 && head_dim != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                         v_sb, v_sn, v_sh};
  if (dtype == 0) {
    const cudaError_t err =
        head_dim == 64 ? launch_fp32<64>(q, k, v, o, lse, batch, n, m, heads,
                                         st, scale, causal, s)
                       : launch_fp32<128>(q, k, v, o, lse, batch, n, m,
                                          heads, st, scale, causal, s);
    return static_cast<int>(err);
  }
  if (dtype == 1) {
    return launch_wgmma<__nv_bfloat16>(q, k, v, o, lse, batch, n, m, heads,
                                       head_dim, st, scale, causal, s);
  }
  if (dtype == 2) {
    return launch_wgmma<__half>(q, k, v, o, lse, batch, n, m, heads,
                                head_dim, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
