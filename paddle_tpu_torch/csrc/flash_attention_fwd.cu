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
// That design is kept at D = 64 (GPT-2, ViT, serving), where its 72 KB of
// shared memory let 3 CTAs share an SM. At D = 128 the same template took
// 145 KB, so one CTA an SM: one warpgroup of 154 registers, no spills,
// and nothing to run while its softmax waited on its products (0.256 ms
// at (4, 2048, 16, 128) causal, 1.83x SDPA; PERF.md section 6).
//
// D = 128 (`flash_fwd_kernel_wgmma_d128<T, kCausal, ...>`, bf16 and f16):
//   * a CTA of three warpgroups: two consumers of 64 q rows each and a
//     producer. setmaxnreg gives the consumers 240 registers and the
//     producer 24 (launched at 168: __launch_bounds__(384, 1)). Both
//     consumers read every K/V tile, so each byte of K and V brought into
//     shared memory serves 128 rows;
//   * K/V tiles of 128 keys (two TMA boxes a 64-column panel) in a
//     two-stage ring, K and V with their own full and empty barriers: a
//     consumer releases K_j once S_j is in and V_j once P_j V_j is, so the
//     producer refills K a turn earlier (3 stages of one barrier each
//     took the same time as 2 of these). Q is one 32 KB tile;
//   * S = Q K^T is wgmma m64n128k16 from shared memory; the in-warpgroup
//     pipeline, the log2-domain online softmax, l summed from fp32 P, P as
//     the register operand of O += P V, the masks and lse are the D = 64
//     kernel's. The softmax keeps its dependency chains short (masks set
//     apart on edge tiles only, each row's max and sum in four partial
//     chains, the scale in the exponent's FFMA): with the D = 64 form the
//     exponentials held the products back by 30% (a probe with no softmax
//     at all ran in 0.110 ms against 0.157; with the short chains 0.132);
//   * epilogue: O / l rounded to T into a 32 KB tile in shared memory in
//     the 128-byte swizzle, then one thread of the warpgroup stores it by
//     TMA (rows past n are not written) while the next item starts (6%
//     faster than 4-byte stores from registers); lse as the D = 64
//     kernel's;
//   * turns at the tensor cores: warpgroup w waits on named barrier 1 + w
//     (bar.sync) before it issues S_j and P_{j-1} V_{j-1}, and arrives on
//     the other's (bar.arrive) after, so one warpgroup's softmax runs
//     while the other's products do. Both take n_tiles + 1 turns an item:
//     a warpgroup with fewer tiles (rows past n) takes turns without
//     products, each after the tile has landed, and releases every tile
//     in order;
//   * persistent: one CTA an SM walks work items ((b, h), 128 q rows)
//     head by head, the longest causal tile of a head first, in rounds
//     dealt to the CTAs forward and backward by turns (a static schedule:
//     no atomics, so the output is the same bit for bit on every launch).
//     The producer loads the next item's K_0 and Q while the consumers
//     finish the last item's products and store O. Walking the heads
//     together keeps the K/V being read within L2: with every head at
//     once (item = head fastest) the reads went to HBM and the kernel
//     took 557 MB / 3.35 TB/s (PERF.md section 6).
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

// ---------------------------------------------------------------------------
// bf16 and f16 at D = 128: two consumer warpgroups share every K/V tile
// ---------------------------------------------------------------------------

// The D = 128 kernel's configuration (tools/torch_flash_fwd_variants.py
// builds others in turns): keys per K/V tile (64 or 128), ring depth,
// whether the consumers take turns at the tensor cores, and whether one
// CTA an SM walks the work items (else one CTA an item)
constexpr int kFwd128Keys = 128;
constexpr int kFwd128Stages = 2;
constexpr bool kFwd128PingPong = true;
constexpr bool kFwd128Persistent = true;

// two consumer warpgroups (64 q rows each) and a producer warpgroup
constexpr int kFwd128Threads = 3 * 128;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: consumer warpgroup w waits on kBarTurn + w for its turn,
// and its threads meet on kBarStore + w around its O tile's store
constexpr int kBarTurn = 1;
constexpr int kBarStore = 3;

// Shared memory of one CTA: the two 64-row halves of its Q tile and of
// its O tile, and the K/V ring of kN-key tiles (a panel of a tile is kN
// rows x 128 B: 128-key
// tiles are two TMA boxes a panel, one above the other, which the 128-byte
// swizzle lays out as one 128-row box)
template <int kN, int kS>
struct __align__(1024) FwdSmem128 {
  uint16_t q[2][2][kRows * kPanel];
  uint16_t o[2][2][kRows * kPanel];   // each warpgroup's O tile, to store
  uint16_t k[kS][2][kN * kPanel];
  uint16_t v[kS][2][kN * kPanel];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kS];
  uint64_t v_full[kS];
  uint64_t k_empty[kS];
  uint64_t v_empty[kS];
};

template <typename T, bool kCausal, int kN, int kS, bool kPingPong>
__global__ void __launch_bounds__(kFwd128Threads, 1)
flash_fwd_kernel_wgmma_d128(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map,
                            float* __restrict__ lse,
                            int n, int m, int heads, int batch_heads,
                            float scale_log2) {
  constexpr int D = 128;
  using Smem = FwdSmem128<kN, kS>;
  // one 64-column panel of a K or V tile, and a whole tile
  constexpr uint32_t kKvPanelBytes = kN * kPanel * 2;
  constexpr uint32_t kKvBytes = 2 * kKvPanelBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  // The CTA's work items, each ((b, h), 128 q rows): item t is q tile
  // (n_q - 1 - t % n_q) of head t / n_q. A head's tiles run together, so
  // its K and V come from HBM once and from L2 for the rest (every head
  // at once would not fit in L2), the longest causal tile first. Round r
  // of gridDim.x items goes to the CTAs in order when r is even and in
  // reverse when odd, a static schedule whose causal sums stay level.
  // One CTA an item is the plain grid.
  const int n_q = (n + 2 * kRows - 1) / (2 * kRows);
  const int n_items = n_q * batch_heads;
  struct Item {
    int b, h, bh, q0, n_tiles;
  };
  auto item = [&](int r, Item& it) {
    const int c = (r % 2 == 0) ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
    const int t = r * gridDim.x + c;
    if (t >= n_items) return false;
    it.bh = t / n_q;
    it.b = it.bh / heads;
    it.h = it.bh - it.b * heads;
    it.q0 = (n_q - 1 - (t - it.bh * n_q)) * 2 * kRows;
    const int kv_end = kCausal ? min(m, it.q0 + 2 * kRows) : m;
    it.n_tiles = (kv_end + kN - 1) / kN;     // the item's K/V tiles
    return true;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 8);        // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 8);
      mbar_init(&sm.v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      Item it;
      // K/V tile g (counted over the CTA's items) into stage g % kS
      auto load = [&](uint16_t (&dst)[kS][2][kN * kPanel], uint64_t* full,
                      uint64_t* empty, const CUtensorMap* map, int g,
                      int j) {
        const int s = g % kS;
        if (g >= kS) {
          // the consumers have released the tile this stage held
          mbar_wait(&empty[s], ((g / kS) + 1) & 1);
        }
        mbar_expect_tx(&full[s], kKvBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int r = 0; r < kN / kRows; ++r) {
            tma_load(&dst[s][p][r * kRows * kPanel], map, &full[s],
                     p * kPanel, it.h, j * kN + r * kRows, it.b);
          }
        }
      };
      int g = 0;
      for (int r = 0; item(r, it); ++r) {
        // K_0 first: the Q buffer frees only once the last item's last
        // S is in
        load(sm.k, sm.k_full, sm.k_empty, &k_map, g, 0);
        if (r > 0) mbar_wait(&sm.q_empty, (r - 1) & 1);
        mbar_expect_tx(&sm.q_full, 4 * kPanelBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            tma_load(sm.q[half][p], &q_map, &sm.q_full, p * kPanel, it.h,
                     it.q0 + half * kRows, it.b);
          }
        }
        // K_j, then V_{j-1}: the consumers release K_j once S_j is in,
        // and V_j only once P_j V_j is, a turn later
        for (int j = 1; j <= it.n_tiles; ++j) {
          if (j < it.n_tiles) {
            load(sm.k, sm.k_full, sm.k_empty, &k_map, g + j, j);
          }
          load(sm.v, sm.v_full, sm.v_empty, &v_map, g + j - 1, j - 1);
        }
        g += it.n_tiles;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(sm.q[wg][0]);

    float o_acc[D / 2];
    float m_run[2];
    float l_run[2];
    // S of the newest tile, then its P in fp32 (each S's first k-step
    // overwrites it: zeroed once, so that it is never read undefined)
    float sc[kN / 2];
    uint32_t pa[kN / 4];   // P of the tile whose P V is next, T pairs
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
    int g = 0;             // the CTA's K/V tiles before this item
    int qw = 0;            // this warpgroup's first q row in the item
    int row0 = 0;          // this thread's rows: row0 and row0 + 8

    // Turns at the tensor cores: warpgroup 0 issues its products, then
    // warpgroup 1, then 0 again, so that one's softmax runs while the
    // other's products do. A turn waits on the warpgroup's own barrier,
    // which the other warpgroup's end of turn (bar.arrive) completes.
    auto turn_begin = [&]() {
      if constexpr (kPingPong) bar_sync(kBarTurn + wg, 256);
    };
    auto turn_end = [&]() {
      if constexpr (kPingPong) bar_arrive(kBarTurn + 1 - wg, 256);
    };
    // the item's tile j: its K, or V, has landed. Waited for before
    // wgmma_fence and the turn: a spin loop between the fence and the
    // wgmmas makes ptxas serialize them.
    auto wait_k = [&](int j) {
      mbar_wait(&sm.k_full[(g + j) % kS], ((g + j) / kS) & 1);
    };
    auto wait_v = [&](int j) {
      mbar_wait(&sm.v_full[(g + j) % kS], ((g + j) / kS) & 1);
    };
    // S_j = Q K_j^T over D in steps of 16 (issued, not committed)
    auto issue_s = [&](int j) {
      const uint32_t k_addr = smem_u32(sm.k[(g + j) % kS][0]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss<T, kN>(sc,
                        smem_desc(q_addr + (kk / 4) * kPanelBytes + col, 16,
                                  1024),
                        smem_desc(k_addr + (kk / 4) * kKvPanelBytes + col, 16,
                                  1024),
                        kk > 0);
      }
    };
    // O += P_j V_j over the tile's keys in steps of 16 (2 KB of V rows):
    // P's registers for keys 16 kk .. 16 kk + 15 are pa[4 kk .. 4 kk + 3]
    auto issue_pv = [&](int j) {
      const uint32_t v_addr = smem_u32(sm.v[(g + j) % kS][0]);
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<T, D>(o_acc, a,
                       smem_desc(v_addr + kk * 2048, kKvPanelBytes, 1024));
      }
    };
    // the item's tile j: its K, or V, may be overwritten; the Q tile, once
    // this warpgroup's last S of the item is in
    auto release_k = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.k_empty[(g + j) % kS]);
    };
    auto release_v = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.v_empty[(g + j) % kS]);
    };
    auto release_q = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.q_empty);
    };
    // online softmax of tile j on sc, in place: sc[i] is row row0 + 8 *
    // ((i / 2) % 2), key j * kN + 8 * (i / 4) + col0 + i % 2. The D = 64
    // kernel's arithmetic with shorter dependency chains: masked keys are
    // set apart on edge tiles only, each row's max and sum run in four
    // partial chains, and the scale rides in the exponent's FFMA
    // (m_run is in the log2 domain, the scores are raw).
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int key0 = j * kN;
      if (key0 + kN > m || (kCausal && key0 + kN > qw)) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
          if (key >= m || (kCausal && key > row)) sc[i] = -INFINITY;
        }
      }
      float mx[2][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) mx[c / 4][c % 4] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        float& x = mx[(i / 2) % 2][(i / 4) % 4];
        x = fmaxf(x, sc[i]);
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        // the 4 lanes of a row are adjacent
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m_run[r], x * scale_log2);
        // a row with no unmasked key yet keeps p = 0 and alpha = 0
        // without evaluating -inf - -inf
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m_run[r] - base[r]);
        m_run[r] = m_new;
      }
      float rs[2][4] = {};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        // masked: 2^-inf = 0
        sc[i] = ex2(fmaf(sc[i], scale_log2, -base[(i / 2) % 2]));
        rs[(i / 2) % 2][(i / 4) % 4] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = l_run[r] * alpha[r] +
                   ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) {
        pa[i] = Elem<T>::pack(sc[2 * i], sc[2 * i + 1]);
      }
    };

    // warpgroup 0 takes the first turn
    if (kPingPong && wg == 1) bar_arrive(kBarTurn, 256);
    Item it;
    for (int r = 0; item(r, it); ++r) {
      // this warpgroup's q rows qw .. qw + 63, and its tiles: the item's
      // first n_w (none past n)
      qw = it.q0 + wg * kRows;
      row0 = qw + 16 * warp + lane / 4;
      const int kv_end_w = kCausal ? min(m, qw + kRows) : m;
      const int n_w = qw < n ? (kv_end_w + kN - 1) / kN : 0;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_run[i] = -INFINITY;
        l_run[i] = 0.f;
      }
      // Each warpgroup takes n_tiles + 1 turns an item. With tiles of its
      // own (n_w > 0): S_0; then S_j with P_{j-1} V_{j-1} (tile j's
      // softmax runs while that product is still on the tensor cores;
      // only then is O rescaled for tile j); then the last P V. The tiles
      // it has none of (the causal diagonal's last 64 keys, or all where
      // its rows are past n) are turns without products, each after the
      // tile has landed, so that every consumer warp releases every tile
      // in order.
      mbar_wait(&sm.q_full, r & 1);
      int j_done = 0;
      if (n_w > 0) {
        float alpha[2];
        wait_k(0);
        turn_begin();
        wgmma_fence();
        issue_s(0);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        release_k(0);
        if (n_w == 1) release_q();
        softmax(0, alpha);
        pack_p();
        for (int j = 1; j < n_w; ++j) {
          wait_k(j);
          wait_v(j - 1);
          turn_begin();
          wgmma_fence();
          issue_s(j);
          wgmma_commit();
          issue_pv(j - 1);
          wgmma_commit();
          turn_end();
          wgmma_wait<1>();         // S_j is in; P_{j-1} V_{j-1} may still run
          fence_regs(sc);
          release_k(j);
          if (j == n_w - 1) release_q();
          softmax(j, alpha);
          wgmma_wait<0>();
          fence_regs(o_acc);
          fence_regs(sc);          // pa is rewritten only after the wait
          release_v(j - 1);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];
          pack_p();
        }
        wait_v(n_w - 1);
        turn_begin();
        wgmma_fence();
        issue_pv(n_w - 1);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(o_acc);
        release_v(n_w - 1);
        j_done = n_w;
      } else {
        release_q();
        turn_begin();
        turn_end();
      }
      for (int j = j_done; j < it.n_tiles; ++j) {
        wait_k(j);
        wait_v(j);
        turn_begin();
        turn_end();
        release_k(j);
        release_v(j);
      }

      // epilogue through shared memory: the warpgroup's 64 x 128 O tile
      // in the 128-byte swizzle (16-byte chunk c of row r at chunk
      // c ^ (r % 8)), then one thread's TMA store (rows past n are not
      // written), which runs on while the next item starts
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) bulk_wait_read<0>();   // the last item's store has read it
      bar_sync(kBarStore + wg, 128);
      uint8_t* ob = reinterpret_cast<uint8_t*>(sm.o[wg][0]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float l = l_run[rr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = 16 * warp + lane / 4 + 8 * rr;
        const float l_safe = fmaxf(l, 1e-30f);
        const float inv = 1.f / l_safe;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const uint32_t off = (jj / 8) * kPanelBytes + r * 128 +
                               (((jj % 8) ^ (r % 8)) * 16) + col0 * 2;
          *reinterpret_cast<uint32_t*>(ob + off) =
              Elem<T>::pack(o_acc[4 * jj + 2 * rr] * inv,
                            o_acc[4 * jj + 2 * rr + 1] * inv);
        }
        const int row = row0 + 8 * rr;
        if (row < n && lane % 4 == 0) {
          lse[static_cast<int64_t>(it.bh) * n + row] =
              m_run[rr] * kLn2 + logf(l_safe);
        }
      }
      fence_proxy_async();
      bar_sync(kBarStore + wg, 128);
      if (issuer) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_store(&o_map, sm.o[wg][p], p * kPanel, it.h, qw, it.b);
        }
        bulk_commit();
      }
      g += it.n_tiles;
    }
    // the last bar_arrive of warpgroup 1 on warpgroup 0's barrier
    if (kPingPong && wg == 0) bar_sync(kBarTurn, 256);
    // the last store has run before the CTA's shared memory is freed
    if (threadIdx.x % 128 == 0) bulk_wait_all();
  }
}

// maps: q, k, v and the output O
template <typename T, bool kCausal>
cudaError_t launch_wgmma_d128(const CUtensorMap* maps, void* lse, int batch,
                              int n, int m, int heads, float scale,
                              cudaStream_t stream) {
  auto* kernel =
      flash_fwd_kernel_wgmma_d128<T, kCausal, kFwd128Keys, kFwd128Stages,
                                  kFwd128PingPong>;
  const int smem =
      static_cast<int>(sizeof(FwdSmem128<kFwd128Keys, kFwd128Stages>)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = batch * heads * ((n + 2 * kRows - 1) / (2 * kRows));
  int ctas = items;
  if (kFwd128Persistent) {
    // one CTA an SM, each walking its share of the items
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    ctas = items < sms ? items : sms;
  }
  kernel<<<ctas, kFwd128Threads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), n, m,
      heads, batch * heads, scale * kLog2e);
  return cudaGetLastError();
}

// the maps over q, k and v, then the instantiation for causal and D
template <typename T>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int batch, int n, int m, int heads, int head_dim,
                 const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {n, m, m};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_map(&maps[i], Elem<T>::kMap, ptrs[i], head_dim,
                               heads, rows[i], batch, st[3 * i],
                               st[3 * i + 1], st[3 * i + 2]);
    if (err != 0) return err;
  }
  cudaError_t launched;
  if (head_dim == 128) {
    // the D = 128 kernel stores O through TMA: the contiguous output
    const int err = encode_map(&maps[3], Elem<T>::kMap, o, head_dim, heads, n,
                               batch, static_cast<int64_t>(n) * heads * 128,
                               heads * 128, 128);
    if (err != 0) return err;
  }
  if (head_dim == 64) {
    launched = causal ? launch_wgmma_kernel<T, 64, true>(
                            maps, o, lse, batch, n, m, heads, scale, stream)
                      : launch_wgmma_kernel<T, 64, false>(
                            maps, o, lse, batch, n, m, heads, scale, stream);
  } else {
    launched = causal ? launch_wgmma_d128<T, true>(maps, lse, batch, n, m,
                                                   heads, scale, stream)
                      : launch_wgmma_d128<T, false>(maps, lse, batch, n, m,
                                                    heads, scale, stream);
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
// What the tensor-core kernel of (head_dim, dtype 1 or 2, causal) takes on
// this card: out[0] CTAs an SM at its launch's shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread at launch, out[2] local (spilled) bytes a thread, out[3] dynamic
// shared memory bytes, out[4] threads a CTA. Returns a cudaError_t.
extern "C" int paddle_flash_attention_fwd_info(int head_dim, int dtype,
                                               int causal, int* out) {
  if ((head_dim != 64 && head_dim != 128) || dtype < 1 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem64 = static_cast<int>(sizeof(FwdSmem<64>)) + 1024;
  const int smem128 =
      static_cast<int>(sizeof(FwdSmem128<kFwd128Keys, kFwd128Stages>)) + 1024;
#define FWD_INFO(T, C)                                                        \
  head_dim == 64                                                              \
      ? kernel_info(flash_fwd_kernel_wgmma<T, 64, C>, kWgmmaThreads, smem64,  \
                    out)                                                      \
      : kernel_info(flash_fwd_kernel_wgmma_d128<T, C, kFwd128Keys,            \
                                                kFwd128Stages,                \
                                                kFwd128PingPong>,             \
                    kFwd128Threads, smem128, out)
  cudaError_t err;
  if (dtype == 1) {
    err = causal ? FWD_INFO(__nv_bfloat16, true) : FWD_INFO(__nv_bfloat16, false);
  } else {
    err = causal ? FWD_INFO(__half, true) : FWD_INFO(__half, false);
  }
#undef FWD_INFO
  return static_cast<int>(err);
}

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
