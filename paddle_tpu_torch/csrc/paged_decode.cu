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
// 64 dims x 2 B x 2 = ~25 MB a layer, ~7.5 us at 3.35 TB/s; half that with
// int8 pools) and does ~2 FLOP per byte, far below the ~295 FLOP/B where the
// tensor cores would matter. So the design is about keeping bytes in flight
// on every SM from the first microsecond to the last, and about the fixed
// costs around them: a launch, a table read, the merge of partial softmaxes.
//
// The TPU kernel runs its grid (S*H, M) in order on one core and carries
// the running max, sum and accumulator from one table entry to the next in
// scratch. Nothing carries over between CTAs on Hopper, and one CTA per
// (head, slot) -- 96 CTAs on 132 SMs at S=8, H=12, each walking its context
// in dependent sweeps -- left the card at a quarter of its memory rate. So:
//
//   * split-K over the context ("flash-decoding"): the grid is (split,
//     head, slot), and the n_split CTAs of one (slot, head) form one
//     thread block cluster of at most 8. The wrapper chooses n_split from
//     shapes alone (4 at M = 64, bs 16: spans of at most 256 tokens), never
//     from lens, so no launch waits on the device; each CTA reads lens[s]
//     and takes an equal share of the slot's positions in whole table
//     entries, so a 200-token context keeps 4 CTAs busy as a full one does;
//   * the CTA reads its length and q at once, then stages its span's
//     table entries (and, for int8 pools, the two fp32 scales of each of
//     its blocks, times 1/127, while the first copies are in flight) in
//     shared memory: scales are read once per block, not per token;
//   * K and V arrive through a ring of kStages stages in shared memory,
//     filled by cp.async (LDGSTS, 16 bytes a lane, L1 bypassed); each lane
//     copies and later reads only its own pieces, so a stage needs no
//     barrier, only cp.async.wait_group, and while a lane works on stage j
//     its copies of the next stage are in flight. A token's D-element row
//     of one head is read by D/V adjacent lanes, V = 16 B / element size
//     (8 bf16, 16 int8, 4 fp32), so a warp reads whole rows. Registers stay
//     below 80, so every CTA of the grid is resident at once;
//   * scores q.k / sqrt(D), the softmax and the accumulator are fp32; the
//     lanes' partials merge by shuffles within a warp, then across the 4
//     warps in shared memory, into one (max, sum, acc[D]) per CTA, which
//     the CTA writes into split 0's shared memory (distributed shared
//     memory). After one cluster barrier split 0 merges the live splits in
//     split order -- the same order every run, so results repeat bit for
//     bit -- and writes out. No workspace, no second kernel;
//   * a split whose span starts past lens[s] (a context shorter than
//     n_split entries) copies and writes nothing; split 0 merges only the
//     live splits, and writes out at once, with no barrier, where it is
//     the only one;
//   * masked positions carry the sentinel -1e30, not -inf: split 0 always
//     holds position 0, so every max is finite and empty groups weigh
//     exp(-1e30 - max) = exactly 0. Copies past the length are zero-filled;
//   * an inactive slot arrives with lens 0 and a table row of null block 0:
//     it reads one position of block 0 and writes finite garbage that the
//     engine never reads.
//
// int8 pools (the `quantized=True` branch of `_decode_kernel`,
// quantization/kv_cache.py): one fp32 scale per (pool block, head),
// `scales[num_blocks, H]`. A lane copies 16 int8 elements in one 16-byte
// piece, converts them exactly (the byte into the mantissa of 2^23: one
// PRMT and one FADD each) and dequantizes in registers as
// `k * (scale * (1/127))`, the order the TPU kernel and the plain twin use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;          // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCopies = 2;             // 16-byte copies a lane makes per stage
constexpr int kStages = 2;             // stages of the ring in flight
constexpr int kMaxSplits = 8;          // CTAs of one (slot, head): a cluster
constexpr int kMaxEntries = 512;       // table entries of one CTA's span
constexpr float kNegInf = -1e30f;
// the ring: per stage, K then V, each kCopies x kThreads 16-byte pieces,
// every piece written (by cp.async) and read by the same thread
constexpr int kRingPieces = kStages * 2 * kCopies * kThreads;
static_assert(kRingPieces * 16 <= 32 * 1024, "static shared memory");

// n / d for 0 <= n < 2^31 by a multiply and a shift (the divisor's magic
// number is computed once on the host)
struct FastDiv {
  uint32_t d, magic, shift;
  __device__ __forceinline__ int div(int n) const {
    const uint32_t t = __umulhi(static_cast<uint32_t>(n), magic);
    return static_cast<int>((t + static_cast<uint32_t>(n)) >> shift);
  }
};

FastDiv make_fast_div(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const uint64_t magic = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(magic), shift};
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes global -> shared, asynchronously (LDGSTS, bypassing L1); with
// `bytes` 0 nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest N groups have landed
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the address of shared variable `p` in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return out;
}

__device__ __forceinline__ void store_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x)
               : "memory");
}

// every thread of every CTA of the cluster; shared-memory writes before it
// (remote ones too) are visible to every CTA after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// 16 raw bytes of pool elements -> floats
template <typename P>
__device__ __forceinline__ void unpack(const uint4& r,
                                       float (&x)[16 / sizeof(P)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of the fp32 of the same value
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    // int8 b -> the fp32 2^23 + (b + 128) (the biased byte in the low
    // mantissa bits), minus 2^23 + 128: exact, no I2F
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t biased = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[4 * i + j] =
            __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7440 + j)) -
            8388736.0f;
      }
    }
  }
}

// N elements of q's type T at p (16-byte aligned) -> floats
template <typename T, int N>
__device__ __forceinline__ void load_q(const T* p, float (&x)[N]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const uint4 r = load16(p + c * kPer);
    float y[kPer];
    unpack<T>(r, y);
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[c * kPer + e] = y[e];
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (m, l, acc) <- the merge of two online-softmax partials, in a fixed
// order of operations, so a result repeats bit for bit from run to run
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N],
                                      float m_o, float l_o,
                                      const float (&acc_o)[N]) {
  const float m_new = fmaxf(m, m_o);
  const float w = expf(m - m_new);
  const float w_o = expf(m_o - m_new);
  l = l * w + l_o * w_o;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * w + acc_o[e] * w_o;
  m = m_new;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;
  const float* v_scales;
  const int* tables;
  const int* lens;
  void* out;
  int heads, max_blocks, span_blocks, n_split;
  FastDiv bs;
  float scale;
};

// One CTA per (split, head, slot), the splits of one (slot, head) one
// cluster. T: the type of q and out; P: the pools' type (T, or int8_t with
// the fp32 scales k_scales / v_scales [num_blocks, H], unused otherwise)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = 16 / sizeof(P);        // elements per lane per token
  constexpr int kGroup = D / kVec;            // lanes per token row
  constexpr int kPass = kThreads / kGroup;    // tokens per pass
  constexpr int kStageTok = kPass * kCopies;  // tokens per stage
  static_assert(kGroup <= 32 && 32 % kGroup == 0, "a row within a warp");
  static_assert(D <= kThreads, "one thread per output element");
  __shared__ uint4 ring[kRingPieces];  // [stage][K, V][copy][thread]
  __shared__ int tbl[kMaxEntries];
  __shared__ float ksc[kQuant ? kMaxEntries : 1];
  __shared__ float vsc[kQuant ? kMaxEntries : 1];
  __shared__ float warp_m[kWarps];
  __shared__ float warp_l[kWarps];
  __shared__ __align__(16) float warp_acc[kWarps][D];
  // the cluster's split partials, written into split 0's copy by each split
  __shared__ float part_m[kMaxSplits];
  __shared__ float part_l[kMaxSplits];
  __shared__ __align__(16) float part_acc[kMaxSplits][D];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int bs = static_cast<int>(a.bs.d);
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;

  // the length and q in flight together
  const int len = a.lens[s];
  float qv[kVec];
  load_q(static_cast<const T*>(a.q) +
             (static_cast<int64_t>(s) * a.heads + h) * D + lane * kVec,
         qv);
  // the slot's live positions, shared as evenly as whole table entries
  // allow by its n_split CTAs: a short context is split as finely as a
  // long one. At most a.span_blocks entries a CTA (n_split of those cover
  // the table), which bounds the staged entries
  const int last_pos = min(max(len, 0), a.max_blocks * bs - 1);
  const int per_split = (last_pos + a.n_split) / a.n_split;  // ceil
  const int span_blocks = min(a.span_blocks, a.bs.div(per_split + bs - 1));
  const int span = span_blocks * bs;
  const int t_begin = split * span;
  const int last = min(last_pos, t_begin + span - 1);
  const int n_live = last_pos / span + 1;  // splits holding a position
  // this span's table entries, staged before any K/V copy
  const int* table = a.tables + static_cast<int64_t>(s) * a.max_blocks +
                     split * span_blocks;
  const int span_entries =
      min(span_blocks, a.max_blocks - split * span_blocks);
  for (int i = threadIdx.x; i < span_entries; i += kThreads) {
    tbl[i] = table[i];
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] *= a.scale;
  __syncthreads();

  const int64_t tok_stride = static_cast<int64_t>(a.heads) * D;
  const int64_t blk_stride = static_cast<int64_t>(bs) * tok_stride;
  const int64_t head_off = static_cast<int64_t>(h) * D + lane * kVec;
  const P* k_pool = static_cast<const P*>(a.k_pool);
  const P* v_pool = static_cast<const P*>(a.v_pool);
  const int64_t sh = static_cast<int64_t>(s) * a.heads + h;

  // a split past the slot's length loads nothing (uniform over the CTA)
  if (t_begin <= last) {
    const int n_tok = last - t_begin + 1;
    const int n_stages = (n_tok + kStageTok - 1) / kStageTok;
    uint4* mine = ring + threadIdx.x;

    // this thread's K and V pieces of stage `st` into ring slot st % kStages
    // (zero-filled past the length), as one commit group
    auto issue = [&](int st) {
      uint4* slot = mine + (st % kStages) * 2 * kCopies * kThreads;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int r = st * kStageTok + u * kPass + g;  // position in span
        const bool valid = r < n_tok;
        const int i = a.bs.div(valid ? r : 0);
        const int64_t off = tbl[i] * blk_stride + (r - i * bs) * tok_stride +
                            head_off;
        copy16(slot + u * kThreads, k_pool + (valid ? off : 0),
               valid ? 16 : 0);
        copy16(slot + (kCopies + u) * kThreads, v_pool + (valid ? off : 0),
               valid ? 16 : 0);
      }
      copy_commit();
    };
    // every stage of the ring in flight before any is used (an empty group
    // past the last stage keeps the count of groups uniform)
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (st < n_stages) {
        issue(st);
      } else {
        copy_commit();
      }
    }
    if constexpr (kQuant) {
      // the span's scales, once per pool block, read while the K/V copies
      // are in flight
      const int n = a.bs.div(n_tok - 1) + 1;
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const int64_t si = static_cast<int64_t>(tbl[j]) * a.heads + h;
        ksc[j] = a.k_scales[si] * (1.0f / 127.0f);
        vsc[j] = a.v_scales[si] * (1.0f / 127.0f);
      }
      __syncthreads();
    }

    float m_run = kNegInf;
    float l_run = 0.f;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

    // `st` is uniform over the CTA, so every lane runs the same trip count
    // and the shuffles below are convergent
    for (int st = 0; st < n_stages; ++st) {
      copy_wait<kStages - 1>();  // stage st has landed (this thread's part)
      const uint4* slot = mine + (st % kStages) * 2 * kCopies * kThreads;
      float sc[kCopies];
      int blk[kCopies];
      bool valid[kCopies];
      float chunk_max = kNegInf;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int r = st * kStageTok + u * kPass + g;
        valid[u] = r < n_tok;
        blk[u] = a.bs.div(valid[u] ? r : 0);
        float kx[kVec];
        unpack<P>(slot[u * kThreads], kx);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          // dequantize in registers: fp K exists only there
          if constexpr (kQuant) kx[e] *= ksc[blk[u]];
          part += qv[e] * kx[e];
        }
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
      for (int u = 0; u < kCopies; ++u) {
        // masked positions get probability exactly 0 (and zero-filled V)
        const float p = valid[u] ? expf(sc[u] - m_new) : 0.f;
        l_run += p;
        float vx[kVec];
        unpack<P>(slot[(kCopies + u) * kThreads], vx);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if constexpr (kQuant) vx[e] *= vsc[blk[u]];
          acc[e] += p * vx[e];
        }
      }
      m_run = m_new;
      // the slot just read takes stage st + kStages (its own pieces only)
      if (st + kStages < n_stages) {
        issue(st + kStages);
      } else {
        copy_commit();
      }
    }

    // merge the warp's token groups by shuffles, then the warps through
    // shared memory, into the CTA's partial
#pragma unroll
    for (int off = kGroup; off < 32; off <<= 1) {
      float acc_o[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc_o[e] = __shfl_xor_sync(0xffffffffu, acc[e], off);
      }
      const float m_o = __shfl_xor_sync(0xffffffffu, m_run, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_run, off);
      merge(m_run, l_run, acc, m_o, l_o, acc_o);
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 < kGroup) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) warp_acc[warp][lane * kVec + e] = acc[e];
      if (lane == 0) {
        warp_m[warp] = m_run;
        warp_l[warp] = l_run;
      }
    }
    __syncthreads();
    if (threadIdx.x < D) {
      const int d = threadIdx.x;
      float m = warp_m[0];
      float l = warp_l[0];
      float o[1] = {warp_acc[0][d]};
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float o_w[1] = {warp_acc[w][d]};
        merge(m, l, o, warp_m[w], warp_l[w], o_w);
      }
      if (n_live == 1) {
        store(static_cast<T*>(a.out) + sh * D + d, o[0] / fmaxf(l, 1e-30f));
      } else {
        store_cluster(cluster_addr(&part_acc[split][d], 0), o[0]);
        if (d == 0) {
          store_cluster(cluster_addr(&part_m[split], 0), m);
          store_cluster(cluster_addr(&part_l[split], 0), l);
        }
      }
    }
  }
  if (n_live == 1) return;  // split 0 alone held positions: out is written

  // split 0 combines the live splits in split order: out = sum_i acc_i
  // e^(m_i - M) / sum_i l_i e^(m_i - M). It always holds position 0, so M
  // is finite; the splits past the length wrote nothing and are not read.
  cluster_sync();
  if (split == 0 && threadIdx.x < D) {
    const int d = threadIdx.x;
    float m_all = kNegInf;
    for (int i = 0; i < n_live; ++i) m_all = fmaxf(m_all, part_m[i]);
    float l_all = 0.f;
    float o = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float w = expf(part_m[i] - m_all);
      l_all += part_l[i] * w;
      o += part_acc[i][d] * w;
    }
    store(static_cast<T*>(a.out) + sh * D + d, o / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, int slots, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.heads, slots);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged_decode_split_kernel<T, P, D>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_dim(const Args& a, int slots, int head_dim,
                       cudaStream_t stream) {
  if (head_dim == 64) return launch<T, P, 64>(a, slots, stream);
  if (head_dim == 128) return launch<T, P, 128>(a, slots, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). quantized: 0 = pools of
// q's dtype (scales unused, may be null), 1 = int8 pools with fp32 scales
// [num_blocks, H]. q/out [S, H, D], pools [num_blocks, block_size, H, D],
// tables [S, M] int32, lens [S] int32 (the effective lengths: 0 for
// inactive slots). Each CTA takes `span_blocks` table entries; n_split =
// ceil(M / span_blocks) CTAs, at most 8, form one cluster per (slot,
// head). Returns a cudaError_t.
extern "C" int paddle_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scales,
                                   const void* v_scales, const void* tables,
                                   const void* lens, void* out, int slots,
                                   int heads, int head_dim, int max_blocks,
                                   int block_size, int span_blocks,
                                   int n_split, float scale, int dtype,
                                   int quantized, void* stream) {
  if (slots <= 0 || slots > 65535 || heads <= 0 || heads > 65535 ||
      max_blocks <= 0 || block_size <= 0 || span_blocks <= 0 ||
      span_blocks > kMaxEntries || n_split > kMaxSplits ||
      n_split != (max_blocks + span_blocks - 1) / span_blocks ||
      static_cast<int64_t>(max_blocks) * block_size > INT32_MAX ||
      (quantized && (!k_scales || !v_scales))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(tables),
               static_cast<const int*>(lens),
               out,
               heads,
               max_blocks,
               span_blocks,
               n_split,
               make_fast_div(static_cast<uint32_t>(block_size)),
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = quantized ? launch_dim<float, int8_t>(a, slots, head_dim, s)
                    : launch_dim<float, float>(a, slots, head_dim, s);
  } else if (dtype == 1) {
    err = quantized
              ? launch_dim<__nv_bfloat16, int8_t>(a, slots, head_dim, s)
              : launch_dim<__nv_bfloat16, __nv_bfloat16>(a, slots, head_dim,
                                                         s);
  }
  return static_cast<int>(err);
}
