// The sampler's processors for Hopper (sm_90a), plain C interface for
// ctypes: repetition penalty, temperature, and the top-k and top-p
// thresholds, for every sampled row (temperature > 0) of [S, V] fp32
// logits, written into a [S, V] buffer that the keyed draw reads.
//
// Replaces: no Pallas kernel. The reference leaves the filter to XLA
// (paddle_tpu/serving/sampling.py:141-166, `_stoch`: one jnp.sort, a
// softmax, a cumsum, the thresholds); the port's plain version is
// `sampler_filter_reference` (kernels/sampler_filter.py), the same sort
// and scan in PyTorch. For a sampled row s, with C history entries:
//   lg    = logits, each seen id (a valid history entry, clamped to
//           [0, V - 1]) x / pen if x > 0 else x * pen; then lg / max(T,
//           1e-6), every division IEEE (__fdiv_rn), no contraction
//   k_th  = the k-th largest lg, k clamped to [1, V]   (-1e30 if k = 0)
//   p_th  = the smallest lg value v with mass(lg > v) < top_p, the mass
//           the softmax of lg                          (-1e30 if p >= 1)
//   out   = lg < max(k_th, p_th) ? -1e30 : lg
// p_th is the reference's sorted[n_keep - 1], n_keep = max(1, #{j :
// exclusive_mass_j < top_p}): the exclusive mass of the first sorted
// occurrence of v is mass(lg > v), and it grows along the sorted row.
// Greedy rows are left unwritten (the draw reads their raw logits).
//
// What bounds it on an H100: bytes. Each sampled row's V x 4 bytes of
// logits read and V x 4 written once, and its history (int32) and valid
// flags (bool) read once: 2 rows of 50304 over 1024 positions, 0.81 MB,
// 0.24 us at 3.35 TB/s. Its arithmetic (a division or two, an exp and
// four histogram passes an element) is far below the card's rates: what
// it pays for is latency, the row's passes one after another.
//
// Design: no sort and no scan. Each sampled row is one thread block
// cluster of P CTAs of 1024 threads (P = 8 at V = 50304, the keyed draw's
// plan: timed in turns on the H100 against 4 CTAs and CTAs of 512
// threads, tools/torch_sampler_grids.py, 8 x 1024 was the fastest at 2
// and at 8 of 8 rows sampled), each CTA a
// contiguous slice of ceil(V / P) elements, kept in shared memory as lg
// and as its probability in fixed point. Both thresholds come from radix
// select over the order-preserving uint32 image of each float, MSB first,
// 8-bit digits, 4 passes: a pass builds the CTA's histograms of the
// elements that match the prefix chosen so far (shared-memory integer
// atomics into one of 4 copies by warp, since the first passes put most
// elements into a few digits: counts for top-k, masses in 16-bit halves
// for top-p), every CTA reads the P histograms through distributed shared
// memory after one cluster barrier (all loads in flight at once), and two
// warps walk the 256 digits from the top to the digit where the count
// above reaches k (warp 0) and the mass above reaches top_p (warp 1). The
// histograms alternate between two buffers, so a pass's barrier also
// orders the previous pass's reads before their buffer is cleared.
// Determinism: each CTA's max, min and softmax sum are reduced in a fixed
// order (each thread, a shuffle tree, warp 0 over the warps), the row's
// normaliser sum_r Z_r exp(m_r - M) in fp64 over a fixed shuffle tree of
// the CTAs, and each probability enters the mass histograms as an
// integer, round(p x 2^32): no float atomics, so no threshold depends on
// the order in which atomics land, and a seed's stream is the same in
// every run. The mass differs from the reference's float32 cumsum over
// the sorted row by the fixed point's rounding and expf's ulp, so the two
// may choose differently only where the exclusive mass of a value's first
// sorted occurrence lies within that margin of top_p
// (kernels/sampler_filter.py MARGIN; chip_smoke.py counts such rows).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster_sm90.cuh"

namespace {

constexpr int kThreads = 1024;             // threads of a CTA
constexpr int kMaxCtas = 8;                // CTAs of one row: a cluster
constexpr int kBins = 256;                 // 8-bit digits, 4 passes
constexpr int kCopies = 4;                 // a CTA's histograms, by warp % 4
constexpr float kNegInf = -1e30f;          // the reference's _NEG_INF
constexpr unsigned kAll = 0xFFFFFFFFu;     // every lane of a warp
// threads 0-255 merge the counts and 256-511 the masses
static_assert(kThreads >= 2 * kBins, "a CTA merges both histograms");

// float -> uint32 in the same order (negatives flipped, positives' sign
// bit set), and back
__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu));
}

// the sum of the cluster's `ctas` CTAs' copies of shared variable `x`, in
// rank order, all loads in flight at once (a result is used only after the
// last load is issued; the loop is unrolled, so `v` stays in registers)
__device__ __forceinline__ unsigned long long gather_sum(const uint32_t& x,
                                                         int ctas) {
  uint32_t v[kMaxCtas];
#pragma unroll
  for (int r = 0; r < kMaxCtas; ++r) {
    if (r < ctas) v[r] = cluster::load_u32(cluster::addr(&x, r));
  }
  unsigned long long sum = 0;
#pragma unroll
  for (int r = 0; r < kMaxCtas; ++r) {
    if (r < ctas) sum += v[r];
  }
  return sum;
}

// the CTA's sum (max with kMax) of v, in a fixed order: a shuffle tree in
// each warp, then warp 0 over the warps in order; every thread gets it
template <bool kMax, typename T>
__device__ __forceinline__ T block_reduce(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](T a, T b) {
    if constexpr (kMax) {
      return fmaxf(a, b);
    } else {
      return a + b;
    }
  };
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  }
  __syncthreads();                          // scratch's last readers are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = scratch[0];
    for (int w = 1; w < kThreads / 32; ++w) v = op(v, scratch[w]);
    if (lane == 0) scratch[kThreads / 32] = v;
  }
  __syncthreads();
  return scratch[kThreads / 32];
}

struct Select {
  uint32_t prefix;                          // the digits chosen so far
  unsigned long long above;                 // count or mass above them
  unsigned long long target;                // k, or ceil(top_p x 2^32)
  int found;                                // 0: the walk found no digit
};

// one pass of one select, by warp 0: the first digit from the top at
// which `above` + the merged bins reach `target`; bins[d] of digit d
__device__ __forceinline__ void walk(Select& sel,
                                     const unsigned long long* bins,
                                     int shift) {
  const int lane = threadIdx.x & 31;
  // lane l holds digits 255 - 8 l .. 248 - 8 l, from the top
  unsigned long long own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) own += bins[255 - 8 * lane - j];
  unsigned long long incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += o;
  }
  const bool reach = sel.above + incl >= sel.target;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, reach);
  if (ballot == 0) {
    sel.found = 0;
    return;
  }
  const int first = __ffs(ballot) - 1;
  if (lane == first) {
    unsigned long long acc = sel.above + incl - own;
    for (int j = 0; j < 8; ++j) {
      const int d = 255 - 8 * lane - j;
      if (acc + bins[d] >= sel.target) {
        sel.prefix |= static_cast<uint32_t>(d) << shift;
        sel.above = acc;
        break;
      }
      acc += bins[d];
    }
  }
  sel.prefix = __shfl_sync(0xFFFFFFFFu, sel.prefix, first);
  sel.above = __shfl_sync(0xFFFFFFFFu, sel.above, first);
}

__global__ void __launch_bounds__(kThreads)
sampler_filter_kernel(const float* __restrict__ logits,
                      const float* __restrict__ temps,
                      const int32_t* __restrict__ top_k,
                      const float* __restrict__ top_p,
                      const float* __restrict__ penalty,
                      const int32_t* __restrict__ history, long long hist_ld,
                      const uint8_t* __restrict__ valid, long long valid_ld,
                      int context, float* __restrict__ out, int vocab) {
  const int s = blockIdx.y;
  const float t = temps[s];
  if (!(t > 0.0f)) return;                  // greedy: every CTA of the row
  const int rank = blockIdx.x;              // == the CTA's rank in its cluster
  const int ctas = gridDim.x;
  const int tid = threadIdx.x;
  const int chunk = (vocab + ctas - 1) / ctas;
  const int lo = min(vocab, rank * chunk);
  const int n = min(vocab, lo + chunk) - lo;  // 0 at a ragged end
  const size_t row = static_cast<size_t>(s) * vocab;

  extern __shared__ __align__(16) unsigned char smem[];
  float* lg = reinterpret_cast<float*>(smem);
  uint32_t* mass = reinterpret_cast<uint32_t*>(lg + chunk);
  uint32_t* seen = mass + chunk;            // one bit an element
  // two buffers of kCopies histograms: counts, and the masses' low and
  // high 16 bits (32-bit atomics; a CTA's sums fit in 32 bits)
  __shared__ uint32_t cnt[2][kCopies][kBins];
  __shared__ uint32_t mlo[2][kCopies][kBins];
  __shared__ uint32_t mhi[2][kCopies][kBins];
  __shared__ unsigned long long merged[2][kBins];
  __shared__ float red_f[kThreads / 32 + 1];
  __shared__ double red_d[kThreads / 32 + 1];
  __shared__ uint32_t part_u[2];            // this CTA's max and min,
  __shared__ unsigned long long part_d;     // and its softmax sum (bits)
  __shared__ float row_f[2];                // the row's max and min,
  __shared__ double row_d;                  // and its softmax sum
  __shared__ Select sel_s[2];               // top-k, top-p

  // the penalty's seen ids of this slice
  const int words = (chunk + 31) / 32;
  for (int w = tid; w < words; w += kThreads) seen[w] = 0u;
  __syncthreads();
  const float pen = penalty[s];
  for (int j = tid; j < context; j += kThreads) {
    if (valid[s * valid_ld + j]) {
      const int id = min(max(history[s * hist_ld + j], 0), vocab - 1) - lo;
      if (id >= 0 && id < n) atomicOr(&seen[id >> 5], 1u << (id & 31));
    }
  }
  __syncthreads();
  const float tdiv = fmaxf(t, 1e-6f);
  float mx = -CUDART_INF_F, mn_local = CUDART_INF_F;
  for (int i = tid; i < n; i += kThreads) {
    float x = logits[row + lo + i];
    if (seen[i >> 5] & (1u << (i & 31))) {
      x = x > 0.0f ? __fdiv_rn(x, pen) : __fmul_rn(x, pen);
    }
    x = __fdiv_rn(x, tdiv);
    lg[i] = x;
    mx = fmaxf(mx, x);
    mn_local = fminf(mn_local, x);
  }
  const int k = top_k[s];
  const float p = top_p[s];
  const bool need_k = k > 0, need_p = p < 1.0f;
  float thresh = kNegInf;
  if (need_k || need_p) {
    unsigned long long p_target = 0;
    float mn = 0.0f;
    double scale = 0.0;        // exp(lg - m_r) -> round(p x 2^32)
    if (need_p) {
      // softmax: each CTA's max m_r and sum of exp(lg - m_r); the row's
      // max M, normaliser Z = sum_r Z_r exp(m_r - M) (fp64, a fixed
      // order) and min after one cluster barrier; round(p x 2^32) an
      // element is taken in the first pass
      mx = block_reduce<true>(mx, red_f);
      double sum = 0.0;
      for (int i = tid; i < n; i += kThreads) {
        const float e = expf(__fsub_rn(lg[i], mx));
        mass[i] = __float_as_uint(e);
        sum += e;
      }
      sum = block_reduce<false>(sum, red_d);
      mn = -block_reduce<true>(-mn_local, red_f);
      if (tid == 0) {
        part_u[0] = __float_as_uint(mx);
        part_u[1] = __float_as_uint(mn);
        part_d = static_cast<unsigned long long>(__double_as_longlong(sum));
      }
      cluster::sync();
      if (tid < 32) {
        // lane r reads CTA r's max, min and sum; the max and min over the
        // lanes, then the normaliser's terms summed in a fixed tree
        const bool has = tid < ctas;
        const float m_r = has ? __uint_as_float(cluster::load_u32(
                                    cluster::addr(&part_u[0], tid)))
                              : -CUDART_INF_F;
        const float lo_r = has ? __uint_as_float(cluster::load_u32(
                                     cluster::addr(&part_u[1], tid)))
                               : CUDART_INF_F;
        const double z_r = has ? __longlong_as_double(static_cast<long long>(
                                     cluster::load_u64(
                                         cluster::addr(&part_d, tid))))
                               : 0.0;
        float top = m_r, low = lo_r;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          top = fmaxf(top, __shfl_xor_sync(kAll, top, off));
          low = fminf(low, __shfl_xor_sync(kAll, low, off));
        }
        // an empty slice (m_r = -inf, Z_r = 0) adds nothing
        double term = z_r > 0.0 ? z_r * exp(static_cast<double>(m_r) - top)
                                : 0.0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          term += __shfl_xor_sync(kAll, term, off);
        }
        if (tid == 0) {
          row_f[0] = top;
          row_f[1] = low;
          row_d = term;
        }
      }
      __syncthreads();
      mn = row_f[1];
      scale = mx == -CUDART_INF_F ? 0.0
          : exp(static_cast<double>(mx) - row_f[0]) * 4294967296.0 / row_d;
      p_target = static_cast<unsigned long long>(
          ceil(static_cast<double>(p) * 4294967296.0));
    }
    for (int d = tid; d < kCopies * kBins; d += kThreads) {
      cnt[0][0][d] = 0u;
      mlo[0][0][d] = 0u;
      mhi[0][0][d] = 0u;
    }
    if (tid == 0) {
      sel_s[0] = {0u, 0ull,
                  static_cast<unsigned long long>(min(k, vocab)), 1};
      sel_s[1] = {0u, 0ull, p_target, 1};
    }
    __syncthreads();
    const int copy = (tid >> 5) % kCopies;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const uint32_t mask = pass == 0 ? 0u : ~0u << (shift + 8);
      const int b = pass & 1;
      const uint32_t pre_k = sel_s[0].prefix, pre_p = sel_s[1].prefix;
      const bool live_p = need_p && sel_s[1].found;
      // each warp adds into one of kCopies histograms: the early passes
      // put most of a slice into a few digits
      for (int i = tid; i < n; i += kThreads) {
        const uint32_t key = to_key(lg[i]);
        const int d = (key >> shift) & (kBins - 1);
        if (need_k && (key & mask) == pre_k) {
          atomicAdd(&cnt[b][copy][d], 1u);
        }
        if (live_p && (key & mask) == pre_p) {
          uint32_t m;
          if (pass == 0) {
            // the probability in fixed point, kept for the later passes
            const double q = static_cast<double>(__uint_as_float(mass[i]))
                             * scale;
            m = static_cast<uint32_t>(fmin(rint(q), 4294967295.0));
            mass[i] = m;
          } else {
            m = mass[i];
          }
          if (m != 0u) {
            atomicAdd(&mlo[b][copy][d], m & 0xFFFFu);
            atomicAdd(&mhi[b][copy][d], m >> 16);
          }
        }
      }
      // the CTA's copies folded into copy 0, which the cluster reads
      __syncthreads();
      if (tid < kBins) {
        cnt[b][0][tid] += cnt[b][1][tid] + cnt[b][2][tid] + cnt[b][3][tid];
      } else if (tid < 2 * kBins) {
        const int d = tid - kBins;
        mlo[b][0][d] += mlo[b][1][d] + mlo[b][2][d] + mlo[b][3][d];
        mhi[b][0][d] += mhi[b][1][d] + mhi[b][2][d] + mhi[b][3][d];
      }
      cluster::sync();
      // every CTA merges the cluster's histograms (threads 0-255 the
      // counts, 256-511 the masses) and clears the other buffer for the
      // next pass: every CTA read it in the previous pass, before this
      // pass's barrier
      if (tid < kBins) {
        if (need_k) merged[0][tid] = gather_sum(cnt[b][0][tid], ctas);
        for (int c = 0; c < kCopies; ++c) cnt[b ^ 1][c][tid] = 0u;
      } else if (tid < 2 * kBins) {
        const int d = tid - kBins;
        if (live_p) {
          merged[1][d] = (gather_sum(mhi[b][0][d], ctas) << 16)
                         + gather_sum(mlo[b][0][d], ctas);
        }
        for (int c = 0; c < kCopies; ++c) {
          mlo[b ^ 1][c][d] = 0u;
          mhi[b ^ 1][c][d] = 0u;
        }
      }
      __syncthreads();
      // warp 0 walks top-k's digits, warp 1 top-p's
      const int w = tid >> 5;
      if (w < 2 && (w == 0 ? need_k : live_p)) {
        Select sel = sel_s[w];
        walk(sel, merged[w], shift);
        if ((tid & 31) == 0) sel_s[w] = sel;
      }
      __syncthreads();
    }
    cluster::sync();               // no CTA leaves while another reads it
    const float k_th = need_k ? from_key(sel_s[0].prefix) : kNegInf;
    // top_p beyond the whole fixed-point mass keeps the row: its minimum
    const float p_th = !need_p ? kNegInf
                       : sel_s[1].found ? from_key(sel_s[1].prefix) : mn;
    thresh = fmaxf(k_th, p_th);
  }
  for (int i = tid; i < n; i += kThreads) {
    out[row + lo + i] = lg[i] < thresh ? kNegInf : lg[i];
  }
}

// the launch, or cudaErrorInvalidValue for a shape it does not take
int filter(const void* logits, const void* temps, const void* top_k,
           const void* top_p, const void* penalty, const void* history,
           long long hist_ld, const void* valid, long long valid_ld,
           int context, void* out, int slots, int vocab,
           cudaStream_t stream) {
  if (slots <= 0 || vocab <= 0 || context < 0 || slots > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one CTA a row for every kThreads indices, at most a cluster of 8
  const int ctas = min(kMaxCtas, (vocab + kThreads - 1) / kThreads);
  const int chunk = (vocab + ctas - 1) / ctas;
  const size_t smem = static_cast<size_t>(chunk) * 8 + (chunk + 31) / 32 * 4;
  return cluster::launch<sampler_filter_kernel>(
      ctas, slots, kThreads, smem, stream, static_cast<const float*>(logits),
      static_cast<const float*>(temps), static_cast<const int32_t*>(top_k),
      static_cast<const float*>(top_p), static_cast<const float*>(penalty),
      static_cast<const int32_t*>(history), hist_ld,
      static_cast<const uint8_t*>(valid), valid_ld, context,
      static_cast<float*>(out), vocab);
}

}  // namespace

extern "C" int paddle_sampler_filter(const void* logits, const void* temps,
                                     const void* top_k, const void* top_p,
                                     const void* penalty,
                                     const void* history, long long hist_ld,
                                     const void* valid, long long valid_ld,
                                     int context, void* out, int slots,
                                     int vocab, void* stream) {
  return filter(logits, temps, top_k, top_p, penalty, history, hist_ld,
                valid, valid_ld, context, out, slots, vocab,
                static_cast<cudaStream_t>(stream));
}
