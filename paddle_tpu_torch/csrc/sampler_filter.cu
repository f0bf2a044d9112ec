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
// 0.24 us at 3.35 TB/s. Its arithmetic (a division or two and an exp an
// element) is far below the card's rates: what it pays for is latency,
// the barriers between its phases.
//
// Design. Each sampled row is one thread block cluster of P CTAs of 1024
// threads (P = 8 at V = 50304: timed in turns on the H100 against 4 CTAs
// and CTAs of 512 threads, tools/torch_sampler_grids.py), each CTA a
// contiguous slice of ceil(V / P) elements kept in shared memory as lg.
// The load pass also keeps each thread's max and min, folded over the
// warp by shuffles; each thread then sums exp(lg - the warp's max) over
// its elements again (no barrier: its own shared memory), folded over the
// warp by shuffles and over the CTA's warps by warp 0 before the first
// cluster barrier; after it, warp 0 of each CTA reads the P CTAs'
// statistics through distributed shared memory: the row's max M, min and
// normaliser Z (fp64, a fixed order). Then one of three routes, the same
// for every CTA of the row:
//   * candidates (0 < k <= P x 32, the number of warps): with k > 0 the
//     threshold depends only on the k largest values and Z: if n_keep >= k
//     it is k_th, else p_th = sorted[n_keep - 1], one of the first k. So:
//     w = the min over the CTAs of each CTA's ceil(k / P)-th largest warp
//     maximum is at most k_th (each CTA has that many warps, disjoint,
//     whose max is >= w: k elements >= w in all); every element >= w is
//     pushed into rank 0's shared memory (a warp's one atomic add on rank
//     0's counter through distributed shared memory, then its stores);
//     after the second cluster barrier rank 0 ranks the candidates (each
//     thread counts the candidates above its own, ties by slot), takes
//     k_th = cand[k - 1] and the first k masses round(exp(x - M) / Z x
//     2^32) (fp64) in an integer scan, finds n_keep, and stores the
//     threshold into every CTA; a third cluster barrier, then the write.
//     Ranking orders values, so the threshold does not depend on the
//     order in which candidates landed; the masses are integers;
//   * overflow: more than kMaxCand candidates (ties at w): the radix
//     select below;
//   * radix (k = 0 with top_p < 1, or k above the warps): radix select
//     over the order-preserving uint32 image of each float, MSB first,
//     kDigitBits-bit digits: each pass builds the CTA's histograms of the
//     elements that match the prefix chosen so far (shared-memory integer
//     atomics, counts for top-k, each probability's round(p x 2^32) in
//     16-bit halves for top-p, from the exps the statistics kept), every
//     CTA reads the P histograms through
//     distributed shared memory after one cluster barrier, and two warps
//     walk the digits from the top to the one where the count above
//     reaches k (warp 0) and the mass above reaches top_p (warp 1);
// rows with neither top-k nor top-p are written as they load.
// Determinism: every statistic is reduced in a fixed order and every mass
// is an integer, so no threshold depends on the order in which atomics
// land, and a seed's stream is the same in every run. The masses differ
// from the reference's float32 cumsum over the sorted row by the fixed
// point's rounding and exp's ulps, so the two may choose differently only
// where the exclusive mass of a value's first sorted occurrence lies
// within that margin of top_p (kernels/sampler_filter.py MARGIN;
// chip_smoke.py counts such rows).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster_sm90.cuh"

namespace {

constexpr int kThreads = 1024;             // threads of a CTA
constexpr int kMaxCtas = 8;                // CTAs of one row: a cluster
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;              // the radix route's digits
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = (32 + kDigitBits - 1) / kDigitBits;
constexpr int kCopies = kBins <= 256 ? 4 : 1;  // histograms, by warp
constexpr int kMaxCand = kThreads;         // candidates: one a thread
constexpr int kMaxTop = kMaxCtas * kWarps;     // the largest k they serve
constexpr float kNegInf = -1e30f;          // the reference's _NEG_INF
constexpr unsigned kAll = 0xFFFFFFFFu;     // every lane of a warp
static_assert(kWarps <= 32, "warp 0 folds a CTA's warps");
static_assert(kBins % 32 == 0, "a lane walks kBins / 32 digits");

// what each row took (kernels/sampler_filter.py ROUTES)
enum Route : int32_t {
  kGreedy = 0, kUncut = 1, kCandidates = 2, kOverflow = 3, kRadix = 4
};

// the radix route's histograms in dynamic shared memory, before the slice:
// merged[2][kBins] (u64), then counts, masses' low and high halves, each
// [2 buffers][kCopies][kBins] (u32); the candidates route's values and
// sorted top k in the same bytes (a row takes one route, and an overflow
// leaves the candidates before its histograms are cleared)
__host__ __device__ constexpr size_t hist_bytes() {
  return 2 * kBins * sizeof(unsigned long long)
         + 3 * 2 * kCopies * kBins * sizeof(uint32_t);
}
static_assert((kMaxCand + kMaxTop) * sizeof(float) <= hist_bytes(),
              "the candidates share the histograms' bytes");

// float -> uint32 in the same order (negatives flipped, positives' sign
// bit set), and back
__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu));
}

// the radix route's probability in fixed point: e = exp(x - m_w), m_w
// the warp's max, times scale = exp(m_w - M) x 2^32 / Z
__device__ __forceinline__ uint32_t fixed_mass(float e, double scale) {
  return static_cast<uint32_t>(fmin(rint(static_cast<double>(e) * scale),
                                    4294967295.0));
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

struct Select {
  uint32_t prefix;                          // the digits chosen so far
  unsigned long long above;                 // count or mass above them
  unsigned long long target;                // k, or ceil(top_p x 2^32)
  int found;                                // 0: the walk found no digit
};

// one pass of one select, by one warp: the first digit from the top at
// which `above` + the merged bins reach `target`; bins[d] of digit d
__device__ __forceinline__ void walk(Select& sel,
                                     const unsigned long long* bins,
                                     int shift) {
  constexpr int kPer = kBins / 32;
  const int lane = threadIdx.x & 31;
  // lane l holds digits kBins - 1 - kPer l .. kBins - kPer (l + 1), from
  // the top
  unsigned long long own = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) own += bins[kBins - 1 - kPer * lane - j];
  unsigned long long incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long o = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += o;
  }
  const bool reach = sel.above + incl >= sel.target;
  const unsigned ballot = __ballot_sync(kAll, reach);
  if (ballot == 0) {
    sel.found = 0;
    return;
  }
  const int first = __ffs(ballot) - 1;
  if (lane == first) {
    unsigned long long acc = sel.above + incl - own;
    for (int j = 0; j < kPer; ++j) {
      const int d = kBins - 1 - kPer * lane - j;
      if (acc + bins[d] >= sel.target) {
        sel.prefix |= static_cast<uint32_t>(d) << shift;
        sel.above = acc;
        break;
      }
      acc += bins[d];
    }
  }
  sel.prefix = __shfl_sync(kAll, sel.prefix, first);
  sel.above = __shfl_sync(kAll, sel.above, first);
}

__global__ void __launch_bounds__(kThreads)
sampler_filter_kernel(const float* __restrict__ logits,
                      const float* __restrict__ temps,
                      const int32_t* __restrict__ top_k,
                      const float* __restrict__ top_p,
                      const float* __restrict__ penalty,
                      const int32_t* __restrict__ history, long long hist_ld,
                      const uint8_t* __restrict__ valid, long long valid_ld,
                      int context, float* __restrict__ out, int vocab,
                      int32_t* __restrict__ routes) {
  const int s = blockIdx.y;
  const int rank = blockIdx.x;              // == the CTA's rank in its cluster
  const int tid = threadIdx.x;
  const bool reports = routes != nullptr && rank == 0 && tid == 0;
  const float t = temps[s];
  if (!(t > 0.0f)) {                        // greedy: every CTA of the row
    if (reports) routes[s] = kGreedy;
    return;
  }
  const int ctas = gridDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = (vocab + ctas - 1) / ctas;
  const int lo = min(vocab, rank * chunk);
  const int n = min(vocab, lo + chunk) - lo;  // 0 at a ragged end
  const size_t row = static_cast<size_t>(s) * vocab;
  const int k = min(top_k[s], vocab);
  const float p = top_p[s];
  const bool need_k = k > 0, need_p = p < 1.0f;
  int route = !need_k && !need_p ? kUncut
              : need_k && k <= ctas * kWarps ? kCandidates : kRadix;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* merged = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* hist = reinterpret_cast<uint32_t*>(merged + 2 * kBins);
  float* cand = reinterpret_cast<float*>(smem);   // rank 0: the candidates
  float* top = cand + kMaxCand;             // rank 0: the k largest, sorted
  float* lg = reinterpret_cast<float*>(smem + hist_bytes());
  // radix: exp(lg - the warp's max), then (from the first pass) its
  // fixed-point mass
  float* ex = lg + chunk;
  uint32_t* mass = reinterpret_cast<uint32_t*>(ex);
  uint32_t* seen = mass + chunk;            // a bit each
  // histogram a (0 counts, 1 masses' low halves, 2 high) of buffer b, copy c
  auto bins = [hist](int a, int b, int c) {
    return hist + ((a * 2 + b) * kCopies + c) * kBins;
  };
  __shared__ float warp_f[3][kWarps];       // each warp's max, min, sum
  __shared__ float cta_f[3];                // this CTA's max, min, bound
  __shared__ double cta_z;                  // and its sum of exp(lg - max)
  __shared__ float row_f[3];                // the row's max, min, bound w
  __shared__ double row_z, row_scale;       // Z, 2^32 / Z
  __shared__ uint32_t cand_n;               // rank 0: candidates pushed
  __shared__ unsigned long long warp_mass[kMaxTop / 32];
  __shared__ float thresh_s;                // rank 0 stores it in each CTA
  __shared__ Select sel_s[2];               // top-k, top-p

  // the penalty's seen ids of this slice (a penalty of 1 changes nothing)
  const float pen = penalty[s];
  const bool penalize = pen != 1.0f;
  if (penalize) {
    const int words = (chunk + 31) / 32;
    for (int w = tid; w < words; w += kThreads) seen[w] = 0u;
    __syncthreads();
    for (int j = tid; j < context; j += kThreads) {
      if (valid[s * valid_ld + j]) {
        const int id = min(max(history[s * hist_ld + j], 0), vocab - 1) - lo;
        if (id >= 0 && id < n) atomicOr(&seen[id >> 5], 1u << (id & 31));
      }
    }
    __syncthreads();
  }
  const float tdiv = fmaxf(t, 1e-6f);
  auto load = [&](int i) {
    float x = logits[row + lo + i];
    if (penalize && (seen[i >> 5] & (1u << (i & 31)))) {
      x = x > 0.0f ? __fdiv_rn(x, pen) : __fmul_rn(x, pen);
    }
    return __fdiv_rn(x, tdiv);
  };
  if (route == kUncut) {                    // no threshold: no barrier
    for (int i = tid; i < n; i += kThreads) out[row + lo + i] = load(i);
    if (reports) routes[s] = route;
    return;
  }
  float mx = -CUDART_INF_F, mn = CUDART_INF_F;
  for (int i = tid; i < n; i += kThreads) {
    const float x = load(i);
    lg[i] = x;
    mx = fmaxf(mx, x);
    mn = fminf(mn, x);
  }
  // the warp's max and min, then its sum of exp(lg - max) (each thread its
  // own elements again; the radix route keeps each exp for its first
  // pass), in butterflies: the same bits in every lane, as each step's two
  // terms are added in either order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
    mn = fminf(mn, __shfl_xor_sync(kAll, mn, off));
  }
  const bool keep_ex = need_p && route == kRadix;
  float sum = 0.0f;
  if (need_p && mx > -CUDART_INF_F) {
    for (int i = tid; i < n; i += kThreads) {
      const float e = expf(__fsub_rn(lg[i], mx));
      sum += e;
      if (keep_ex) ex[i] = e;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(kAll, sum, off);
  }
  if (lane == 0) {
    warp_f[0][warp] = mx;
    warp_f[1][warp] = mn;
    warp_f[2][warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    // the CTA's max m_r, min and sum of exp(lg - m_r) over its warps (fp64,
    // a fixed tree), and the candidates' bound: its ceil(k / P)-th largest
    // warp maximum (lane l counts the warps whose max is >= its own)
    const bool has = lane < kWarps;
    const float v = has ? warp_f[0][lane] : -CUDART_INF_F;
    float lo_v = has ? warp_f[1][lane] : CUDART_INF_F;
    const float sv = has ? warp_f[2][lane] : 0.0f;
    float m_r = v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m_r = fmaxf(m_r, __shfl_xor_sync(kAll, m_r, off));
      lo_v = fminf(lo_v, __shfl_xor_sync(kAll, lo_v, off));
    }
    double z = sv > 0.0f ? static_cast<double>(sv)
                               * static_cast<double>(expf(__fsub_rn(v, m_r)))
                         : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      z += __shfl_xor_sync(kAll, z, off);
    }
    float bound = -CUDART_INF_F;
    if (route == kCandidates) {
      const int quota = (k + ctas - 1) / ctas;
      int above = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) above += __shfl_sync(kAll, v, j) >= v;
      bound = above >= quota ? v : -CUDART_INF_F;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        bound = fmaxf(bound, __shfl_xor_sync(kAll, bound, off));
      }
    }
    if (lane == 0) {
      cta_f[0] = m_r;
      cta_f[1] = lo_v;
      cta_f[2] = bound;
      cta_z = z;
      cand_n = 0u;
      thresh_s = kNegInf;
    }
  }
  cluster::sync();
  if (warp == 0) {
    // lane r reads CTA r's statistics: the row's max, min, bound (the
    // least CTA bound) and normaliser Z = sum_r z_r exp(m_r - M), fp64 in
    // a fixed tree
    const bool has = lane < ctas;
    float m_r = -CUDART_INF_F, lo_r = CUDART_INF_F, w_r = CUDART_INF_F;
    double z_r = 0.0;
    if (has) {
      m_r = __uint_as_float(cluster::load_u32(cluster::addr(&cta_f[0], lane)));
      lo_r = __uint_as_float(cluster::load_u32(cluster::addr(&cta_f[1],
                                                             lane)));
      w_r = __uint_as_float(cluster::load_u32(cluster::addr(&cta_f[2], lane)));
      z_r = __longlong_as_double(static_cast<long long>(
          cluster::load_u64(cluster::addr(&cta_z, lane))));
    }
    float top_v = m_r, low = lo_r, w = w_r;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      top_v = fmaxf(top_v, __shfl_xor_sync(kAll, top_v, off));
      low = fminf(low, __shfl_xor_sync(kAll, low, off));
      w = fminf(w, __shfl_xor_sync(kAll, w, off));
    }
    // an empty slice (m_r = -inf, z_r = 0) adds nothing
    double term = z_r > 0.0
        ? z_r * static_cast<double>(expf(__fsub_rn(m_r, top_v))) : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      term += __shfl_xor_sync(kAll, term, off);
    }
    if (lane == 0) {
      row_f[0] = top_v;
      row_f[1] = low;
      row_f[2] = w;
      row_z = term;
      row_scale = term > 0.0 ? 4294967296.0 / term : 0.0;
    }
  }
  __syncthreads();
  // top_p as a mass target in fixed point; 0 keeps only the largest value
  const unsigned long long p_target =
      need_p && p > 0.0f
          ? static_cast<unsigned long long>(
                ceil(static_cast<double>(p) * 4294967296.0))
          : 0ull;
  float thresh = kNegInf;
  if (route == kCandidates) {
    // every element >= w into rank 0's candidates: a warp's one atomic add
    // on rank 0's counter, then each lane's store at its slot
    const float w = row_f[2];
    const uint32_t n_at = cluster::addr(&cand_n, 0);
    const uint32_t c_at = cluster::addr(cand, 0);
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      const float x = i < n ? lg[i] : -CUDART_INF_F;
      const bool take = i < n && x >= w;
      const unsigned ballot = __ballot_sync(kAll, take);
      if (ballot != 0u) {
        const int leader = __ffs(ballot) - 1;
        uint32_t first = 0u;
        if (lane == leader) first = cluster::atomic_add(n_at, __popc(ballot));
        first = __shfl_sync(kAll, first, leader);
        const uint32_t slot = first + __popc(ballot & ((1u << lane) - 1u));
        if (take && slot < kMaxCand) cluster::store(c_at + 4 * slot, x);
      }
    }
    cluster::sync();
    uint32_t total = 0u;
    if (lane == 0) total = cluster::load_u32(n_at);
    total = __shfl_sync(kAll, total, 0);
    if (total > kMaxCand) {
      route = kOverflow;
    } else {
      if (rank == 0) {
        float* const to = &thresh_s;
        auto publish = [ctas, to](float x) {
          for (int r = 0; r < ctas; ++r) {
            cluster::store(cluster::addr(to, r), x);
          }
        };
        // each thread ranks its candidate: the candidates above it, then
        // its equals in earlier slots; the first k fill top[] in order
        const int c = static_cast<int>(total);
        float x = 0.0f;
        int r = kMaxCand;
        if (tid < c) {
          x = cand[tid];
          r = 0;
          for (int j = 0; j < c; ++j) {
            const float y = cand[j];
            r += (y > x) || (y == x && j < tid);
          }
          if (r < k) top[r] = x;
          if (!need_p && r == k - 1) publish(x);
        }
        if (need_p) {
          // the first k masses, round(exp(x - M) / Z x 2^32), an integer
          // scan: E_j exclusive, I_j inclusive; thresh = top[j] for the
          // last j < k with E_j < target (n_keep = j + 1, or more when j
          // = k - 1: then k_th decides), top[0] when none
          __syncthreads();
          const double scale = 4294967296.0 / row_z;
          unsigned long long m = 0ull, incl = 0ull;
          if (tid < k) {
            x = top[tid];
            m = static_cast<unsigned long long>(fmin(
                rint(exp(static_cast<double>(x) - row_f[0]) * scale),
                4294967295.0));
          }
          if (tid < kMaxTop) {
            incl = m;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const unsigned long long o = __shfl_up_sync(kAll, incl, off);
              if (lane >= off) incl += o;
            }
            if (lane == 31) warp_mass[warp] = incl;
          }
          __syncthreads();
          if (tid < k) {
            for (int j = 0; j < warp; ++j) incl += warp_mass[j];
            const unsigned long long excl = incl - m;
            if ((excl < p_target && (tid == k - 1 || incl >= p_target))
                || (tid == 0 && excl >= p_target)) {
              publish(x);
            }
          }
        }
      }
      cluster::sync();
      thresh = thresh_s;
    }
  }
  if (route == kRadix || route == kOverflow) {
    // radix select: counts for top-k, fixed-point masses for top-p
    const bool use_k = need_k;
    const bool live_p = need_p && p_target > 0ull;
    // exp(lg - the warp's max) x exp(that max - M) x 2^32 / Z
    const double scale = mx == -CUDART_INF_F ? 0.0
        : static_cast<double>(expf(__fsub_rn(mx, row_f[0]))) * row_scale;
    if (live_p && !keep_ex) {               // an overflow: the exps now
      for (int i = tid; i < n; i += kThreads) {
        ex[i] = expf(__fsub_rn(lg[i], mx));
      }
    }
    for (int d = tid; d < 3 * kCopies * kBins; d += kThreads) {
      const int a = d / (kCopies * kBins), e = d - a * kCopies * kBins;
      bins(a, 0, 0)[e] = 0u;                // buffer 0, every copy
    }
    if (tid == 0) {
      sel_s[0] = {0u, 0ull, static_cast<unsigned long long>(use_k ? k : 0),
                  1};
      sel_s[1] = {0u, 0ull, p_target, 1};
    }
    __syncthreads();
    const int copy = warp % kCopies;
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = max(0, 32 - kDigitBits * (pass + 1));
      const uint32_t mask = pass == 0 ? 0u : ~0u << (32 - kDigitBits * pass);
      const int b = pass & 1;
      const uint32_t pre_k = sel_s[0].prefix, pre_p = sel_s[1].prefix;
      const bool go_p = live_p && sel_s[1].found;
      uint32_t* cnt = bins(0, b, copy);
      uint32_t* mlo = bins(1, b, copy);
      uint32_t* mhi = bins(2, b, copy);
      // each warp adds into one of kCopies histograms: the early passes
      // put most of a slice into a few digits
      for (int i = tid; i < n; i += kThreads) {
        const float x = lg[i];
        const uint32_t key = to_key(x);
        const int d = (key >> shift) & (kBins - 1);
        if (use_k && (key & mask) == pre_k) atomicAdd(&cnt[d], 1u);
        if (go_p && (key & mask) == pre_p) {
          uint32_t m;
          if (pass == 0) {
            // the mass in fixed point, kept for the later passes
            m = fixed_mass(ex[i], scale);
            mass[i] = m;
          } else {
            m = mass[i];
          }
          if (m != 0u) {
            atomicAdd(&mlo[d], m & 0xFFFFu);
            atomicAdd(&mhi[d], m >> 16);
          }
        }
      }
      __syncthreads();
      if (kCopies > 1) {
        // the CTA's copies folded into copy 0, which the cluster reads
        for (int d = tid; d < 2 * kBins; d += kThreads) {
          const int e = d % kBins;
          for (int a = d < kBins ? 0 : 1; a < (d < kBins ? 1 : 3); ++a) {
            uint32_t acc = 0u;
            for (int c = 1; c < kCopies; ++c) acc += bins(a, b, c)[e];
            bins(a, b, 0)[e] += acc;
          }
        }
      }
      cluster::sync();
      // every CTA merges the cluster's histograms (the first kBins
      // indices the counts, the next the masses) and clears the other
      // buffer for the next pass: every CTA read it in the previous pass,
      // before this pass's barrier
      for (int d = tid; d < 2 * kBins; d += kThreads) {
        const int e = d % kBins;
        if (d < kBins) {
          if (use_k) merged[e] = gather_sum(bins(0, b, 0)[e], ctas);
          for (int c = 0; c < kCopies; ++c) bins(0, b ^ 1, c)[e] = 0u;
        } else {
          if (go_p) {
            merged[kBins + e] = (gather_sum(bins(2, b, 0)[e], ctas) << 16)
                                + gather_sum(bins(1, b, 0)[e], ctas);
          }
          for (int c = 0; c < kCopies; ++c) {
            bins(1, b ^ 1, c)[e] = 0u;
            bins(2, b ^ 1, c)[e] = 0u;
          }
        }
      }
      __syncthreads();
      // warp 0 walks top-k's digits, warp 1 top-p's
      if (warp < 2 && (warp == 0 ? use_k : go_p)) {
        Select sel = sel_s[warp];
        walk(sel, merged + warp * kBins, shift);
        if (lane == 0) sel_s[warp] = sel;
      }
      __syncthreads();
    }
    cluster::sync();               // no CTA leaves while another reads it
    const float k_th = use_k ? from_key(sel_s[0].prefix) : kNegInf;
    // top_p beyond the whole fixed-point mass keeps the row: its minimum
    const float p_th = !need_p ? kNegInf
                       : !live_p ? row_f[0]
                       : sel_s[1].found ? from_key(sel_s[1].prefix)
                                        : row_f[1];
    thresh = fmaxf(k_th, p_th);
  }
  for (int i = tid; i < n; i += kThreads) {
    out[row + lo + i] = lg[i] < thresh ? kNegInf : lg[i];
  }
  if (reports) routes[s] = route;
}

// the launch, or cudaErrorInvalidValue for a shape it does not take
int filter(const void* logits, const void* temps, const void* top_k,
           const void* top_p, const void* penalty, const void* history,
           long long hist_ld, const void* valid, long long valid_ld,
           int context, void* out, int slots, int vocab, void* routes,
           cudaStream_t stream) {
  if (slots <= 0 || vocab <= 0 || context < 0 || slots > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one CTA a row for every kThreads indices, at most a cluster of 8
  const int ctas = min(kMaxCtas, (vocab + kThreads - 1) / kThreads);
  const int chunk = (vocab + ctas - 1) / ctas;
  const size_t smem = hist_bytes() + static_cast<size_t>(chunk) * 8
                      + (chunk + 31) / 32 * 4;
  return cluster::launch<sampler_filter_kernel>(
      ctas, slots, kThreads, smem, stream, static_cast<const float*>(logits),
      static_cast<const float*>(temps), static_cast<const int32_t*>(top_k),
      static_cast<const float*>(top_p), static_cast<const float*>(penalty),
      static_cast<const int32_t*>(history), hist_ld,
      static_cast<const uint8_t*>(valid), valid_ld, context,
      static_cast<float*>(out), vocab, static_cast<int32_t*>(routes));
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
                valid, valid_ld, context, out, slots, vocab, nullptr,
                static_cast<cudaStream_t>(stream));
}

// The same launch, also writing each row's route (int32 [slots]: 0 greedy,
// 1 no threshold, 2 candidates, 3 candidates overflowed into the radix
// select, 4 radix select) for the card's checks.
extern "C" int paddle_sampler_filter_routes(
    const void* logits, const void* temps, const void* top_k,
    const void* top_p, const void* penalty, const void* history,
    long long hist_ld, const void* valid, long long valid_ld, int context,
    void* out, int slots, int vocab, void* routes, void* stream) {
  return filter(logits, temps, top_k, top_p, penalty, history, hist_ld,
                valid, valid_ld, context, out, slots, vocab, routes,
                static_cast<cudaStream_t>(stream));
}
