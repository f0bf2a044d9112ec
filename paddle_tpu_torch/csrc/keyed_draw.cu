// The sampler's keyed draw for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: no Pallas kernel. The reference draws each stochastic token
// with jax.random.categorical(fold_in(PRNGKey(seed), position), filtered)
// (paddle_tpu/serving/sampling.py:168-171, keys from
// paddle_tpu/framework/random.py:206-216), which XLA compiles. This kernel
// computes that draw bit for bit (jax 0.9.0, jax_threefry_partitionable):
//   key        = threefry2x32((0, seed), (0, position))
//   bits[i]    = y0 ^ y1 of threefry2x32(key, (0, s * row_stride + i))
//   u[i]       = max(tiny, bitcast((bits >> 9) | 0x3F800000) - 1 + tiny)
//   noise[i]   = -log(-log(u[i]))   with XLA's CPU float32 log (below)
//   token      = first argmax of noise + filtered   (temperature > 0)
//              = first argmax of raw                (temperature <= 0)
// and writes the token straight into the engine's output and device
// feedback buffers, so the next decode step reads it without the host.
// row_stride is 0 for the engine (each slot draws [V] under its own key);
// `generate` draws [B, V] under one key (jax.random.categorical over the
// batch, paddle_tpu/incubate/models/gpt.py:462-463), whose element (b, v)
// takes counter b * V + v: it passes every row the same key and
// row_stride V.
//
// What bounds it on an H100, two ways:
//   bytes: S x V x 4 bytes of fp32 logits read once (8 x 50304 x 4 =
//     1.6 MB, 0.48 us at 3.35 TB/s);
//   integer issue: a sampled slot runs threefry once per index, 20 rounds
//     of add, rotate (one funnel shift) and xor plus 5 key injections of
//     two adds and one initial add, 72 INT32 instructions (chip_smoke.py's
//     build phase prints the kernel's SASS: 40 SHF.L.W, two copies of the
//     20 rounds, the key's and the loop's), over 64 INT32 lanes per SM per
//     clock x 132 SMs at the 1980 MHz nvidia-smi reports (16.7 T/s): 2
//     sampled slots of 50304, 0.43 us; 8 sampled, 1.73 us. The two
//     polynomial logs run on the float pipes beside it.
//
// Design. The first kernel (one CTA of 1024 threads a slot) ran the ~150
// instructions an index takes on 8 of the 132 SMs at S = 8 and took 0.050
// ms, ~100x its byte bound. Now each slot's vocabulary is split over P
// CTAs of one thread block cluster, each CTA a contiguous slice of ceil(V
// / P) indices, neighbouring threads on neighbouring floats. P = 8 at V =
// 50304 (one CTA for every 1024 indices, at most 8, the portable cluster
// size): timed in turns on the H100 against clusters of 4 CTAs and CTAs of
// 256 and 512 threads (tools/torch_sampler_grids.py builds those
// variants), 8 x 1024 was the fastest at 2 and 8 of 8 slots sampled; a
// larger cluster costs more to schedule and to join than its share of the
// hashing saves. Each CTA reduces its slice to one (value, index) by warp
// shuffles and one warp over the warps' bests, then stores the pair into
// rank 0's shared memory (distributed shared memory); after one cluster
// barrier rank 0 merges the P pairs and writes out and feedback. `beats`
// is a total order on (value, index): the larger value, NaN above every
// number, ties to the lower index, so the order of the merge cannot change
// the token, which is the first argmax, as jnp.argmax and torch.argmax
// give. A CTA whose slice is empty (the ragged end) still reports its
// sentinel (-inf, V) and reaches the barrier; every CTA of a greedy slot's
// cluster launches and reads only its slice of the raw row, hashing
// nothing. No global scratch, no atomics, no host read: the launch is
// captured in the decode step's CUDA graph. The float arithmetic of the
// uniform and of the log is written with explicit round-to-nearest
// intrinsics (__fadd_rn, __fmul_rn, __fmaf_rn), so nvcc contracts nothing
// that XLA did not.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster_sm90.cuh"

namespace {

constexpr int kThreads = 1024;             // threads of a CTA
constexpr int kMaxCtas = 8;                // CTAs of one slot: a cluster
constexpr float kTiny = 1.17549435e-38f;   // FLT_MIN, finfo(float32).tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax's threefry2x32_p.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// float32 log as XLA's CPU backend lowers it: frexp into [0.5, 1), the
// Cephes polynomial on [sqrt(1/2) - 1, sqrt(2) - 1), ln 2 added back in two
// parts, with a fused multiply-add exactly where LLVM fuses one.
__device__ __forceinline__ float xla_log(float x) {
  if (x == CUDART_INF_F) return CUDART_INF_F;
  if (x < 0.0f || x != x) return CUDART_NAN_F;
  if (x < kTiny) return -CUDART_INF_F;        // 0 and denormals
  const uint32_t b = __float_as_uint(x);
  float e = __fadd_rn(static_cast<float>(static_cast<int>(b >> 23) - 127),
                      1.0f);
  const float mant = __uint_as_float((b & 0x807FFFFFu) | 0x3F000000u);
  const bool small = mant < 0x1.6a09e6p-1f;
  const float xm = __fadd_rn(__fsub_rn(mant, 1.0f), small ? mant : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float z = __fmul_rn(xm, xm);
  const float z3 = __fmul_rn(z, xm);
  const float y1 = __fmaf_rn(__fmaf_rn(xm, 0x1.204376p-4f, -0x1.d7a37p-4f),
                             xm, 0x1.de4a34p-4f);
  const float y2 = __fmaf_rn(__fmaf_rn(xm, -0x1.fcba9ep-4f, 0x1.23d37ep-3f),
                             xm, -0x1.555ca0p-3f);
  const float y3 = __fmaf_rn(__fmaf_rn(xm, 0x1.999d58p-3f, -0x1.fffff8p-3f),
                             xm, 0x1.555554p-2f);
  float y = __fmaf_rn(__fmaf_rn(y1, z3, y2), z3, y3);
  y = __fmaf_rn(y, z3, __fmul_rn(-0x1.bd0106p-13f, e));
  const float r = __fadd_rn(__fmaf_rn(-0.5f, z, xm), y);
  return __fmaf_rn(0x1.63p-1f, e, r);
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -xla_log(-xla_log(u));
}

// a beats b: the larger value, NaN above every number, ties to the lower
// index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

// the better of (v, i) and the pair at `off` lanes down, in every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, v, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
keyed_draw_kernel(const float* __restrict__ raw,
                  const float* __restrict__ filtered,
                  const float* __restrict__ temps,
                  const uint32_t* __restrict__ seeds,
                  const int32_t* __restrict__ positions,
                  int32_t* __restrict__ out, int32_t* __restrict__ feedback,
                  uint32_t* __restrict__ debug_bits,
                  float* __restrict__ debug_noise, int vocab,
                  uint32_t row_stride) {
  const int s = blockIdx.y;
  const int rank = blockIdx.x;             // == the CTA's rank in its cluster
  const int ctas = gridDim.x;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(s) * vocab;
  const uint32_t counter0 = static_cast<uint32_t>(s) * row_stride;
  const bool sample = temps[s] > 0.0f;
  const bool debug = debug_bits != nullptr;
  const int chunk = (vocab + ctas - 1) / ctas;
  const int lo = rank * chunk;
  const int hi = min(vocab, lo + chunk);
  uint32_t k0 = 0u, k1 = seeds[s];
  if (sample || debug) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(positions[s]);
    threefry2x32(0u, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
  float best = -CUDART_INF_F;
  int best_i = vocab;
  for (int i = lo + tid; i < hi; i += kThreads) {
    float v;
    if (sample || debug) {
      uint32_t y0 = 0u, y1 = counter0 + static_cast<uint32_t>(i);
      threefry2x32(k0, k1, y0, y1);
      const uint32_t bits = y0 ^ y1;
      const float noise = gumbel(bits);
      if (debug) {
        debug_bits[row + i] = bits;
        debug_noise[row + i] = noise;
      }
      v = sample ? __fadd_rn(noise, filtered[row + i]) : raw[row + i];
    } else {
      v = raw[row + i];
    }
    if (beats(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  warp_best(best, best_i);
  // each warp's best, then the CTA's (warp 0), then the cluster's: each
  // CTA's pair lands in rank 0's part_v / part_i
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  __shared__ float part_v[kMaxCtas];
  __shared__ int part_i[kMaxCtas];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    warp_v[warp] = best;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_v[lane] : -CUDART_INF_F;
    best_i = lane < kThreads / 32 ? warp_i[lane] : vocab;
    warp_best(best, best_i);
    if (lane == 0) {
      cluster::store(cluster::addr(&part_v[rank], 0), best);
      cluster::store(cluster::addr(&part_i[rank], 0), best_i);
    }
  }
  cluster::sync();
  if (rank == 0 && tid == 0) {
    best = part_v[0];
    best_i = part_i[0];
    for (int r = 1; r < ctas; ++r) {
      if (beats(part_v[r], part_i[r], best, best_i)) {
        best = part_v[r];
        best_i = part_i[r];
      }
    }
    out[s] = best_i;
    if (feedback != nullptr) feedback[s] = best_i;
  }
}

// the launch, or cudaErrorInvalidValue for a shape it does not take
int draw(const void* raw, const void* filtered, const void* temps,
         const void* seeds, const void* positions, void* out, void* feedback,
         void* debug_bits, void* debug_noise, int slots, int vocab,
         int row_stride, cudaStream_t stream) {
  if (slots <= 0 || vocab <= 0 || slots > 65535 || row_stride < 0 ||
      static_cast<int64_t>(slots - 1) * row_stride + vocab > UINT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one CTA a slot for every kThreads indices, at most a cluster of 8
  const int ctas = min(kMaxCtas, (vocab + kThreads - 1) / kThreads);
  return cluster::launch<keyed_draw_kernel>(
      ctas, slots, kThreads, 0, stream, static_cast<const float*>(raw),
      static_cast<const float*>(filtered), static_cast<const float*>(temps),
      static_cast<const uint32_t*>(seeds),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out),
      static_cast<int32_t*>(feedback), static_cast<uint32_t*>(debug_bits),
      static_cast<float*>(debug_noise), vocab,
      static_cast<uint32_t>(row_stride));
}

}  // namespace

extern "C" int paddle_keyed_draw(const void* raw, const void* filtered,
                                 const void* temps, const void* seeds,
                                 const void* positions, void* out,
                                 void* feedback, void* debug_bits,
                                 void* debug_noise, int slots, int vocab,
                                 int row_stride, void* stream) {
  return draw(raw, filtered, temps, seeds, positions, out, feedback,
              debug_bits, debug_noise, slots, vocab, row_stride,
              static_cast<cudaStream_t>(stream));
}
