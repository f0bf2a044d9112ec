// The keyed draw's first design (commit 463d858), kept for comparison:
// chip_smoke.py builds it beside csrc/keyed_draw.cu and times the two in
// turns, the draw alone and inside the full sampler head. Same C
// interface (paddle_keyed_draw) and the same function, bit for bit.
//
// The sampler's keyed draw for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: no Pallas kernel. The reference draws each stochastic token
// with jax.random.categorical(fold_in(PRNGKey(seed), position), filtered)
// (paddle_tpu/serving/sampling.py:168-171, keys from
// paddle_tpu/framework/random.py:206-216), which XLA compiles. This kernel
// computes that draw bit for bit (jax 0.9.0, jax_threefry_partitionable):
//   key        = threefry2x32((0, seed), (0, position))
//   bits[i]    = y0 ^ y1 of threefry2x32(key, (0, i))
//   u[i]       = max(tiny, bitcast((bits >> 9) | 0x3F800000) - 1 + tiny)
//   noise[i]   = -log(-log(u[i]))   with XLA's CPU float32 log (below)
//   token      = first argmax of noise + filtered   (temperature > 0)
//              = first argmax of raw                (temperature <= 0)
// and writes the token straight into the engine's output and device
// feedback buffers, so the next decode step reads it without the host.
//
// What bounds it on an H100: by bytes, S x V x 4 bytes of fp32 logits read
// once (8 x 50304 x 4 = 1.6 MB, 0.48 us at 3.35 TB/s). A stochastic slot
// also does ~110 integer operations (threefry's 20 rounds) and two
// polynomial logs per index, ~150 instructions, which no byte count shows.
//
// Design (the simple first kernel): one thread block of 1024 threads a
// slot; each thread walks the row at a stride of 1024 (neighbouring threads
// on neighbouring floats), keeps its best (value, index), and the block
// reduces them by warp shuffles and one warp over the 32 warps' bests. Ties
// go to the lower index and NaN beats every number, as jnp.argmax and
// torch.argmax do. A greedy slot reads only its raw row and hashes nothing.
// The float arithmetic of the uniform and of the log is written with
// explicit round-to-nearest intrinsics (__fadd_rn, __fmul_rn, __fmaf_rn),
// so nvcc contracts nothing that XLA did not.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
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

__global__ void __launch_bounds__(kThreads)
keyed_draw_kernel(const float* __restrict__ raw,
                  const float* __restrict__ filtered,
                  const float* __restrict__ temps,
                  const uint32_t* __restrict__ seeds,
                  const int32_t* __restrict__ positions,
                  int32_t* __restrict__ out, int32_t* __restrict__ feedback,
                  uint32_t* __restrict__ debug_bits,
                  float* __restrict__ debug_noise, int vocab) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(s) * vocab;
  const bool sample = temps[s] > 0.0f;
  const bool debug = debug_bits != nullptr;
  uint32_t k0 = 0u, k1 = seeds[s];
  if (sample || debug) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(positions[s]);
    threefry2x32(0u, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
  float best = -CUDART_INF_F;
  int best_i = vocab;
  for (int i = tid; i < vocab; i += kThreads) {
    float v;
    if (sample || debug) {
      uint32_t y0 = 0u, y1 = static_cast<uint32_t>(i);
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
    if (beats(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    warp_v[warp] = best;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = warp_v[lane];
    best_i = warp_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
      if (beats(ov, oi, best, best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      out[s] = best_i;
      if (feedback != nullptr) feedback[s] = best_i;
    }
  }
}

}  // namespace

extern "C" int paddle_keyed_draw(const void* raw, const void* filtered,
                                 const void* temps, const void* seeds,
                                 const void* positions, void* out,
                                 void* feedback, void* debug_bits,
                                 void* debug_noise, int slots, int vocab,
                                 void* stream) {
  if (slots <= 0 || vocab <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keyed_draw_kernel<<<slots, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw), static_cast<const float*>(filtered),
      static_cast<const float*>(temps), static_cast<const uint32_t*>(seeds),
      static_cast<const int32_t*>(positions), static_cast<int32_t*>(out),
      static_cast<int32_t*>(feedback), static_cast<uint32_t*>(debug_bits),
      static_cast<float*>(debug_noise), vocab);
  return static_cast<int>(cudaGetLastError());
}
