// Batched low-rank adapter delta for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces no TPU kernel: the reference computes the multi-tenant adapter
// delta with XLA einsums inside its compiled decode and prefill programs
// (paddle_tpu/serving/tenancy.py `_adapter_forward`). In the port those
// programs are CUDA graphs, and the same arithmetic as PyTorch ops (a gather
// of A, a bmm, a gather of B, a bmm, a multiply, an add) would add about six
// launches per projection to a decode replay that launch latency already
// bounds. So the delta is one launch per projection, in place on the
// projection's output y [N, out]:
//
//     for every row n with s = idx[n * idx_stride] != 0:
//       t = round_T(x[n, :] @ A[s, layer])            (A [K, L, in, r])
//       d = round_T(round_T(t @ B[s, layer]) * round_T(scale[s]))
//       y[n, :] = round_T(y[n, :] + d)                (B [K, L, r, out])
//
// with fp32 sums and round_T the rounding to the model's type (bf16, f16
// or fp32), where the plain twin `lora_delta_reference` and the reference
// round. Rows of slot 0 (the base adapter, all zeros) are not touched, so
// a base tenant stays bit for bit with an adapter-free engine: their CTAs
// return before any other load. Sums are taken in a fixed order (no
// atomics), so a stream is deterministic.
//
// What bounds it on an H100. Decode (8 rows, in 768, out 2304, rank 16,
// bf16): ~0.26 MB, 0.08 us at 3.35 TB/s, so latency: the launch, the index
// load, then the loads of A that depend on it. Prefill (1024 rows of one
// slot): y read and written, 9.4 MB, ~3 us. Two forms, chosen by the
// caller from idx's stride alone (never from its values, so a captured
// graph stays valid whatever slots it later reads):
//
// * row form (idx_stride != 0, decode): a grid of rows x chunks of 256
//   output columns (72 CTAs at out 2304, 24 at 768), 256 threads. Each CTA
//   recomputes its row's t (A is 24.6 KB, which L2 holds): GL lanes take a
//   row of A as 16-byte vectors along the rank (narrower where r or the
//   address does not allow 16 bytes), eight rows a thread loaded before the
//   first FMA, then shuffles and shared memory in one fixed order, so every
//   CTA of a row gets the same t. The first threads own one 16-byte vector
//   of output columns each and issue its y and the 16 rank rows of B before
//   x @ A, since those do not depend on t.
// * tile form (idx_stride == 0, prefill: every row has the one slot): a
//   grid of 16-row tiles x column tiles (up to 1152 columns a CTA), chosen
//   for at least 128 CTAs at 1024 rows; 256 threads. A CTA reads the slot,
//   returns at slot 0, and computes T = round_T(X_tile @ A), the warps
//   splitting `in`: bf16 and f16 on the tensor cores (mma.sync m16n8k16 of
//   the type, each
//   k-step's 16 products summed from zero and added up in fp64; A read by
//   pairs along the rank and turned into B operands by movmatrix), fp32 on
//   the FMA units in fp64 (TF32 would round the operands); the warps'
//   parts summed in a fixed order. In bf16 and f16 U = T @ B is a tensor-core
//   product too, warp by warp over 8-column tiles, y and B read by pairs
//   in the fragments' layout and issued right after T's first operands;
//   in fp32 each thread takes 2 columns of the 16 rows with B's rank rows
//   in registers. A and B are read once a tile, not once a row. T is
//   summed this closely so that where the twin's own fp32 sum of x @ A
//   rounds across a bf16 or f16 step, the kernel still holds against the same
//   arithmetic with fp64 sums (`lora_delta_exact`).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowCols = 256;       // row form: output columns a CTA
constexpr int kBatch = 8;           // rows of A a thread loads at once
constexpr int kRankBlock = 16;      // rank rows of B held in registers
constexpr int kTileRows = 16;       // tile form: rows a CTA (mma's M)
constexpr int kTileThreads = 256;   // tile form: threads a CTA
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileMinCtas = 128;
constexpr int kKBatch = 6;          // tile form, 2-byte: k-steps loaded at once
constexpr int kFBatch = 8;          // tile form, fp32: k loaded at once
constexpr size_t kSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// the 16 bits of v rounded to the 2-byte type T
template <typename T>
__device__ __forceinline__ unsigned short bits_of(float v) {
  const T t = from_float<T>(v);
  return *reinterpret_cast<const unsigned short*>(&t);
}

// the 2-byte T with bits `b`, as a float
template <typename T>
__device__ __forceinline__ float from_bits(unsigned short b) {
  return to_float(*reinterpret_cast<const T*>(&b));
}

// v rounded to T and back: the rounding the twin's dtype casts make
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// y + round_T(round_T(u) * sc), each step rounded once as the twin's
// separate multiply and add do: _rn intrinsics are never contracted into
// an FMA (the caller rounds the sum to T)
template <typename T>
__device__ __forceinline__ float add_delta(float y, float u, float sc) {
  return __fadd_rn(y, round_to<T>(__fmul_rn(round_to<T>(u), sc)));
}

// W elements of T as one load of W * sizeof(T) bytes
template <int Bytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };
template <typename T, int W>
using Raw = typename RawOf<W * static_cast<int>(sizeof(T))>::type;


template <typename T, int W>
__device__ __forceinline__ Raw<T, W> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, W>*>(p);
}
template <typename T, int W>
__device__ __forceinline__ Raw<T, W> ldg_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, W>*>(p));
}
template <typename T, int W>
__device__ __forceinline__ void unpack(const Raw<T, W>& raw, float (&f)[W]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < W; ++j) f[j] = to_float(e[j]);
}
template <typename T, int W>
__device__ __forceinline__ Raw<T, W> pack(const float (&f)[W]) {
  Raw<T, W> raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < W; ++j) e[j] = from_float<T>(f[j]);
  return raw;
}

struct Params {
  void* y;
  const void* x;
  const void* a;
  const void* b;
  const float* scale;
  const int* idx;
  int rows, in, out, rank, layer, num_layers;
  long long y_stride, x_stride, idx_stride;
  int fast;     // tile: x and A read as aligned pairs (2-byte) or 16-byte
                // vectors (fp32)
  int tile_cols;  // tile: output columns a CTA
};

// ---------------------------------------------------------------------------
// row form
// ---------------------------------------------------------------------------

template <typename T, int W>
__device__ __forceinline__ void load_a_rows(Raw<T, W> (&av)[kBatch],
                                            const T* A, int r, int in, int g,
                                            bool live, int i0, int step) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int i = i0 + k * step;
    if (live && i < in) {
      av[k] = ldg_raw<T, W>(A + static_cast<int64_t>(i) * r + g * W);
    }
  }
}

// grid (rows, ceil(out / kRowCols)); shared memory (in + 9 rank) floats
template <typename T, int W, int WB>
__global__ void __launch_bounds__(kRowThreads)
lora_delta_row_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int r = p.rank;
  float* xs = smem;                     // [in]: the row of x
  float* part = xs + p.in;              // [warps][r]: each warp's x @ A
  float* ts = part + kRowWarps * r;     // [r]: t, rounded to T
  const int64_t n = blockIdx.x;
  const int slot = p.idx[n * p.idx_stride];
  if (slot == 0) return;                // the base adapter: y stays
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t factor = static_cast<int64_t>(slot) * p.num_layers + p.layer;
  const T* A = static_cast<const T*>(p.a) + factor * p.in * r;
  const T* B = static_cast<const T*>(p.b) + factor * r * p.out;
  const T* xr = static_cast<const T*>(p.x) + n * p.x_stride;
  T* yr = static_cast<T*>(p.y) + n * p.y_stride;
  const float sc = round_to<T>(p.scale[slot]);

  // this thread's WB output columns (the first kRowCols / WB threads own
  // one vector each); y and B's first rank block do not depend on t, so
  // they are in flight while x @ A is summed
  const int col = blockIdx.y * kRowCols + tid * WB;
  const bool owns = tid * WB < kRowCols && col < p.out;
  Raw<T, WB> bv[kRankBlock];
  Raw<T, WB> yv;
  if (owns) {
    yv = load_raw<T, WB>(yr + col);
#pragma unroll
    for (int c = 0; c < kRankBlock; ++c) {
      if (c < r) bv[c] = ldg_raw<T, WB>(B + static_cast<int64_t>(c) * p.out + col);
    }
  }

  // x @ A: a row of A is G = r / W vectors; GL lanes (a power of two, at
  // most 32) take one row, vector g = q0 + lane % GL, in passes of 32
  // vectors where G exceeds 32; a warp takes 32 / GL rows at a time
  const int G = r / W;
  int GL = 1;
  while (GL < G && GL < 32) GL <<= 1;
  const int per_warp = 32 / GL;
  const int step = kRowWarps * per_warp;
  const int first = warp * per_warp + lane / GL;
  Raw<T, W> av[kBatch];
  load_a_rows<T, W>(av, A, r, p.in, lane % GL, lane % GL < G, first, step);
  for (int i = tid; i < p.in; i += kRowThreads) xs[i] = to_float(xr[i]);
  __syncthreads();
  for (int q0 = 0; q0 < G; q0 += GL) {
    const int g = q0 + lane % GL;
    const bool live = g < G;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
    for (int i0 = first;;) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * step;
        if (live && i < p.in) {
          float av_f[W];
          unpack<T, W>(av[k], av_f);
          const float xv = xs[i];
#pragma unroll
          for (int j = 0; j < W; ++j) acc[j] = fmaf(xv, av_f[j], acc[j]);
        }
      }
      i0 += kBatch * step;
      if (i0 >= p.in) break;
      load_a_rows<T, W>(av, A, r, p.in, g, live, i0, step);
    }
    for (int off = 16; off >= GL; off >>= 1) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    if (lane < GL && live) {
#pragma unroll
      for (int j = 0; j < W; ++j) part[warp * r + g * W + j] = acc[j];
    }
    if (q0 + GL < G) {
      const int gn = q0 + GL + lane % GL;
      load_a_rows<T, W>(av, A, r, p.in, gn, gn < G, first, step);
    }
  }
  __syncthreads();
  for (int c = tid; c < r; c += kRowThreads) {
    float s = 0.f;
    for (int w = 0; w < kRowWarps; ++w) s += part[w * r + c];
    ts[c] = round_to<T>(s);
  }
  __syncthreads();
  if (!owns) return;

  // u = t @ B for the thread's columns, then y in place
  float u[WB];
#pragma unroll
  for (int j = 0; j < WB; ++j) u[j] = 0.f;
  for (int c0 = 0; c0 < r; c0 += kRankBlock) {
    if (c0 > 0) {
#pragma unroll
      for (int c = 0; c < kRankBlock; ++c) {
        if (c0 + c < r) {
          bv[c] = ldg_raw<T, WB>(B + static_cast<int64_t>(c0 + c) * p.out + col);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kRankBlock; ++c) {
      if (c0 + c < r) {
        float bf[WB];
        unpack<T, WB>(bv[c], bf);
        const float t = ts[c0 + c];
#pragma unroll
        for (int j = 0; j < WB; ++j) u[j] = fmaf(t, bf[j], u[j]);
      }
    }
  }
  float yf[WB];
  unpack<T, WB>(yv, yf);
#pragma unroll
  for (int j = 0; j < WB; ++j) yf[j] = add_delta<T>(yf[j], u[j], sc);
  *reinterpret_cast<Raw<T, WB>*>(yr + col) = pack<T, WB>(yf);
}

// ---------------------------------------------------------------------------
// tile form
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned int pair(unsigned short lo,
                                             unsigned short hi) {
  return static_cast<unsigned int>(lo) | (static_cast<unsigned int>(hi) << 16);
}

// c += a b, m16n8k16, operands of the 2-byte type T, fp32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned int (&a)[4],
                                      unsigned int b0, unsigned int b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// the warp's 8 x 8 matrix of b16 pairs (lane l: row l / 4, columns
// 2 (l % 4), + 1) transposed
__device__ __forceinline__ unsigned int transpose8(unsigned int v) {
  unsigned int d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(v));
  return d;
}

__device__ __forceinline__ unsigned int ldg_pair(const unsigned short* q) {
  return __ldg(reinterpret_cast<const unsigned int*>(q));
}

// the lane's pair of 2-byte values at q and q + step, 0 where not ok / not
// ok2
__device__ __forceinline__ unsigned int ldg_two(const unsigned short* q,
                                                int64_t step, bool ok,
                                                bool ok2) {
  return pair(ok ? __ldg(q) : static_cast<unsigned short>(0),
              ok2 ? __ldg(q + step) : static_cast<unsigned short>(0));
}

// this warp's part of T[16][kb .. kb + 16) = X_tile @ A, operands of the
// 2-byte type H on the tensor cores, over the k-steps warp, warp + nw, ...: kKBatch k-steps'
// operands are loaded before the first product; each k-step's 16 products
// are summed from zero and added up in fp64, so T is the exact sum but for
// the tensor core's rounding of 16 products. kPairs: x and A read as
// aligned element pairs (A by pairs along the rank, turned into the B
// operand by movmatrix); else element by element. then() runs once, right
// after the first batch's loads are issued. Into part_w [16][16].
template <typename H, bool kPairs, typename Then>
__device__ __forceinline__ void tile_xa16(double* part_w, const H* x0_,
                                          const H* A_,
                                        const Params& p, int kb, int nrows,
                                        int warp, int nw, int lane,
                                        Then&& then) {
  const unsigned short* A = reinterpret_cast<const unsigned short*>(A_);
  const int gid = lane >> 2, t4 = lane & 3;
  const int in = p.in, r = p.rank;
  const bool ok0 = gid < nrows, ok1 = gid + 8 < nrows;
  const unsigned short* xr0 =
      reinterpret_cast<const unsigned short*>(x0_) + gid * p.x_stride;
  const unsigned short* xr1 = xr0 + 8 * p.x_stride;
  double acc[2][4] = {};
  const int ksteps = (in + 15) / 16;
  for (int ks = warp; ks < ksteps; ks += nw * kKBatch) {
    unsigned int xa[kKBatch][4], ab[kKBatch][4];
#pragma unroll
    for (int q = 0; q < kKBatch; ++q) {
      const int k0 = (ks + q * nw) * 16;   // past in: zeros
      const int kx = k0 + 2 * t4;
      if (kPairs) {
        xa[q][0] = ok0 && kx < in ? ldg_pair(xr0 + kx) : 0u;
        xa[q][1] = ok1 && kx < in ? ldg_pair(xr1 + kx) : 0u;
        xa[q][2] = ok0 && kx + 8 < in ? ldg_pair(xr0 + kx + 8) : 0u;
        xa[q][3] = ok1 && kx + 8 < in ? ldg_pair(xr1 + kx + 8) : 0u;
        // rows k0 + gid (+ 8) of A, ranks c, c + 1 (+ 8): each 8 x 8
        // block transposed below is one B fragment
        const int ka = k0 + gid, c = kb + 2 * t4;
        const unsigned short* ar = A + static_cast<int64_t>(ka) * r + c;
        ab[q][0] = ka < in && c < r ? ldg_pair(ar) : 0u;
        ab[q][1] = ka + 8 < in && c < r ? ldg_pair(ar + 8 * r) : 0u;
        ab[q][2] = ka < in && c + 8 < r ? ldg_pair(ar + 8) : 0u;
        ab[q][3] = ka + 8 < in && c + 8 < r ? ldg_pair(ar + 8 * r + 8) : 0u;
      } else {
        xa[q][0] = ldg_two(xr0 + kx, 1, ok0 && kx < in, ok0 && kx + 1 < in);
        xa[q][1] = ldg_two(xr1 + kx, 1, ok1 && kx < in, ok1 && kx + 1 < in);
        xa[q][2] = ldg_two(xr0 + kx + 8, 1, ok0 && kx + 8 < in,
                           ok0 && kx + 9 < in);
        xa[q][3] = ldg_two(xr1 + kx + 8, 1, ok1 && kx + 8 < in,
                           ok1 && kx + 9 < in);
        // the B fragments directly: rows kx, kx + 1 (+ 8), rank c (+ 8)
        const int c = kb + gid;
        const unsigned short* ar = A + static_cast<int64_t>(kx) * r + c;
        ab[q][0] = ldg_two(ar, r, kx < in && c < r, kx + 1 < in && c < r);
        ab[q][1] = ldg_two(ar + 8 * r, r, kx + 8 < in && c < r,
                           kx + 9 < in && c < r);
        ab[q][2] = ldg_two(ar + 8, r, kx < in && c + 8 < r,
                           kx + 1 < in && c + 8 < r);
        ab[q][3] = ldg_two(ar + 8 * r + 8, r, kx + 8 < in && c + 8 < r,
                           kx + 9 < in && c + 8 < r);
      }
    }
    if (ks == warp) then();
#pragma unroll
    for (int q = 0; q < kKBatch; ++q) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned int b0 = kPairs ? transpose8(ab[q][2 * nt]) : ab[q][2 * nt];
        const unsigned int b1 =
            kPairs ? transpose8(ab[q][2 * nt + 1]) : ab[q][2 * nt + 1];
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16<H>(c, xa[q], b0, b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] += c[j];
      }
    }
  }
  if (warp >= ksteps) then();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = nt * 8 + 2 * t4;
    part_w[gid * kRankBlock + col] = acc[nt][0];
    part_w[gid * kRankBlock + col + 1] = acc[nt][1];
    part_w[(gid + 8) * kRankBlock + col] = acc[nt][2];
    part_w[(gid + 8) * kRankBlock + col + 1] = acc[nt][3];
  }
}

// the same in fp32 on the FMA units: lane (row = lane % 16, h = lane / 16)
// sums ranks kb + 8h .. kb + 8h + 7 of its row over the warp's k-range, a
// contiguous slice, kFBatch k at a time with every load issued first;
// then() runs once, after the first batch's loads. kVec: x and A's rank
// octets read as 16-byte vectors.
template <bool kVec, typename Then>
__device__ __forceinline__ void tile_xa(double* part_w, const float* x0,
                                        const float* A, const Params& p,
                                        int kb, int nrows, int warp, int nw,
                                        int lane, Then&& then) {
  const int row = lane & 15, h = lane >> 4;
  const int in = p.in, r = p.rank;
  const int c0 = kb + 8 * h;
  const bool ok = row < nrows;
  const float* xr = x0 + row * p.x_stride;
  const int per = (in + nw * kFBatch - 1) / (nw * kFBatch) * kFBatch;
  const int k_lo = warp * per;
  const int k_hi = k_lo + per < in ? k_lo + per : in;
  double acc[8] = {};
  for (int k = k_lo; k < k_hi; k += kFBatch) {
    float xv[kFBatch], av[kFBatch][8];
    if (kVec) {
#pragma unroll
      for (int j = 0; j < kFBatch; j += 4) {
        const float4 v = ok && k + j < k_hi
            ? __ldg(reinterpret_cast<const float4*>(xr + k + j))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        xv[j] = v.x; xv[j + 1] = v.y; xv[j + 2] = v.z; xv[j + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kFBatch; ++j) {
        const float* ar = A + static_cast<int64_t>(k + j) * r + c0;
        const bool kok = k + j < k_hi;
        const float4 lo = kok && c0 < r ? __ldg(reinterpret_cast<const float4*>(ar))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 hi = kok && c0 + 4 < r
            ? __ldg(reinterpret_cast<const float4*>(ar + 4))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        av[j][0] = lo.x; av[j][1] = lo.y; av[j][2] = lo.z; av[j][3] = lo.w;
        av[j][4] = hi.x; av[j][5] = hi.y; av[j][6] = hi.z; av[j][7] = hi.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kFBatch; ++j) {
        const bool kok = k + j < k_hi;
        xv[j] = ok && kok ? __ldg(xr + k + j) : 0.f;
        const float* ar = A + static_cast<int64_t>(k + j) * r + c0;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          av[j][cc] = kok && c0 + cc < r ? __ldg(ar + cc) : 0.f;
        }
      }
    }
    if (k == k_lo) then();
#pragma unroll
    for (int j = 0; j < kFBatch; ++j) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        acc[cc] = fma(static_cast<double>(xv[j]), static_cast<double>(av[j][cc]), acc[cc]);
      }
    }
  }
  if (k_lo >= k_hi) then();
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) part_w[row * kRankBlock + 8 * h + cc] = acc[cc];
}

// U on the tensor cores (2-byte, 4-column vectors of y and B): warp w takes
// the 8-column n-tiles w, w + 8, ... of the CTA's columns, at most
// kWarpTiles of them, so a CTA takes at most kMmaCols columns
constexpr int kWarpTiles = 18;
constexpr int kMmaCols = kTileWarps * kWarpTiles * 8;

// T's 16 x 16 block of ranks kb.. as the A fragment of type H (its values
// are of type H already, so the packing is exact)
template <typename H>
__device__ __forceinline__ void t_fragment(unsigned int (&a)[4], const float* ts,
                                           int kb, int lane) {
  const int gid = lane >> 2, t4 = lane & 3;
  const float* t = ts + (kb + 2 * t4) * kTileRows + gid;
  auto bf = [](float v) { return bits_of<H>(v); };
  a[0] = pair(bf(t[0]), bf(t[kTileRows]));
  a[1] = pair(bf(t[8]), bf(t[kTileRows + 8]));
  a[2] = pair(bf(t[8 * kTileRows]), bf(t[9 * kTileRows]));
  a[3] = pair(bf(t[8 * kTileRows + 8]), bf(t[9 * kTileRows + 8]));
}

// B's rows kb + gid and kb + 8 + gid at columns n, n + 1 of the n-tile
// (n = its first column + 2 t4), by aligned pairs: each 8 x 8 block
// transposed is one B fragment
__device__ __forceinline__ void b_pairs(unsigned int (&b)[2],
                                        const unsigned short* B,
                                        const Params& p, int kb, int col,
                                        bool ok, int gid) {
  const unsigned short* q = B + static_cast<int64_t>(kb + gid) * p.out + col;
  b[0] = ok && kb + gid < p.rank ? ldg_pair(q) : 0u;
  b[1] = ok && kb + 8 + gid < p.rank ? ldg_pair(q + 8 * p.out) : 0u;
}

// y + round_T(round_T(u) * sc) for a pair of outputs of the 2-byte type
// H, rounded
template <typename H>
__device__ __forceinline__ unsigned int add_pair(unsigned int y, float u0,
                                                 float u1, float sc) {
  const float y0 = from_bits<H>(static_cast<unsigned short>(y & 0xffffu));
  const float y1 = from_bits<H>(static_cast<unsigned short>(y >> 16));
  return pair(bits_of<H>(add_delta<H>(y0, u0, sc)),
              bits_of<H>(add_delta<H>(y1, u1, sc)));
}

// grid (ceil(rows / 16), column tiles of p.tile_cols), kTileThreads
// threads; shared memory: the warps' fp64 sums [8][16][16] and T^T
// [rpad][16] floats, rpad = rank rounded up to 16
template <typename T, int CW>
__global__ void __launch_bounds__(kTileThreads)
lora_delta_tile_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  // bf16 or f16 with 4-column vectors of y and B: U on the tensor cores; else on
  // the FMA units, a thread's CW columns of every row
  constexpr bool kMma = sizeof(T) == 2 && CW == 4;
  constexpr int nw = kTileWarps;
  const int r = p.rank;
  double* part = reinterpret_cast<double*>(smem);        // [nw][16][16]
  float* ts = reinterpret_cast<float*>(part + nw * kTileRows * kRankBlock);
  const int slot = p.idx[0];            // stride 0: one slot for all rows
  if (slot == 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int nrows = static_cast<int>(
      p.rows - row0 < kTileRows ? p.rows - row0 : kTileRows);
  const int64_t factor = static_cast<int64_t>(slot) * p.num_layers + p.layer;
  const T* A = static_cast<const T*>(p.a) + factor * p.in * r;
  const T* B = static_cast<const T*>(p.b) + factor * r * p.out;
  const T* x0 = static_cast<const T*>(p.x) + row0 * p.x_stride;
  T* y0 = static_cast<T*>(p.y) + row0 * p.y_stride;
  const float sc = round_to<T>(p.scale[slot]);
  const int col0 = blockIdx.y * p.tile_cols;
  const int ncols = p.out - col0 < p.tile_cols ? p.out - col0 : p.tile_cols;

  // issued right after T's first operands, in flight while T is
  // computed: on the tensor-core path y and B's first rank block for the
  // warp's n-tiles in the fragments' layout (pairs of columns); on the FMA
  // path B's first rank block for the thread's CW columns
  unsigned int yp[kWarpTiles][2], bp[kWarpTiles][2];
  Raw<T, CW> bv[kRankBlock];
  const int col = col0 + tid * CW;
  const bool owns = tid * CW < ncols;
  auto prefetch = [&]() {
    if constexpr (kMma) {
      const unsigned short* yb = reinterpret_cast<const unsigned short*>(y0);
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        const int n = (warp + j * nw) * 8 + 2 * t4;
        const bool ok = n < ncols;
        const unsigned short* q = yb + gid * p.y_stride + col0 + n;
        yp[j][0] = ok && gid < nrows ? *reinterpret_cast<const unsigned int*>(q) : 0u;
        yp[j][1] = ok && gid + 8 < nrows
            ? *reinterpret_cast<const unsigned int*>(q + 8 * p.y_stride) : 0u;
        b_pairs(bp[j], reinterpret_cast<const unsigned short*>(B), p, 0,
                col0 + n, ok, gid);
      }
    } else if (owns) {
#pragma unroll
      for (int c = 0; c < kRankBlock; ++c) {
        if (c < r) bv[c] = ldg_raw<T, CW>(B + static_cast<int64_t>(c) * p.out + col);
      }
    }
  };

  // T in rank blocks of 16: the warps' parts, then their sum in a fixed
  // order, rounded to T, into ts[rank][row]
  for (int kb = 0; kb < r; kb += kRankBlock) {
    double* part_w = part + warp * kTileRows * kRankBlock;
    auto then = [&]() { if (kb == 0) prefetch(); };
    if constexpr (sizeof(T) == 2) {
      if (p.fast) {
        tile_xa16<T, true>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
      } else {
        tile_xa16<T, false>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
      }
    } else if (p.fast) {
      tile_xa<true>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
    } else {
      tile_xa<false>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
    }
    __syncthreads();
    for (int o = tid; o < kTileRows * kRankBlock; o += kTileThreads) {
      const int i = o / kRankBlock, c = o % kRankBlock;
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += part[(w * kTileRows + i) * kRankBlock + c];
      ts[(kb + c) * kTileRows + i] = round_to<T>(static_cast<float>(s));
    }
    __syncthreads();
  }

  if constexpr (kMma) {
    // U = T @ B for each n-tile of the warp, y in place by pairs
    unsigned short* yb = reinterpret_cast<unsigned short*>(y0);
    const unsigned short* Bb = reinterpret_cast<const unsigned short*>(B);
    unsigned int a0[4];
    t_fragment<T>(a0, ts, 0, lane);
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
      if ((warp + j * nw) * 8 >= ncols) break;     // warp-uniform
      const int n = (warp + j * nw) * 8 + 2 * t4;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma16<T>(c, a0, transpose8(bp[j][0]), transpose8(bp[j][1]));
      for (int kb = kRankBlock; kb < r; kb += kRankBlock) {
        unsigned int a[4], b[2];
        t_fragment<T>(a, ts, kb, lane);
        b_pairs(b, Bb, p, kb, col0 + n, n < ncols, gid);
        mma16<T>(c, a, transpose8(b[0]), transpose8(b[1]));
      }
      if (n < ncols) {
        unsigned short* q = yb + gid * p.y_stride + col0 + n;
        if (gid < nrows) {
          *reinterpret_cast<unsigned int*>(q) = add_pair<T>(yp[j][0], c[0], c[1], sc);
        }
        if (gid + 8 < nrows) {
          *reinterpret_cast<unsigned int*>(q + 8 * p.y_stride) =
              add_pair<T>(yp[j][1], c[2], c[3], sc);
        }
      }
    }
    return;
  }
  if (!owns) return;

  // U = T @ B for the thread's columns, eight rows at a time (the rank
  // block in registers serves both halves), then y in place
  constexpr int kHalf = kTileRows / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float u[kHalf][CW];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
#pragma unroll
      for (int j = 0; j < CW; ++j) u[i][j] = 0.f;
    }
    for (int kb = 0; kb < r; kb += kRankBlock) {
      if (kb > 0 || (h > 0 && r > kRankBlock)) {
#pragma unroll
        for (int c = 0; c < kRankBlock; ++c) {
          if (kb + c < r) {
            bv[c] = ldg_raw<T, CW>(B + static_cast<int64_t>(kb + c) * p.out + col);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kRankBlock; ++c) {
        if (kb + c < r) {
          float bf[CW];
          unpack<T, CW>(bv[c], bf);
          const float4* tq = reinterpret_cast<const float4*>(
              ts + (kb + c) * kTileRows + h * kHalf);
#pragma unroll
          for (int i4 = 0; i4 < kHalf / 4; ++i4) {
            const float4 t = tq[i4];
            const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
              for (int j = 0; j < CW; ++j) {
                u[i4 * 4 + ii][j] = fmaf(tv[ii], bf[j], u[i4 * 4 + ii][j]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int row = h * kHalf + i;
      if (row < nrows) {
        T* q = y0 + row * p.y_stride + col;
        float yf[CW];
        unpack<T, CW>(load_raw<T, CW>(q), yf);
#pragma unroll
        for (int j = 0; j < CW; ++j) yf[j] = add_delta<T>(yf[j], u[i][j], sc);
        *reinterpret_cast<Raw<T, CW>*>(q) = pack<T, CW>(yf);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the launch plan
// ---------------------------------------------------------------------------

struct Plan {
  int form;      // 0 row, 1 tile
  int grid_x, grid_y, threads;
  int smem;      // bytes of dynamic shared memory
  int w;         // row: A's vector width (elements); tile: 0
  int wb;        // row: B's and y's vector width; tile: columns a thread
  int tile_cols; // tile: output columns a CTA
};

// w elements of `elem` bytes fit every count in `counts` and every
// address in `addrs`
bool fits(int w, size_t elem, const long long* counts, int n_counts,
          const uintptr_t* addrs, int n_addrs) {
  for (int i = 0; i < n_counts; ++i) {
    if (counts[i] % w != 0) return false;
  }
  for (int i = 0; i < n_addrs; ++i) {
    if (addrs[i] % (w * elem) != 0) return false;
  }
  return true;
}

int rank_pad(int rank) {
  return (rank + kRankBlock - 1) / kRankBlock * kRankBlock;
}

size_t row_smem(int in, int rank) {
  return sizeof(float) * (static_cast<size_t>(in) + (kRowWarps + 1) * rank);
}

size_t tile_smem(int rank) {
  return sizeof(double) * kTileWarps * kTileRows * kRankBlock +
         sizeof(float) * static_cast<size_t>(kTileRows) * rank_pad(rank);
}

// returns false for what the kernels do not take
bool make_plan(Plan* pl, int form, int dtype, int rows, int in, int out,
               int rank, long long y_stride, long long idx_stride,
               const void* y, const void* a, const void* b) {
  const size_t elem = dtype == 0 ? 4 : 2;
  const int vec = static_cast<int>(16 / elem);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const uintptr_t aa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t ba = reinterpret_cast<uintptr_t>(b);
  const long long out_counts[2] = {out, y_stride};
  const uintptr_t out_addrs[2] = {ya, ba};
  pl->form = form;
  pl->tile_cols = 0;
  if (form == 0) {
    if (row_smem(in, rank) > kSmemLimit) return false;
    const long long rank_count[1] = {rank};
    pl->w = 1;
    for (int w = vec; w > 1; w /= 2) {
      if (w != vec && w != vec / 2) continue;   // instantiated: vec, vec / 2, 1
      if (fits(w, elem, rank_count, 1, &aa, 1)) { pl->w = w; break; }
    }
    pl->wb = fits(vec, elem, out_counts, 2, out_addrs, 2) ? vec : 1;
    pl->grid_x = rows;
    pl->grid_y = (out + kRowCols - 1) / kRowCols;
    pl->threads = kRowThreads;
    pl->smem = static_cast<int>(row_smem(in, rank));
    return true;
  }
  if (form != 1 || idx_stride != 0) return false;
  if (tile_smem(rank) > kSmemLimit) return false;
  // 8-byte vectors of y and B (bf16, f16: the tensor-core path, by pairs), or
  // one element (the FMA path)
  const int cw_max = static_cast<int>(8 / elem);
  pl->w = 0;
  pl->wb = fits(cw_max, elem, out_counts, 2, out_addrs, 2) ? cw_max : 1;
  // columns a CTA: at most what its warps' n-tiles (tensor-core path) or
  // threads (FMA path) cover; at least a warp's worth; the fewest column
  // tiles that give kTileMinCtas CTAs within those limits
  const bool mma = dtype != 0 && pl->wb == 4;
  const int unit = mma ? 8 : pl->wb;
  const long long most = mma ? kMmaCols : static_cast<long long>(kTileThreads) * pl->wb;
  const long long least = mma ? kTileWarps * 8 : 32LL * pl->wb;
  const long long row_tiles = (rows + kTileRows - 1) / kTileRows;
  long long tiles = (kTileMinCtas + row_tiles - 1) / row_tiles;
  const long long by_least = (out + least - 1) / least;
  if (tiles > by_least) tiles = by_least;
  const long long by_most = (out + most - 1) / most;
  if (tiles < by_most) tiles = by_most;
  if (tiles < 1) tiles = 1;
  const long long per = (out + tiles - 1) / tiles;
  pl->tile_cols = static_cast<int>((per + unit - 1) / unit * unit);
  pl->threads = kTileThreads;
  pl->grid_x = static_cast<int>(row_tiles);
  pl->grid_y = static_cast<int>((out + pl->tile_cols - 1) / pl->tile_cols);
  pl->smem = static_cast<int>(tile_smem(rank));
  return true;
}

template <typename T, int W, int WB>
cudaError_t launch_row(const Plan& pl, const Params& p, cudaStream_t s) {
  lora_delta_row_kernel<T, W, WB>
      <<<dim3(pl.grid_x, pl.grid_y), pl.threads, pl.smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int CW>
cudaError_t launch_tile(const Plan& pl, const Params& p, cudaStream_t s) {
  lora_delta_tile_kernel<T, CW>
      <<<dim3(pl.grid_x, pl.grid_y), pl.threads, pl.smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Plan& pl, const Params& p, cudaStream_t s) {
  constexpr int vec = 16 / sizeof(T);
  constexpr int cw = 8 / sizeof(T);
  if (pl.form == 1) {
    return pl.wb == cw ? launch_tile<T, cw>(pl, p, s) : launch_tile<T, 1>(pl, p, s);
  }
  if (pl.wb == vec) {
    if (pl.w == vec) return launch_row<T, vec, vec>(pl, p, s);
    if (pl.w == vec / 2) return launch_row<T, vec / 2, vec>(pl, p, s);
    return launch_row<T, 1, vec>(pl, p, s);
  }
  if (pl.w == vec) return launch_row<T, vec, 1>(pl, p, s);
  if (pl.w == vec / 2) return launch_row<T, vec / 2, 1>(pl, p, s);
  return launch_row<T, 1, 1>(pl, p, s);
}

bool valid_args(int rows, int in, int out, int rank, int layer,
                int num_layers, int dtype) {
  return rows > 0 && in > 0 && out > 0 && rank > 0 && layer >= 0 &&
         layer < num_layers && dtype >= 0 && dtype <= 2;
}

}  // namespace

// form: 0 = row form (any idx_stride), 1 = tile form (idx_stride 0: every
// row has the slot idx[0]). dtype: 0 = float32, 1 = bfloat16, 2 = float16
// (y, x, a and b; another code returns cudaErrorInvalidValue). y [rows, out] and x [rows, in] with unit inner stride and row strides
// y_stride, x_stride (elements); a [K, num_layers, in, rank] and
// b [K, num_layers, rank, out] contiguous; scale [K] float32; idx int32,
// row n's slot at idx[n * idx_stride]. Shared memory: the row form's
// (in + 9 rank) floats and the tile form's (2048 + 16 rank, rank rounded up
// to 16) floats must fit in 48 KB. Returns a cudaError_t.
extern "C" int paddle_lora_delta(void* y, const void* x, const void* a,
                                 const void* b, const void* scale,
                                 const void* idx, int rows, int in, int out,
                                 int rank, int layer, int num_layers,
                                 long long y_stride, long long x_stride,
                                 long long idx_stride, int form, int dtype,
                                 void* stream) {
  Plan pl;
  if (!valid_args(rows, in, out, rank, layer, num_layers, dtype) ||
      !make_plan(&pl, form, dtype, rows, in, out, rank, y_stride, idx_stride,
                 y, a, b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.y = y;
  p.x = x;
  p.a = a;
  p.b = b;
  p.scale = static_cast<const float*>(scale);
  p.idx = static_cast<const int*>(idx);
  p.rows = rows;
  p.in = in;
  p.out = out;
  p.rank = rank;
  p.layer = layer;
  p.num_layers = num_layers;
  p.y_stride = y_stride;
  p.x_stride = x_stride;
  p.idx_stride = idx_stride;
  // bf16, f16: pairs of 4 bytes; fp32: vectors of 16
  const int w = dtype == 0 ? 4 : 2;
  const uintptr_t bytes = dtype == 0 ? 16 : 4;
  p.tile_cols = pl.tile_cols;
  p.fast = in % w == 0 && x_stride % w == 0 && rank % w == 0 &&
           reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(a) % bytes == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0   ? launch<float>(pl, p, s)
                          : dtype == 1 ? launch<__nv_bfloat16>(pl, p, s)
                                       : launch<__half>(pl, p, s);
  return static_cast<int>(err);
}
