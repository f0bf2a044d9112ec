// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile loads and the tensor maps they read, wgmma shared-
// memory descriptors and products, and the small conversions around them.
//
// Every tile is a stack of 64-column panels of 64 rows x 128 B, written by
// TMA in the 128-byte swizzle: the layout the descriptors below name.
// Panels start on 1 KB boundaries (the swizzle repeats every 8 rows = 1 KB).
//
// wgmma's fp32 accumulator of a 64 x N tile, per thread of the warpgroup
// (warp w, lane l): element i is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2. Packed to 16-bit pairs in order, the 32
// registers of a 64 x 64 tile are exactly the register A fragments of four
// m64k16 steps (registers 4 kk .. 4 kk + 3 for columns 16 kk .. 16 kk + 15),
// so a score tile feeds the next product without leaving registers.
//
// The element type T of the tiles is bf16 or f16 (`Elem<T>`): both are 2
// bytes with one wgmma rate and one layout, and differ only in the PTX type
// of the products, the tensor map's data type and the fp32 conversions.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

constexpr int kRows = 64;        // rows of a wgmma tile, and of a TMA box
constexpr int kPanel = 64;       // 2-byte columns in one 128-byte swizzle line
constexpr uint32_t kPanelBytes = kRows * kPanel * 2;   // 8 KB, one TMA box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The 2-byte element types of the tensor-core kernels
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two fp32 values rounded to nearest even, lo in the low half
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also tells the barrier how many bytes TMA will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory,
// completing `bytes` of the barrier's expected transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store: the box at (c0, c1, c2, c3) of `map` from shared memory at
// `src` (elements past the tensor's bounds are not written), in this
// thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// until every one of this thread's bulk groups is complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes become visible to the async proxy
// (a TMA store that reads them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Offsets in
// bytes: `lbo` the stride between 64-column blocks along M/N (MN-major
// operands only), `sbo` the stride between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// after wgmma_wait: registers an asynchronous wgmma wrote are read only
// from here on (the compiler may not hoist their uses above the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define D32_OUTS \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
    "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
    "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define D64_OUTS \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
    "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
    "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),           \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),           \
    "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),           \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),           \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
    "+f"(d[62]), "+f"(d[63])

// The products below, written once for both element types: AB is the PTX
// type of A and B ("bf16" or "f16"), the accumulator is fp32.
#define SM90_WGMMA_SS_N64(AB)                                                  \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                          \
      : D32_OUTS                                                               \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define SM90_WGMMA_SS_N128(AB)                                                 \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"      \
      : D64_OUTS                                                               \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define SM90_WGMMA_RS_N64(AB)                                                  \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"            \
      : D32_OUTS                                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define SM90_WGMMA_RS_N128(AB)                                                 \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "  \
      "1, 1;\n}\n"                                                             \
      : D64_OUTS                                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (+)= A B, 64 x 64 x 16: A and B (of type T) from shared memory, both
// K-major
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
  if constexpr (kIsHalf<T>) {
    SM90_WGMMA_SS_N64("f16");
  } else {
    SM90_WGMMA_SS_N64("bf16");
  }
}

// d (+)= A B, 64 x N x 16 for N = 64 or 128: A and B (of type T) from
// shared memory, both K-major
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64<T>(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(N == 128, "64 or 128 columns");
    if constexpr (kIsHalf<T>) {
      SM90_WGMMA_SS_N128("f16");
    } else {
      SM90_WGMMA_SS_N128("bf16");
    }
  }
}

// d += A B, 64 x N x 16: A (4 registers of T pairs) from registers, B
// from shared memory, MN-major (transposed)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) {
    if constexpr (kIsHalf<T>) {
      SM90_WGMMA_RS_N64("f16");
    } else {
      SM90_WGMMA_RS_N64("bf16");
    }
  } else {
    static_assert(N == 128, "head_dim 64 or 128");
    if constexpr (kIsHalf<T>) {
      SM90_WGMMA_RS_N128("f16");
    } else {
      SM90_WGMMA_RS_N128("bf16");
    }
  }
}

#undef SM90_WGMMA_SS_N64
#undef SM90_WGMMA_SS_N128
#undef SM90_WGMMA_RS_N64
#undef SM90_WGMMA_RS_N128
#undef D32_OUTS
#undef D64_OUTS

// Warp specialization (the D = 128 flash kernels): a warpgroup's share of
// the SM's registers, moved between warpgroups at run time. Every thread of
// the warpgroup executes it, on a path that never rejoins the other roles'.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Named barriers (id 0 is __syncthreads'): bar_sync waits until `threads`
// threads have reached barrier `id` by bar_sync or bar_arrive; bar_arrive
// counts this thread and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 2^x in one MUFU.EX2 (exp2f adds range and denormal fix-ups); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// What `kernel` takes on this card when launched with `threads` threads
// and `smem` bytes of dynamic shared memory: out[0] CTAs an SM, out[1]
// registers a thread (at launch: before any setmaxnreg), out[2] local bytes
// a thread (spills), out[3] smem, out[4] threads
template <typename Kernel>
cudaError_t kernel_info(Kernel* kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = smem;
  out[4] = threads;
  return err;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// Error codes of the tensor-core entries beyond cudaError_t's range.
constexpr int kErrNoEncoder = 100000;       // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 200000;          // + CUresult of a failed encode

// A 4-D map [D, H, rows, B] (innermost first) over 2-byte data of type
// `type` (`Elem<T>::kMap`) at `ptr`, with the caller's element strides
// (batch, seq, head): 64 x 1 x 64 x 1 boxes, 128-byte swizzle, zero fill
// out of bounds.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* ptr, int d, int heads, int rows, int batch,
                      int64_t s_b, int64_t s_n, int64_t s_h) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_n) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {kPanel, 1, kRows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, type, 4,
                          const_cast<void*>(ptr), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

}  // namespace sm90
