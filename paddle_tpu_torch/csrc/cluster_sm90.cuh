// Thread block clusters on Hopper (sm_90), shared by the sampler's kernels
// (keyed_draw.cu, sampler_filter.cu): the distributed shared memory of the
// cluster's CTAs, the cluster-wide barrier, and a launch with a cluster
// size chosen at run time. A cluster spans blockIdx.x, so a CTA's rank in
// its cluster is blockIdx.x.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster {

// the address of shared variable `p` in the cluster's CTA `r`
__device__ __forceinline__ uint32_t addr(const void* p, uint32_t r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(r));
  return out;
}

__device__ __forceinline__ void store(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(x)
               : "memory");
}

__device__ __forceinline__ void store(uint32_t a, int32_t x) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(a), "r"(x)
               : "memory");
}

__device__ __forceinline__ uint32_t load_u32(uint32_t a) {
  uint32_t x;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(x) : "r"(a)
               : "memory");
  return x;
}

__device__ __forceinline__ unsigned long long load_u64(uint32_t a) {
  unsigned long long x;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(x) : "r"(a)
               : "memory");
  return x;
}

// every thread of every CTA of the cluster; shared-memory writes before it
// (remote ones too) are visible to every CTA after it
__device__ __forceinline__ void sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// launch `Kernel` on `ctas` x `groups` CTAs of `threads`, one cluster of
// `ctas` CTAs (at most 8, the portable limit) along x for each group. The
// kernel's first launch on each device (an eager one: the attribute is a
// host call, kept out of a CUDA graph capture) allows all of the device's
// opt-in shared memory as dynamic shared memory; the attribute belongs to
// the device's context, so each device gets its own.
template <auto Kernel, typename... Args>
cudaError_t launch(int ctas, int groups, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  constexpr int kDevices = 64;              // devices with a flag of their own
  static bool prepared[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices || !prepared[device]) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, Kernel);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    }
    if (err != cudaSuccess) return err;
    if (device < kDevices) prepared[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cluster
