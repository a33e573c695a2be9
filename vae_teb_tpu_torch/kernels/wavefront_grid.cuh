// Device helpers shared by wavefront_grid_fwd.cu and wavefront_grid_bwd.cu:
// the cooperative grid's barrier and loads that see other CTAs' writes
// (kernels/build.py hashes this header into every library's name, so an
// edit rebuilds them).

#pragma once

#include "wavefront_common.cuh"

namespace {

constexpr int THREADS = 256;        // threads a CTA
constexpr int WARPS = THREADS / 32;  // depth slices of the products

// A value another CTA of this launch wrote: ld.global.cg reads L2, never a
// line an SM's (non-coherent) L1 kept from before the writer's barrier.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Barrier over every CTA of a cooperative launch. `count` starts at 0 (the
// wrapper zeroes it) and only grows: barrier e (from 1) returns once all
// gridDim.x CTAs have arrived e times. The fence before the arrival
// publishes the CTA's global writes (the __syncthreads orders the other
// threads' writes before thread 0's fence); the acquire load and the
// fence after it order the reads that follow.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = gridDim.x * epoch;
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Set the kernel's dynamic shared-memory limit and launch it as one
// cooperative grid of `ctas` CTAs (all resident at once, or the launch
// fails with cudaErrorCooperativeLaunchTooLarge).
int launch_grid(const void* kernel, int ctas, int smem, void** args,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(THREADS), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many CTAs of `kernel` with `smem` bytes of dynamic shared memory the
// card holds at once (blocks per SM times SMs), or minus the CUDA error.
int max_ctas(const void* kernel, int smem) {
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

}  // namespace
