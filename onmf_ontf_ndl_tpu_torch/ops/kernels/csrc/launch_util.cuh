// Launch helpers shared by the kernel sources of this library.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Let kernel `fn` take `smem` bytes of dynamic shared memory: past 48 KB a
// kernel needs the attribute set before its launch. Returns 0 or the CUDA
// error, which it also clears.
static inline int launch_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch check reports it
      return (int)e;
    }
  }
  return 0;
}
