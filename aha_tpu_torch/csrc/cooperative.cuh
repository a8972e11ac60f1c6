// The grid-wide barrier and the launch of the persistent cooperative kernels
// (fused_decode_stack.cu, quant_swiglu.cu): one block per SM, all resident at
// once, so a block may wait at a barrier for every other block.
//
// cudaLaunchCooperativeKernel refuses a grid whose blocks cannot all be
// resident (it does not run them in waves), so a barrier cannot deadlock on
// a block that never started.  Writes before the barrier are visible to every
// block after it; read them through L2 (__ldcg), since another SM wrote them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace aha_coop {

__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// Launch `fn(args)` cooperatively: `grid` blocks of `threads`, `smem` bytes
// of dynamic shared memory (the attribute raised past 48 KB as needed).
template <typename Args>
int launch(void (*fn)(Args), const Args& args, int grid, int threads, size_t smem,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid),
                                    dim3(threads), params, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aha_coop
