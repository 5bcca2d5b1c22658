// Shared by every kernel library of the port: the C-callable error string
// that the Python loader binds, and the bf16 helpers the kernels use.
// Each csrc/*.cu is built into its own shared library, so each carries its
// own copy of ktpu_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* ktpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ktpu {

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Sum over the whole block; every thread gets the total.  `scratch` holds
// one float per warp.  Block size is a multiple of 32, at most 1024.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ktpu
