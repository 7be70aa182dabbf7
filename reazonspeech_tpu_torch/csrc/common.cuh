// Shared helpers for the port's kernels (plain C interface, no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rs {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace rs

// Every C entry returns this: 0, or the CUDA error of the launch.
#define RS_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
