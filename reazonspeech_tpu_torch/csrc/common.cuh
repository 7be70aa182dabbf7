// Shared helpers for the port's kernels (plain C interface, no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rs {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The top-m order of lax.top_k: the larger value first, the lower index
// among equal values.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Warp-wide reductions; every lane returns the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

// The block's best (value, index) in the top-m order over NT threads (a
// multiple of 32); every thread returns it, the warps' results combined in
// a fixed order. ``s_f``/``s_i`` hold NT / 32 entries. The trailing barrier
// lets the caller reuse the scratch right away.
template <int NT>
__device__ __forceinline__ void block_argmax(float& bv, int& bi, float* s_f, int* s_i) {
  warp_argmax(bv, bi);
  if (threadIdx.x % 32 == 0) { s_f[threadIdx.x / 32] = bv; s_i[threadIdx.x / 32] = bi; }
  __syncthreads();
  bv = s_f[0];
  bi = s_i[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w)
    if (better(s_f[w], s_i[w], bv, bi)) { bv = s_f[w]; bi = s_i[w]; }
  __syncthreads();
}

}  // namespace rs

// Every C entry returns this: 0, or the CUDA error of the launch.
#define RS_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
