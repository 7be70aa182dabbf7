// The LayerNorm row kernel of the port (plain C interface, no PyTorch
// headers): ln_rows_kernel, fp32 mean and variance over D (the JAX
// kernels' chain: mean, centred second moment, rsqrt(var + eps), then the
// affine), which writes one normalized row per warp, optionally after a
// residual add (x = r + scale·delta) and with rows past an utterance's
// length written as zeros (ln_dense.cu's launch (1) and add_ln, and the
// conv module's in-kernel LayerNorm). The GEMMs are gemm_sm90.cuh's.
#pragma once

#include "common.cuh"

namespace rs {

typedef __nv_bfloat16 bf16;

// W consecutive elements at p as fp32 (W = 4: one 16-byte load of fp32,
// one 8-byte load of bf16), and their store
template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void load_w(const bf16* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    v[0] = to_float(*p);
  }
}
template <int W>
__device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
template <int W>
__device__ __forceinline__ void store_w(bf16* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

}  // namespace rs

namespace {

constexpr int LN_ROWS_NT = 256;  // 8 rows (warps) per block

// One warp per row m of [M, D]:
//   x       = r[m] (+ scale·delta[m] when delta is given)    fp32, delta bf16
//   stream  = x                                              when stream is given
//   out[m]  = (x - mean)·rstd·g + b   -> TO, or zeros when MASK and the
//             row's frame (m mod T) is at or past lengths[m / T]
// mean and the centred variance in fp32, rsqrt(var + eps). A lane takes W
// consecutive elements at a time (W = 4 where D allows it: 16-byte loads,
// so a pass over the row issues a quarter of the loads, all in flight at
// once); each of the three passes re-reads the row (L1-resident: 4 KB at
// D=1024).
template <typename TO, bool MASK, int W>
__global__ void __launch_bounds__(LN_ROWS_NT)
ln_rows_kernel(const float* __restrict__ r, const rs::bf16* __restrict__ delta, float scale,
               const float* __restrict__ g, const float* __restrict__ b,
               float* __restrict__ stream, TO* __restrict__ out,
               const int* __restrict__ lengths, int M, int T, int D, float eps) {
  const int m = blockIdx.x * (LN_ROWS_NT / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  const size_t base = size_t(m) * D;
  TO* orow = out + base;
  float v[W];
  if (MASK) {
    const int bt = m / T;
    if (m - bt * T >= lengths[bt]) {
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] = 0.0f;
      for (int i = lane * W; i < D; i += 32 * W) rs::store_w<W>(orow + i, v);
      return;
    }
  }
  const float* rrow = r + base;
  const rs::bf16* drow = delta ? delta + base : nullptr;
  auto x = [&](int i) {  // v = x[i : i + W]
    rs::load_w<W>(rrow + i, v);
    if (drow) {
      float d[W];
      rs::load_w<W>(drow + i, d);
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] += scale * d[k];
    }
  };
  float s = 0.0f;
#pragma unroll 4
  for (int i = lane * W; i < D; i += 32 * W) {
    x(i);
#pragma unroll
    for (int k = 0; k < W; ++k) s += v[k];
  }
  const float mean = rs::warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll 4
  for (int i = lane * W; i < D; i += 32 * W) {
    x(i);
#pragma unroll
    for (int k = 0; k < W; ++k) q += (v[k] - mean) * (v[k] - mean);
  }
  const float rstd = rsqrtf(rs::warp_sum(q) / D + eps);
#pragma unroll 4
  for (int i = lane * W; i < D; i += 32 * W) {
    x(i);
    if (stream) rs::store_w<W>(stream + base + i, v);
    float gw[W], bw[W];
    rs::load_w<W>(g + i, gw);
    rs::load_w<W>(b + i, bw);
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = (v[k] - mean) * rstd * gw[k] + bw[k];
    rs::store_w<W>(orow + i, v);
  }
}

template <typename TO, bool MASK>
int launch_ln_rows(const float* r, const rs::bf16* delta, float scale, const float* g,
                   const float* b, float* stream, TO* out, const int* lengths, int M, int T,
                   int D, float eps, cudaStream_t s) {
  constexpr int rows = LN_ROWS_NT / 32;
  const int blocks = (M + rows - 1) / rows;
  if (D % 4 == 0)  // rows of whole 16-byte units (the tensors themselves are 16-byte aligned)
    ln_rows_kernel<TO, MASK, 4><<<blocks, LN_ROWS_NT, 0, s>>>(r, delta, scale, g, b, stream, out,
                                                               lengths, M, T, D, eps);
  else
    ln_rows_kernel<TO, MASK, 1><<<blocks, LN_ROWS_NT, 0, s>>>(r, delta, scale, g, b, stream, out,
                                                               lengths, M, T, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
