// Shared building blocks of the port's GEMM and LayerNorm kernels
// (plain C interface, no PyTorch headers).
//
// GEMM tiles: a 64x64 output tile per block of 4 warps (2x2, each warp owns
// a 32x32 quadrant) on the tensor cores through nvcuda::wmma, bf16 16x16x16
// fragments with fp32 accumulators, K-steps of 32 staged through shared
// memory, not pipelined. Used only by conformer_conv.cu (the GLU and output
// products) until it moves onto gemm_sm90.cuh's TMA + wgmma mainloop, which
// ln_dense.cu's projections use.
//
// LayerNorm rows: ln_rows_kernel, fp32 mean and variance over D (the JAX
// kernels' chain: mean, centred second moment, rsqrt(var + eps), then the
// affine), which writes one normalized row per warp,
// optionally after a residual add (x = r + scale·delta) and with rows past
// an utterance's length written as zeros (ln_dense.cu's launch (1) and
// add_ln, and the conv module's in-kernel LayerNorm).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace rs {

typedef __nv_bfloat16 bf16;

namespace gemm {

constexpr int GM = 64, GN = 64, GK = 32;  // output tile and K-step
constexpr int NT = 128;                   // 4 warps, 2x2 over the output tile
constexpr int LDA = GK + 8;               // bf16 strides: 16-B rows, wmma ldm % 8 == 0
constexpr int LDB = GN + 8;
constexpr int LDC = GN + 4;  // fp32 output tile stride
constexpr int PER_THREAD = GM * GN / NT;  // epilogue elements per thread

typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major> FragA;
typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major> FragB;
typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> FragC;

// rows m0..m0+GM (zero past M), columns k0..k0+GK of a row-major [M, lda] bf16 matrix
__device__ __forceinline__ void load_a(bf16* dst, const bf16* x, int lda, int M, int m0, int k0) {
  for (int i = threadIdx.x; i < GM * GK / 8; i += NT) {
    const int r = i / (GK / 8), c = (i % (GK / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * lda + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDA + c) = val;
  }
}

// rows k0..k0+GK, columns col0..col0+GN of a row-major [*, ldw] bf16 matrix
__device__ __forceinline__ void load_b(bf16* dst, const bf16* w, int ldw, int k0, int col0) {
  for (int i = threadIdx.x; i < GK * GN / 8; i += NT) {
    const int r = i / (GN / 8), c = (i % (GN / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDB + c) =
        *reinterpret_cast<const uint4*>(w + size_t(k0 + r) * ldw + col0 + c);
  }
}

__device__ __forceinline__ void zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc += A[warp rows, :GK] · B[:GK, warp cols]; the warp owns a 32x32 quadrant
__device__ __forceinline__ void mma_tile(const bf16* a, const bf16* b, FragC (&acc)[2][2],
                                         int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < GK; kk += 16) {
    FragA fa[2];
    FragB fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      nvcuda::wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::load_matrix_sync(fb[j], b + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* c, FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(c + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                      acc[i][j], LDC, nvcuda::wmma::mem_row_major);
}

}  // namespace gemm

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
