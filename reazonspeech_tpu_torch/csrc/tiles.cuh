// Shared building blocks of the port's GEMM and LayerNorm kernels
// (plain C interface, no PyTorch headers).
//
// GEMM tiles: a 64x64 output tile per block of 4 warps (2x2, each warp owns
// a 32x32 quadrant) on the tensor cores through nvcuda::wmma, bf16 16x16x16
// fragments with fp32 accumulators, K-steps of 32 staged through shared
// memory. Used by conformer_conv.cu (the GLU and output products) and
// ln_dense.cu (the LayerNorm-fused projections).
//
// LayerNorm rows: fp32 mean and variance over D (the JAX kernels' chain:
// mean, centred second moment, rsqrt(var + eps), then the affine), one warp
// per row, and ln_rows_kernel, which writes one normalized row per warp,
// optionally after a residual add (x = r + scale·delta) and with rows past
// an utterance's length written as zeros.
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

// LayerNorm statistics of one row, computed by one whole warp: x(i) gives
// element i in fp32. Returns (mean, rsqrt(var + eps)), var the centred
// second moment, as every lane's value.
template <class Row>
__device__ __forceinline__ float2 ln_row_stats(const Row& x, int D, float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int i = lane; i < D; i += 32) s += x(i);
  const float mean = warp_sum(s) / D;
  float v = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float c = x(i) - mean;
    v += c * c;
  }
  return make_float2(mean, rsqrtf(warp_sum(v) / D + eps));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

}  // namespace rs

namespace {

constexpr int LN_ROWS_NT = 256;  // 8 rows (warps) per block

// One warp per row m of [M, D]:
//   x       = r[m] (+ scale·delta[m] when delta is given)    fp32, delta bf16
//   stream  = x                                              when stream is given
//   out[m]  = (x - mean)·rstd·g + b   -> TO, or zeros when MASK and the
//             row's frame (m mod T) is at or past lengths[m / T]
// Each pass re-reads the row (L1-resident: 4 KB at D=1024).
template <typename TO, bool MASK>
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
  if (MASK) {
    const int bt = m / T;
    if (m - bt * T >= lengths[bt]) {
      for (int i = lane; i < D; i += 32) rs::store(orow + i, 0.0f);
      return;
    }
  }
  const float* rrow = r + base;
  const rs::bf16* drow = delta ? delta + base : nullptr;
  auto x = [&](int i) {
    float v = rrow[i];
    if (drow) v += scale * rs::to_float(drow[i]);
    return v;
  };
  const float2 st = rs::ln_row_stats(x, D, eps);
  for (int i = lane; i < D; i += 32) {
    const float v = x(i);
    if (stream) stream[base + i] = v;
    const float xn = (v - st.x) * st.y;
    rs::store(orow + i, xn * g[i] + b[i]);
  }
}

template <typename TO, bool MASK>
int launch_ln_rows(const float* r, const rs::bf16* delta, float scale, const float* g,
                   const float* b, float* stream, TO* out, const int* lengths, int M, int T,
                   int D, float eps, cudaStream_t s) {
  constexpr int rows = LN_ROWS_NT / 32;
  ln_rows_kernel<TO, MASK><<<(M + rows - 1) / rows, LN_ROWS_NT, 0, s>>>(
      r, delta, scale, g, b, stream, out, lengths, M, T, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
