// LayerNorm fused into the following dense projection, and the Conformer
// block's residual tail.
//
// Replaces: reazonspeech_tpu/ops/ln_dense.py (Pallas TPU kernels)
//   ln_dense      (:75)   out = act(bf16(LN(x))·W + c)                  -> bf16
//   ln_dense_add  (:193)  x = r + scale·delta (fp32), written out as the new
//                         stream, then out as in ln_dense              -> bf16, fp32
//   add_ln        (:300)  out = LN(r + scale·y), zero on rows t >= length[b] -> fp32
// LN: fp32 mean and centred variance over D, rsqrt(var + eps), then the
// affine; the normalized rows are rounded to bf16 for the product, which
// accumulates in fp32; the bias and the optional swish are fp32 and the
// result is rounded once (the JAX kernels' chain, ln_dense.py:50-69,169).
// W is one [D, N] matrix or up to three [D, Ni] segments (the packed q/k/v
// projection): their products are written side by side into one
// [M, ΣNi] output, and the kernel reads each segment where it lies, so no
// concatenated weight is built per call.
//
// What bounds it on the H100: at the serving shapes (B=4, T=401, D=1024)
// the FFN-in product is 13.5 GFLOP against 8 MB of weights and 6.6 MB of
// stream; the q/k/v product 10.1 GFLOP. Both are compute-bound: at the
// H100 SXM's 989 TFLOP/s of dense bf16 (data sheet) they take ~14 and
// ~10 us. This first GEMM is not pipelined and reaches a small share of
// that (PERF.md has its measured times). The TPU kernel kept the
// normalized [BT, D] tile in VMEM beside a VMEM-resident W; on Hopper a
// block's 227 KB of shared memory holds one 64-row bf16 tile at D=1024
// (128 KB) but then leaves ~26 blocks for 132 SMs at M=1604.
//
// Design: two launches. (1) ln_rows_kernel (tiles.cuh): one warp per row
// computes the statistics once and writes the normalized row as bf16 into
// a [M, D] scratch (3.3 MB at the serving shapes, which the 50 MB L2
// holds), after the residual add when there is one (the add's fp32 sum is
// written out there too). (2) dense_kernel: 64x64-output-tile GEMM on the
// tensor cores with the shared wmma tiles (tiles.cuh, as the conv module's
// products), one block per (row tile, column tile of ΣNi); each column tile
// lies in one segment (Ni % 64 == 0), whose weight and bias it reads. The
// epilogue adds the fp32 bias, applies swish and rounds once. The
// normalization runs once per row, never once per output column tile.
// add_ln is launch (1) alone with an fp32 output and the length mask.

#include "tiles.cuh"

using namespace rs::gemm;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_SEG = 3;

struct Segments {
  const bf16* w[MAX_SEG];   // [D, n[i]] row-major bf16
  const float* c[MAX_SEG];  // [n[i]] fp32
  int n[MAX_SEG];           // columns, multiples of GN; 0 past the last segment
};

struct Operands {  // the fp32 output tile reuses these bytes after the K loop
  bf16 a[GM * LDA];
  bf16 b[GK * LDB];
};
constexpr int SMEM_BYTES =
    sizeof(Operands) > GM * LDC * sizeof(float) ? sizeof(Operands) : GM * LDC * sizeof(float);

// out[m, n] = act(xn[m, :]·W[:, n] + c[n]) -> bf16, W and c the segment of column n
template <bool SWISH>
__global__ void __launch_bounds__(NT)
dense_kernel(const bf16* __restrict__ xn, Segments seg, bf16* __restrict__ out, int M, int D,
             int N) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Operands& s = *reinterpret_cast<Operands*>(smem);
  float* s_c = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  int si = 0, col0 = n0;  // this tile's segment and its first column there
  while (col0 >= seg.n[si]) col0 -= seg.n[si++];
  const bf16* w = seg.w[si];
  const float* c = seg.c[si];
  const int ldw = seg.n[si];
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  FragC acc[2][2];
  zero(acc);
  for (int k0 = 0; k0 < D; k0 += GK) {
    __syncthreads();
    load_a(s.a, xn, D, M, m0, k0);
    load_b(s.b, w, ldw, k0, col0);
    __syncthreads();
    mma_tile(s.a, s.b, acc, wm, wn);
  }

  __syncthreads();
  store_tile(s_c, acc, wm, wn);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = threadIdx.x + e * NT;
    const int r = i / GN, cc = i % GN, m = m0 + r;
    if (m < M) {
      float v = s_c[r * LDC + cc] + c[col0 + cc];
      if (SWISH) v = v * rs::sigmoid(v);
      out[size_t(m) * N + n0 + cc] = __float2bfloat16(v);
    }
  }
}

// launch (1) with or without the residual add, then launch (2)
int ln_dense_impl(const float* x, const bf16* delta, float scale, const float* g, const float* b,
                  const Segments& seg, bf16* xn, float* stream_out, bf16* out, int M, int D,
                  int swish, float eps, cudaStream_t s) {
  int N = 0;
  for (int i = 0; i < MAX_SEG; ++i) {
    if (seg.n[i] < 0 || seg.n[i] % GN != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (seg.n[i] > 0 && (i > 0 && seg.n[i - 1] == 0)) return static_cast<int>(cudaErrorInvalidValue);
    N += seg.n[i];
  }
  if (M <= 0 || D <= 0 || D % GK != 0 || N == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_ln_rows<bf16, false>(x, delta, scale, g, b, stream_out, xn,
                                                    nullptr, M, M, D, eps, s);
  if (err != 0) return err;
  const dim3 grid((M + GM - 1) / GM, N / GN);
  if (swish)
    dense_kernel<true><<<grid, NT, 0, s>>>(xn, seg, out, M, D, N);
  else
    dense_kernel<false><<<grid, NT, 0, s>>>(xn, seg, out, M, D, N);
  RS_RETURN_LAST_ERROR();
}

Segments segments(const void* w0, const void* w1, const void* w2, const void* c0,
                  const void* c1, const void* c2, int n0, int n1, int n2) {
  Segments seg;
  seg.w[0] = static_cast<const bf16*>(w0);
  seg.w[1] = static_cast<const bf16*>(w1);
  seg.w[2] = static_cast<const bf16*>(w2);
  seg.c[0] = static_cast<const float*>(c0);
  seg.c[1] = static_cast<const float*>(c1);
  seg.c[2] = static_cast<const float*>(c2);
  seg.n[0] = n0;
  seg.n[1] = n1;
  seg.n[2] = n2;
  return seg;
}

}  // namespace

// x [M, D] fp32; g, b [D] fp32; segment i: w_i [D, n_i] bf16, c_i [n_i] fp32
// (n_i = 0 and null pointers past the last); xn a [M, D] bf16 scratch;
// out [M, n_0 + n_1 + n_2] bf16
extern "C" int rs_ln_dense(const void* x, const void* g, const void* b, const void* w0,
                           const void* w1, const void* w2, const void* c0, const void* c1,
                           const void* c2, int n0, int n1, int n2, void* xn, void* out, int M,
                           int D, int swish, float eps, void* stream) {
  return ln_dense_impl(static_cast<const float*>(x), nullptr, 0.0f, static_cast<const float*>(g),
                       static_cast<const float*>(b),
                       segments(w0, w1, w2, c0, c1, c2, n0, n1, n2), static_cast<bf16*>(xn),
                       nullptr, static_cast<bf16*>(out), M, D, swish, eps,
                       static_cast<cudaStream_t>(stream));
}

// As rs_ln_dense on x = r + scale·delta (delta [M, D] bf16), with x written
// to stream_out [M, D] fp32.
extern "C" int rs_ln_dense_add(const void* r, const void* delta, const void* g, const void* b,
                               const void* w0, const void* w1, const void* w2, const void* c0,
                               const void* c1, const void* c2, int n0, int n1, int n2,
                               void* xn, void* stream_out, void* out, int M, int D, int swish,
                               float scale, float eps, void* stream) {
  return ln_dense_impl(static_cast<const float*>(r), static_cast<const bf16*>(delta), scale,
                       static_cast<const float*>(g), static_cast<const float*>(b),
                       segments(w0, w1, w2, c0, c1, c2, n0, n1, n2), static_cast<bf16*>(xn),
                       static_cast<float*>(stream_out), static_cast<bf16*>(out), M, D, swish,
                       eps, static_cast<cudaStream_t>(stream));
}

// out [B, T, D] fp32 = LN(r + scale·y), zero on rows t >= lengths[b];
// r fp32, y bf16, lengths [B] int32
extern "C" int rs_add_ln(const void* r, const void* y, const void* g, const void* b,
                         const void* lengths, void* out, int B, int T, int D, float scale,
                         float eps, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ln_rows<float, true>(
      static_cast<const float*>(r), static_cast<const bf16*>(y), scale,
      static_cast<const float*>(g), static_cast<const float*>(b), nullptr,
      static_cast<float*>(out), static_cast<const int*>(lengths), B * T, T, D, eps,
      static_cast<cudaStream_t>(stream));
}
