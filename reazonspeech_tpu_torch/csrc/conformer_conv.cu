// Fused Conformer convolution module: folded batch norm (nemo) or a
// per-frame LayerNorm (espnet).
//
// Replaces: reazonspeech_tpu/ops/conformer_conv.py, fused_conv_module
// (a Pallas TPU kernel), with norm="folded" or norm="layer", each in its two
// forms: the pre-module LayerNorm done by the caller (rs_fused_conv_module,
// rs_fused_conv_module_layer), or inside the kernel (rs_fused_conv_module_ln,
// rs_fused_conv_module_ln_layer: the JAX kernel's ln_scale/ln_bias path,
// conformer_conv.py:44-53). Contract, x [B, T, D] bf16 (layer-normed), or
// x_raw [B, T, D] fp32 (the residual stream) with x = bf16(LN(x_raw)):
//   h   = GLU(x·w_in + b_in)                 w_in [D, 2D] bf16, fp32 accumulate
//   h   = 0 on rows t >= length[b]           (so padding never leaks)
//   y   = Σ_j h[t+j-K/2]·dw[j] + b_dw         K-tap depthwise, SAME zero padding, fp32
//   y   = y·bn_scale + bn_bias               folded batch norm, fp32, or
//   y   = LN(y)·ln_g + ln_b                  per-frame LayerNorm over D (fp32
//                                            mean and centred variance, eps 1e-5)
//   y   = swish(y)
//   out = bf16(y)·w_out + b_out -> bf16      w_out [D, D] bf16, fp32 accumulate
//
// What bounds it on the H100: at the nemo bucket (B=4, T=376, D=1024,
// K=9) the two pointwise products are 9.5 GFLOP, which the bf16 tensor
// cores do in ~10 us; the bytes are the weights (6 MB) plus x and out
// (3 MB each). At espnet's 20 s window (B=1, T=549, D=512, K=31) the
// products are 0.9 GFLOP, ~1 us; the depthwise taps 17 MFLOP on the CUDA
// cores. The TPU kernel kept one utterance's [T, 2D] GLU tile in VMEM;
// a Hopper SM has 227 KB of shared memory, far less than that tile (3 MB at
// T=376), so this first version runs three launches and passes the chain
// through two [B, T, D] scratch tensors in HBM: the masked GLU output in
// fp32 and the swish output in bf16 (+~20 MB of traffic, mostly served by
// the 50 MB L2). Keeping them on chip (a persistent kernel over row tiles
// with a K-1 row halo, wgmma + TMA for the products) is later work.
//
// Design: launches 1 and 3 are 64x64-output-tile GEMMs on the tensor cores
// (nvcuda::wmma, bf16 16x16x16 fragments, fp32 accumulators), 4 warps per
// block, K-steps of 32 staged through shared memory. Launch 1 multiplies
// each x tile with the matching column tiles of both GLU halves (value and
// gate) and applies bias, GLU and the length mask in its epilogue. Launch 2
// is the depthwise sum over the scratch, where taps whose source row falls
// outside [0, T) of the row's own utterance read zero, then the norm and
// swish, rounded to bf16 where the JAX kernel rounds. With the folded norm
// it is elementwise, one thread per element; the LayerNorm reduces over D,
// so its launch 2 is a row pass instead: one block of 256 threads per
// (b, t) row, each thread the depthwise sums of D/256 channels in
// registers, the mean and centred variance by block reductions, then the
// affine and swish. Launch 2 is its own pass because building launch 3's
// operand tiles from the GLU scratch would recompute each depthwise sum once
// per output column tile (D/64 = 16 times at D=1024). Rows past B·T are
// zero in the GEMM operands and never written.
//
// In-kernel LayerNorm: a launch before launch 1 normalizes each row of the
// fp32 stream once (tiles.cuh ln_rows_kernel: one warp per row, fp32 mean
// and variance, eps 1e-5, the affine) into a [B, T, D] bf16 scratch, which
// is launch 1's A operand. Normalizing inside launch 1's operand loads
// would redo each row's statistics once per output column tile (16 times
// at D=1024) and read the stream in fp32 each time; the scratch costs one
// 2-byte write and read per element (3.3 MB at B=4, T=401, L2-resident).

#include "tiles.cuh"

using namespace nvcuda;
using namespace rs::gemm;

namespace {

typedef __nv_bfloat16 bf16;

struct Operands {   // the fp32 output tile reuses these bytes after the K loop
  bf16 a[GM * LDA];
  bf16 b0[GK * LDB];
  bf16 b1[GK * LDB];
};
constexpr int SMEM_BYTES =
    sizeof(Operands) > GM * LDC * sizeof(float) ? sizeof(Operands) : GM * LDC * sizeof(float);

// launch 1: glu[m, n] = (x·w_in + b_in)[m, n] · sigmoid((x·w_in + b_in)[m, D+n]),
// zero where the row's frame is at or past its utterance's length
__global__ void __launch_bounds__(NT)
pointwise_glu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                     const float* __restrict__ b_in, const int* __restrict__ lengths,
                     float* __restrict__ glu, int M, int T, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Operands& s = *reinterpret_cast<Operands*>(smem);
  float* s_c = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  FragC acc_a[2][2], acc_g[2][2];
  zero(acc_a);
  zero(acc_g);
  for (int k0 = 0; k0 < D; k0 += GK) {
    __syncthreads();
    load_a(s.a, x, D, M, m0, k0);
    load_b(s.b0, w_in, 2 * D, k0, n0);      // value half
    load_b(s.b1, w_in, 2 * D, k0, D + n0);  // gate half
    __syncthreads();
    mma_tile(s.a, s.b0, acc_a, wm, wn);
    mma_tile(s.a, s.b1, acc_g, wm, wn);
  }

  float a_val[PER_THREAD];
  __syncthreads();
  store_tile(s_c, acc_a, wm, wn);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = threadIdx.x + e * NT;
    a_val[e] = s_c[(i / GN) * LDC + i % GN];
  }
  __syncthreads();
  store_tile(s_c, acc_g, wm, wn);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = threadIdx.x + e * NT;
    const int r = i / GN, c = i % GN, m = m0 + r, n = n0 + c;
    if (m < M) {
      const float a = a_val[e] + b_in[n];
      const float g = s_c[r * LDC + c] + b_in[D + n];
      const int bt = m / T;
      const float h = (m - bt * T < lengths[bt]) ? a * rs::sigmoid(g) : 0.0f;
      glu[size_t(m) * D + n] = h;
    }
  }
}

// launch 2: y = bf16(swish((Σ_j glu[t+j-K/2]·dw[j] + b_dw)·bn_scale + bn_bias)),
// one thread per element, taps outside [0, T) of the row's own utterance zero
__global__ void __launch_bounds__(256)
depthwise_norm_swish_kernel(const float* __restrict__ glu, const float* __restrict__ dw,
                            const float* __restrict__ b_dw, const float* __restrict__ bn_scale,
                            const float* __restrict__ bn_bias, bf16* __restrict__ y, int M,
                            int T, int D, int K) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(M) * D) return;
  const int m = static_cast<int>(i / D), ch = static_cast<int>(i % D);
  const int bt = m / T, t = m - bt * T, half = K / 2;
  const float* src = glu + size_t(bt) * T * D + ch;  // this utterance, channel ch
  float sum = 0.0f;
  for (int j = 0; j < K; ++j) {
    const int tt = t + j - half;
    if (tt >= 0 && tt < T) sum += src[size_t(tt) * D] * dw[j * D + ch];
  }
  float v = (sum + b_dw[ch]) * bn_scale[ch] + bn_bias[ch];
  v = v * rs::sigmoid(v);
  y[i] = __float2bfloat16(v);
}

// launch 2, per-frame LayerNorm: one block per row m of [M, D];
// y = bf16(swish(LN(Σ_j glu[t+j-K/2]·dw[j] + b_dw)·ln_g + ln_b))
constexpr int ROW_NT = 256;
constexpr int ROW_MAXC = 8;  // channels per thread: D <= 2048

// Σ v over the block, as every thread's value; red is [ROW_NT / 32] shared
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = rs::warp_sum(v);
  __syncthreads();  // red is free (a previous call's readers are done)
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < ROW_NT / 32; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(ROW_NT)
depthwise_layer_norm_swish_kernel(const float* __restrict__ glu, const float* __restrict__ dw,
                                  const float* __restrict__ b_dw, const float* __restrict__ ln_g,
                                  const float* __restrict__ ln_b, bf16* __restrict__ y, int T,
                                  int D, int K) {
  __shared__ float red[ROW_NT / 32];
  const int m = blockIdx.x;
  const int bt = m / T, t = m - bt * T, half = K / 2;
  const float* src = glu + size_t(bt) * T * D;  // this utterance
  float acc[ROW_MAXC];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXC; ++i) {
    const int ch = threadIdx.x + i * ROW_NT;
    acc[i] = 0.0f;
    if (ch < D) {
      float s = 0.0f;
      for (int j = 0; j < K; ++j) {
        const int tt = t + j - half;
        if (tt >= 0 && tt < T) s += src[size_t(tt) * D + ch] * dw[j * D + ch];
      }
      acc[i] = s + b_dw[ch];
      sum += acc[i];
    }
  }
  const float mean = block_sum(sum, red) / D;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXC; ++i) {
    const int ch = threadIdx.x + i * ROW_NT;
    if (ch < D) sq += (acc[i] - mean) * (acc[i] - mean);
  }
  const float rstd = rsqrtf(block_sum(sq, red) / D + 1e-5f);
#pragma unroll
  for (int i = 0; i < ROW_MAXC; ++i) {
    const int ch = threadIdx.x + i * ROW_NT;
    if (ch < D) {
      float v = (acc[i] - mean) * rstd * ln_g[ch] + ln_b[ch];
      v = v * rs::sigmoid(v);
      y[size_t(m) * D + ch] = __float2bfloat16(v);
    }
  }
}

// launch 3: out = y·w_out + b_out -> bf16
__global__ void __launch_bounds__(NT)
pointwise_out_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w_out,
                     const float* __restrict__ b_out, bf16* __restrict__ out, int M, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Operands& s = *reinterpret_cast<Operands*>(smem);
  float* s_c = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  FragC acc[2][2];
  zero(acc);
  for (int k0 = 0; k0 < D; k0 += GK) {
    __syncthreads();
    load_a(s.a, y, D, M, m0, k0);
    load_b(s.b0, w_out, D, k0, n0);
    __syncthreads();
    mma_tile(s.a, s.b0, acc, wm, wn);
  }

  __syncthreads();
  store_tile(s_c, acc, wm, wn);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = threadIdx.x + e * NT;
    const int r = i / GN, c = i % GN, m = m0 + r, n = n0 + c;
    if (m < M) out[size_t(m) * D + n] = __float2bfloat16(s_c[r * LDC + c] + b_out[n]);
  }
}

// The three launches from a bf16 x; norm_scale/norm_bias are the folded
// batch norm's, or the LayerNorm's affine when layer
int conv_module(const void* x, const void* w_in, const void* b_in, const void* dw,
                const void* b_dw, const void* norm_scale, const void* norm_bias,
                const void* w_out, const void* b_out, const void* lengths, void* glu, void* y,
                void* out, int B, int T, int D, int K, bool layer, cudaStream_t s) {
  const int M = B * T;
  const dim3 grid((M + GM - 1) / GM, D / GN);
  pointwise_glu_kernel<<<grid, NT, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
      static_cast<const float*>(b_in), static_cast<const int*>(lengths),
      static_cast<float*>(glu), M, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* g = static_cast<const float*>(glu);
  const float* taps = static_cast<const float*>(dw);
  const float* bias_dw = static_cast<const float*>(b_dw);
  const float* ns = static_cast<const float*>(norm_scale);
  const float* nb = static_cast<const float*>(norm_bias);
  if (layer) {
    depthwise_layer_norm_swish_kernel<<<M, ROW_NT, 0, s>>>(g, taps, bias_dw, ns, nb,
                                                           static_cast<bf16*>(y), T, D, K);
  } else {
    const size_t n = size_t(M) * D;
    depthwise_norm_swish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        g, taps, bias_dw, ns, nb, static_cast<bf16*>(y), M, T, D, K);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pointwise_out_kernel<<<grid, NT, 0, s>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(w_out),
      static_cast<const float*>(b_out), static_cast<bf16*>(out), M, D);
  RS_RETURN_LAST_ERROR();
}

bool shape_ok(int B, int T, int D, int K, bool layer) {
  return B > 0 && T > 0 && K > 0 && D > 0 && D % GN == 0 &&
         (!layer || D <= ROW_NT * ROW_MAXC);
}

// bf16(LN(x_raw)) into the xn scratch, then the three launches
int conv_module_ln(const void* x_raw, const void* ln_g, const void* ln_b, const void* w_in,
                   const void* b_in, const void* dw, const void* b_dw, const void* norm_scale,
                   const void* norm_bias, const void* w_out, const void* b_out,
                   const void* lengths, void* xn, void* glu, void* y, void* out, int B, int T,
                   int D, int K, bool layer, void* stream) {
  if (!shape_ok(B, T, D, K, layer)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_ln_rows<bf16, false>(
      static_cast<const float*>(x_raw), nullptr, 0.0f, static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), nullptr, static_cast<bf16*>(xn), nullptr, B * T, T, D,
      1e-5f, s);
  if (err != 0) return err;
  return conv_module(xn, w_in, b_in, dw, b_dw, norm_scale, norm_bias, w_out, b_out, lengths,
                     glu, y, out, B, T, D, K, layer, s);
}

}  // namespace

// x [B, T, D] bf16 (layer-normed by the caller); glu [B, T, D] fp32 and
// y [B, T, D] bf16 scratch; bn_scale/bn_bias the folded batch norm
extern "C" int rs_fused_conv_module(const void* x, const void* w_in, const void* b_in,
                                    const void* dw, const void* b_dw, const void* bn_scale,
                                    const void* bn_bias, const void* w_out, const void* b_out,
                                    const void* lengths, void* glu, void* y, void* out, int B,
                                    int T, int D, int K, void* stream) {
  if (!shape_ok(B, T, D, K, false)) return static_cast<int>(cudaErrorInvalidValue);
  return conv_module(x, w_in, b_in, dw, b_dw, bn_scale, bn_bias, w_out, b_out, lengths, glu, y,
                     out, B, T, D, K, false, static_cast<cudaStream_t>(stream));
}

// The same module with the per-frame LayerNorm (ln_g, ln_b its affine) in
// place of the folded batch norm
extern "C" int rs_fused_conv_module_layer(const void* x, const void* w_in, const void* b_in,
                                          const void* dw, const void* b_dw, const void* ln_g,
                                          const void* ln_b, const void* w_out, const void* b_out,
                                          const void* lengths, void* glu, void* y, void* out,
                                          int B, int T, int D, int K, void* stream) {
  if (!shape_ok(B, T, D, K, true)) return static_cast<int>(cudaErrorInvalidValue);
  return conv_module(x, w_in, b_in, dw, b_dw, ln_g, ln_b, w_out, b_out, lengths, glu, y, out, B,
                     T, D, K, true, static_cast<cudaStream_t>(stream));
}

// The pre-module LayerNorm inside: x_raw [B, T, D] fp32, ln_g/ln_b [D] fp32,
// xn a [B, T, D] bf16 scratch for bf16(LN(x_raw)); folded batch norm
extern "C" int rs_fused_conv_module_ln(const void* x_raw, const void* ln_g, const void* ln_b,
                                       const void* w_in, const void* b_in, const void* dw,
                                       const void* b_dw, const void* bn_scale,
                                       const void* bn_bias, const void* w_out,
                                       const void* b_out, const void* lengths, void* xn,
                                       void* glu, void* y, void* out, int B, int T, int D,
                                       int K, void* stream) {
  return conv_module_ln(x_raw, ln_g, ln_b, w_in, b_in, dw, b_dw, bn_scale, bn_bias, w_out, b_out,
                        lengths, xn, glu, y, out, B, T, D, K, false, stream);
}

// The pre-module LayerNorm inside and the per-frame LayerNorm (norm_g,
// norm_b its affine) in place of the folded batch norm
extern "C" int rs_fused_conv_module_ln_layer(const void* x_raw, const void* ln_g,
                                             const void* ln_b, const void* w_in,
                                             const void* b_in, const void* dw, const void* b_dw,
                                             const void* norm_g, const void* norm_b,
                                             const void* w_out, const void* b_out,
                                             const void* lengths, void* xn, void* glu, void* y,
                                             void* out, int B, int T, int D, int K,
                                             void* stream) {
  return conv_module_ln(x_raw, ln_g, ln_b, w_in, b_in, dw, b_dw, norm_g, norm_b, w_out, b_out,
                        lengths, xn, glu, y, out, B, T, D, K, true, stream);
}
