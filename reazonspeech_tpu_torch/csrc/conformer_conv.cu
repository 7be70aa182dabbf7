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
// What bounds it on the H100: at the nemo bucket (B=4, T=401, D=1024,
// K=9) the two pointwise products are 10.1 GFLOP, ~10 us at the bf16
// tensor cores' 989 TFLOP/s (data sheet); the bytes are the weights (6 MB)
// and x and out (~3.3 MB each), ~4 us. At espnet's 20 s window (B=1, T=549,
// D=512, K=31) the products are 0.9 GFLOP and the module is bound by its
// bytes and its latency: 5 x 2-4 output tiles for 132 SMs. The TPU kernel
// kept one utterance's [T, 2D] GLU tile in VMEM; a Hopper SM has 227 KB of
// shared memory, far less than that tile (3 MB at T=376), so the chain
// passes through two [B, T, D] scratch tensors in HBM, mostly served by the
// 50 MB L2: the masked GLU output h in fp32 and the swish output y in bf16.
//
// Design: four launches.
// (1) in-kernel LayerNorm only: tiles.cuh's ln_rows_kernel normalizes each
//     row of the fp32 stream once into a [B, T, D] bf16 scratch, the GLU
//     product's A operand (a TMA load needs it in global memory; normalizing
//     inside the product would redo each row's statistics once per output
//     column tile).
// (2) the GLU product on gemm_sm90.cuh's persistent TMA + wgmma mainloop in
//     its paired form: a B tile holds BN / 2 value columns [n0, n0 + BN/2)
//     and the matching gate columns [D + n0, ...) of the one w_in, through two
//     tensor maps on its halves, so that a thread holds each value column's
//     accumulator beside its gate's; the epilogue adds both biases, applies
//     a·sigmoid(g) and the length mask in registers and TMA-stores h as a
//     64 x BN/2 fp32 tile (the bytes of a 64 x BN bf16 one).
// (3) the depthwise sum, the norm and swish, rounded to bf16 where the JAX
//     kernel rounds, over the h scratch (taps whose source row falls outside
//     [0, T) of the row's own utterance read zero), on 16-byte loads: with
//     the folded norm one thread per 4 channels x 8 rows (the rows' taps
//     overlap, so a row of h is read from L2 about twice, not K times); with
//     the LayerNorm, which reduces over D, a block per up to 8 rows of one
//     utterance whose threads take 4 channels of every row, keeping the
//     rows' fp32 sums in shared memory, then each row's statistics to one
//     warp (any D whose row of sums fits in shared memory). It is its own
//     pass because building (4)'s operand tiles from h would recompute each
//     sum once per output column tile.
// (4) the output product y·w_out + b_out -> bf16 on the same mainloop, a
//     bias-only epilogue.
// The column tile (BN 256 or 128) of each product is the one that needs
// fewer tile-columns of work in whole waves over the SMs, the wider on a
// tie (the rule of ln_dense.cu): at nemo's shape 256 for (2) (104 tiles of
// 128 x 128 outputs), 128 for (4) (104 tiles of 128 x 128 against 52 of
// 128 x 256). Ragged M and D cost nothing: each tensor map carries its true
// extent (zero-filled loads, clipped stores), so D needs only be a multiple
// of 8 (TMA's 16-byte strides).

#include "gemm_sm90.cuh"
#include "tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using rs::sm90::Tile;

// everything a product's launch needs, passed by value (the tensor maps
// must lie in the kernel's parameter space)
struct GemmParams {
  CUtensorMap a;       // [M, D] bf16: x (2) or y (4)
  CUtensorMap b[2];    // (2): w_in's value and gate halves, [D, D] at a stride of 2D; (4): w_out
  CUtensorMap out;     // (2): h [M, D] fp32; (4): out [M, D] bf16
  const float* bias;   // (2): b_in [2D]; (4): b_out [D]
  const int* lengths;  // [B]
  int M, T, D, m_tiles, n_tiles, k_tiles;
};

template <int COLS>
struct Schedule {  // tile t: row tile t % m_tiles, column tile t / m_tiles of COLS output columns
  const GemmParams& p;
  __device__ int tiles() const { return p.m_tiles * p.n_tiles; }
  __device__ Tile operator()(int t) const {
    return Tile{(t % p.m_tiles) * rs::sm90::BM, 0, (t / p.m_tiles) * COLS};
  }
};

// (2): h = (a + b_in[n])·sigmoid(g + b_in[D + n]) on rows inside their
// utterance's length, else 0. The sigmoid takes the hardware exp2 and divide
// (__expf, __fdividef): a few fp32 ulps.
template <int BN>
struct GluEpilogue {
  static constexpr bool PAIRED = true;
  typedef float Out;
  const GemmParams& p;
  __device__ int cols(const Tile&) const { return p.D; }
  __device__ float column(const Tile& tile, int i) const {
    const int n = tile.n0 + (i < BN / 2 ? i : i - BN / 2);
    return n < p.D ? __ldg(p.bias + (i < BN / 2 ? n : p.D + n)) : 0.0f;
  }
  __device__ float row(int m) const {  // 1 on a valid frame, 0 past the length or M
    if (m >= p.M) return 0.0f;
    const int bt = m / p.T;
    return m - bt * p.T < __ldg(p.lengths + bt) ? 1.0f : 0.0f;
  }
  __device__ float operator()(float a, float ca, float g, float cg, float valid) const {
    return valid != 0.0f ? (a + ca) * __fdividef(1.0f, 1.0f + __expf(-(g + cg))) : 0.0f;
  }
};

// (4): acc + b_out[n]
struct BiasEpilogue {
  static constexpr bool PAIRED = false;
  typedef bf16 Out;
  const GemmParams& p;
  __device__ int cols(const Tile&) const { return p.D; }
  __device__ float column(const Tile& tile, int i) const {
    const int n = tile.n0 + i;
    return n < p.D ? __ldg(p.bias + n) : 0.0f;
  }
  __device__ float operator()(float v, float c) const { return v + c; }
};

template <int BN, bool GLU>
__global__ void __launch_bounds__(rs::sm90::NT, 1)
conv_gemm_kernel(const __grid_constant__ GemmParams p) {
  if constexpr (GLU)
    rs::sm90::gemm_persistent<BN>(&p.a, p.b, &p.out, p.k_tiles, p.M, Schedule<BN / 2>{p},
                                  GluEpilogue<BN>{p});
  else
    rs::sm90::gemm_persistent<BN>(&p.a, p.b, &p.out, p.k_tiles, p.M, Schedule<BN>{p},
                                  BiasEpilogue{p});
}

template <int BN, bool GLU>
int launch_gemm(GemmParams& p, int sms, cudaStream_t s) {
  constexpr int smem = rs::sm90::Config<BN>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_gemm_kernel<BN, GLU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.n_tiles = (p.D + (GLU ? BN / 2 : BN) - 1) / (GLU ? BN / 2 : BN);
  const int tiles = p.m_tiles * p.n_tiles;
  conv_gemm_kernel<BN, GLU><<<tiles < sms ? tiles : sms, rs::sm90::NT, smem, s>>>(p);
  RS_RETURN_LAST_ERROR();
}

// One product: (2) when GLU (x·w_in -> h), else (4) (y·w_out -> out)
template <bool GLU>
int product(const bf16* x, const bf16* w, const float* bias, const int* lengths, void* out, int M,
            int T, int D, cudaStream_t s) {
  GemmParams p = {};
  int err = rs::sm90::encode_map(&p.a, x, M, D, D, rs::sm90::BM);
  if (GLU) {
    if (err == 0) err = rs::sm90::encode_map(&p.b[0], w, D, D, 2 * D, rs::sm90::BK);
    if (err == 0) err = rs::sm90::encode_map(&p.b[1], w + D, D, D, 2 * D, rs::sm90::BK);
    if (err == 0) err = rs::sm90::encode_map(&p.out, out, M, D, D, 64, true);
  } else {
    if (err == 0) err = rs::sm90::encode_map(&p.b[0], w, D, D, D, rs::sm90::BK);
    if (err == 0) err = rs::sm90::encode_map(&p.out, out, M, D, D, 64);
  }
  if (err != 0) return err;
  p.bias = bias;
  p.lengths = lengths;
  p.M = M;
  p.T = T;
  p.D = D;
  p.m_tiles = (M + rs::sm90::BM - 1) / rs::sm90::BM;
  p.k_tiles = (D + rs::sm90::BK - 1) / rs::sm90::BK;
  const int sms = rs::sm90::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  auto cost = [&](int bn) {  // a B tile of bn columns gives bn / 2 GLU output columns
    const int cols = GLU ? bn / 2 : bn;
    return rs::sm90::wave_cost(p.m_tiles * ((D + cols - 1) / cols), bn, sms);
  };
  const int bn = rs::sm90::pick_tile_n(cost(256), cost(128));
  return bn == 256 ? launch_gemm<256, GLU>(p, sms, s) : launch_gemm<128, GLU>(p, sms, s);
}

// (3), folded norm: y = bf16(swish((Σ_j h[t+j-K/2]·dw[j] + b_dw)·bn_scale + bn_bias));
// a thread takes 4 channels of DW_ROWS consecutive rows of one utterance
constexpr int DW_NT = 256;
constexpr int DW_ROWS = 8;

__device__ __forceinline__ void fma4(float4& acc, const float4& v, const float4& w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

__device__ __forceinline__ float swish(float v) { return v * rs::sigmoid(v); }

__device__ __forceinline__ void store_bf16x4(bf16* dst, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}

__global__ void __launch_bounds__(DW_NT)
depthwise_norm_swish_kernel(const float* __restrict__ h, const float* __restrict__ dw,
                            const float* __restrict__ b_dw, const float* __restrict__ bn_scale,
                            const float* __restrict__ bn_bias, bf16* __restrict__ y, int B, int T,
                            int D, int K) {
  const int groups = D / 4, row_blocks = (T + DW_ROWS - 1) / DW_ROWS;
  const long long i = static_cast<long long>(blockIdx.x) * DW_NT + threadIdx.x;
  if (i >= static_cast<long long>(B) * row_blocks * groups) return;
  const int ch = static_cast<int>(i % groups) * 4;
  const int rb = static_cast<int>(i / groups);
  const int bt = rb / row_blocks, t0 = (rb % row_blocks) * DW_ROWS, half = K / 2;
  const float* src = h + size_t(bt) * T * D + ch;  // this utterance, channels ch..ch+3
  float4 acc[DW_ROWS];
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < K; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(dw + size_t(j) * D + ch);
#pragma unroll
    for (int r = 0; r < DW_ROWS; ++r) {
      const int tt = t0 + r + j - half;
      if (tt >= 0 && tt < T) fma4(acc[r], *reinterpret_cast<const float4*>(src + size_t(tt) * D), w);
    }
  }
  const float4 bd = *reinterpret_cast<const float4*>(b_dw + ch);
  const float4 sc = *reinterpret_cast<const float4*>(bn_scale + ch);
  const float4 bi = *reinterpret_cast<const float4*>(bn_bias + ch);
#pragma unroll
  for (int r = 0; r < DW_ROWS; ++r) {
    if (t0 + r >= T) break;
    const float4 a = acc[r];
    store_bf16x4(y + (size_t(bt) * T + t0 + r) * D + ch, swish((a.x + bd.x) * sc.x + bi.x),
                 swish((a.y + bd.y) * sc.y + bi.y), swish((a.z + bd.z) * sc.z + bi.z),
                 swish((a.w + bd.w) * sc.w + bi.w));
  }
}

// (3), per-frame LayerNorm: a block takes ``rows`` (1..8) consecutive rows
// of [M, D] of one utterance; a thread takes 4 channels of all of them (a
// tap's weights loaded once for the rows, the rows' taps overlapping in L1)
// and writes their depthwise sums (+ b_dw) into shared memory; then each
// warp normalizes whole rows: y = bf16(swish(LN(sum)·ln_g + ln_b)), fp32
// mean and centred variance
constexpr int LN_NT = 128;
constexpr int LN_MAX_ROWS = 8;

__global__ void __launch_bounds__(LN_NT)
depthwise_layer_norm_swish_kernel(const float* __restrict__ h, const float* __restrict__ dw,
                                  const float* __restrict__ b_dw, const float* __restrict__ ln_g,
                                  const float* __restrict__ ln_b, bf16* __restrict__ y, int B,
                                  int T, int D, int K, int rows) {
  extern __shared__ float4 sums[];  // [rows][D / 4]
  const int groups = D / 4, row_blocks = (T + rows - 1) / rows, half = K / 2;
  const int bt = blockIdx.x / row_blocks, t0 = (blockIdx.x % row_blocks) * rows;
  const int n = min(rows, T - t0);  // rows of this block
  const float* src = h + size_t(bt) * T * D;  // this utterance
  for (int c = threadIdx.x; c < groups; c += LN_NT) {
    float4 acc[LN_MAX_ROWS];
#pragma unroll
    for (int r = 0; r < LN_MAX_ROWS; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < K; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(dw + size_t(j) * D + 4 * c);
#pragma unroll
      for (int r = 0; r < LN_MAX_ROWS; ++r) {
        const int tt = t0 + r + j - half;
        if (r < n && tt >= 0 && tt < T)
          fma4(acc[r], *reinterpret_cast<const float4*>(src + size_t(tt) * D + 4 * c), w);
      }
    }
    const float4 bd = *reinterpret_cast<const float4*>(b_dw + 4 * c);
#pragma unroll
    for (int r = 0; r < LN_MAX_ROWS; ++r)
      if (r < n)
        sums[r * groups + c] =
            make_float4(bd.x + acc[r].x, bd.y + acc[r].y, bd.z + acc[r].z, bd.w + acc[r].w);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < n; r += LN_NT / 32) {
    const float4* row = sums + r * groups;
    float s = 0.0f;
    for (int c = lane; c < groups; c += 32) {
      const float4 v = row[c];
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = rs::warp_sum(s) / D;
    float q = 0.0f;
    for (int c = lane; c < groups; c += 32) {
      const float4 v = row[c];
      q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean) +
           (v.z - mean) * (v.z - mean) + (v.w - mean) * (v.w - mean);
    }
    const float rstd = rsqrtf(rs::warp_sum(q) / D + 1e-5f);
    bf16* out = y + (size_t(bt) * T + t0 + r) * D;
    for (int c = lane; c < groups; c += 32) {
      const float4 v = row[c];
      const float4 g = *reinterpret_cast<const float4*>(ln_g + 4 * c);
      const float4 b = *reinterpret_cast<const float4*>(ln_b + 4 * c);
      store_bf16x4(out + 4 * c, swish((v.x - mean) * rstd * g.x + b.x),
                   swish((v.y - mean) * rstd * g.y + b.y), swish((v.z - mean) * rstd * g.z + b.z),
                   swish((v.w - mean) * rstd * g.w + b.w));
    }
  }
}

// rows a LayerNorm block takes: up to 8, as many as fit in shared memory
// (0: not one row of D fp32 sums fits)
int layer_rows(int D) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const int rows = optin / (D * 4);
  return rows < LN_MAX_ROWS ? rows : LN_MAX_ROWS;
}

// (2)-(4) from a bf16 x; norm_scale/norm_bias are the folded batch norm's,
// or the LayerNorm's affine when layer
int conv_module(const void* x, const void* w_in, const void* b_in, const void* dw,
                const void* b_dw, const void* norm_scale, const void* norm_bias,
                const void* w_out, const void* b_out, const void* lengths, void* glu, void* y,
                void* out, int B, int T, int D, int K, bool layer, cudaStream_t s) {
  const int M = B * T;
  int err = product<true>(static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
                          static_cast<const float*>(b_in), static_cast<const int*>(lengths), glu,
                          M, T, D, s);
  if (err != 0) return err;
  const float* h = static_cast<const float*>(glu);
  const float* taps = static_cast<const float*>(dw);
  const float* bias_dw = static_cast<const float*>(b_dw);
  const float* ns = static_cast<const float*>(norm_scale);
  const float* nb = static_cast<const float*>(norm_bias);
  if (layer) {
    const int rows = layer_rows(D);  // >= 1: shape_ok
    const int smem = rows * D * 4;
    const cudaError_t e = cudaFuncSetAttribute(depthwise_layer_norm_swish_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    depthwise_layer_norm_swish_kernel<<<B * ((T + rows - 1) / rows), LN_NT, smem, s>>>(
        h, taps, bias_dw, ns, nb, static_cast<bf16*>(y), B, T, D, K, rows);
  } else {
    const long long n = static_cast<long long>(B) * ((T + DW_ROWS - 1) / DW_ROWS) * (D / 4);
    depthwise_norm_swish_kernel<<<static_cast<unsigned>((n + DW_NT - 1) / DW_NT), DW_NT, 0, s>>>(
        h, taps, bias_dw, ns, nb, static_cast<bf16*>(y), B, T, D, K);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return product<false>(static_cast<const bf16*>(y), static_cast<const bf16*>(w_out),
                        static_cast<const float*>(b_out), nullptr, out, M, T, D, s);
}

// every entry checks its shape before it launches anything: D a multiple
// of 8 (the tensor maps' 16-byte rows) and, with the per-frame LayerNorm,
// one row of D fp32 sums within a block's shared memory
bool shape_ok(int B, int T, int D, int K, bool layer) {
  return B > 0 && T > 0 && K > 0 && D > 0 && D % 8 == 0 && (!layer || layer_rows(D) > 0);
}

// bf16(LN(x_raw)) into the xn scratch, then (2)-(4)
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

// The column tile of every GEMM from now on, this module's two products
// and ln_dense.cu's: 128 or 256, or 0 for the wave-cost choice (the
// default). For tests and timing; returns the previous setting.
extern "C" int rs_gemm_force_tile_n(int tile_n) {
  const int prev = rs::sm90::g_force_tile_n;
  if (tile_n == 0 || tile_n == 128 || tile_n == 256) rs::sm90::g_force_tile_n = tile_n;
  return prev;
}
