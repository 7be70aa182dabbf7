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
// stream, the q/k/v product 10.1 GFLOP: both compute-bound, ~14 and ~10 us
// at the H100 SXM's 989 TFLOP/s of dense bf16 (data sheet). The TPU kernel
// kept the normalized [BT, D] tile in VMEM beside a VMEM-resident W; on
// Hopper the product wants the tensor cores' full rate, which only wgmma
// fed by TMA reaches.
//
// Design: two launches. (1) ln_rows_kernel (tiles.cuh): one warp per row
// computes the statistics once and writes the normalized row as bf16 into
// a [M, D] scratch (3.3 MB at the serving shapes, which the 50 MB L2
// holds), after the residual add when there is one (the add's fp32 sum is
// written out there too); a TMA load needs the A operand in global memory
// anyway. (2) dense_kernel: gemm_sm90.cuh's persistent GEMM, TMA + wgmma
// with 128 x BN output tiles, one block per SM walking the tiles of every
// segment (a segment's tensor maps hold its own [D, Ni] weight and its
// [M, Ni] slice of the output, so a ragged Ni or M reads zeros past the
// edge and stores nothing there). Its epilogue adds the fp32 bias (staged
// in shared memory), applies swish, rounds once to bf16 and TMA-stores the
// tile at the segment's column offset. BN is 256 or 128, whichever needs
// fewer tile-columns of work in whole waves over the SMs (ceil(tiles /
// SMs) x BN): at the nemo FFN-in (M = 1,604, N = 4,096) both take 2 x 256
// and the wider tile wins the tie; at the q/k/v (N = 3 x 1,024) 156 tiles
// of 256 need two waves, 312 of 128 three of half the work, so 128. Both
// choices are the faster of the two on the H100 (chip_smoke.py times each
// forced). The normalization runs once per row, never once per output
// column tile. add_ln is launch (1) alone with an fp32 output and the
// length mask.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md §6, rows
// 4-5), device time with the LN pass: FFN-in 0.0352 ms (0.2366 on the
// earlier wmma tile), 1.68x the bare cuBLAS product on the same operands
// and 2.6x the bound; q/k/v with the residual add 0.0305 ms (0.1360), 1.87x
// cuBLAS. The epilogue still stops the tensor cores between tiles.

#include "gemm_sm90.cuh"
#include "tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using rs::sm90::Tile;

constexpr int MAX_SEG = 3;
constexpr int ALIGN = 8;  // D and every Ni: TMA reads rows of whole 16-byte units

struct Segments {
  const bf16* w[MAX_SEG];   // [D, n[i]] row-major bf16
  const float* c[MAX_SEG];  // [n[i]] fp32
  int n[MAX_SEG];           // columns, multiples of ALIGN; 0 past the last segment
};

// everything the GEMM launch needs, passed by value (the tensor maps must
// lie in the kernel's parameter space)
struct DenseParams {
  CUtensorMap a;             // xn [M, D]
  CUtensorMap b[MAX_SEG];    // w_i [D, n_i]
  CUtensorMap out[MAX_SEG];  // out[:, off_i : off_i + n_i] of [M, N]
  const float* c[MAX_SEG];
  int n[MAX_SEG], tiles[MAX_SEG];  // columns, column tiles
  int M, m_tiles, k_tiles, total;
};

template <int BN>
struct Schedule {  // tile t: row tile t % m_tiles, then the segments' column tiles in order
  const DenseParams& p;
  __device__ int tiles() const { return p.total; }
  __device__ Tile operator()(int t) const {
    int nt = t / p.m_tiles, b = 0;
    while (nt >= p.tiles[b]) nt -= p.tiles[b++];
    return Tile{(t % p.m_tiles) * rs::sm90::BM, b, nt * BN};
  }
};

// act(acc + c_b[col]) of segment b (past its width: no bias, and the store
// leaves the columns out). The swish takes the hardware exp2 and divide
// (__expf, __fdividef): their few-ulp fp32 error is far below the one bf16
// rounding that follows.
template <bool SWISH>
struct DenseEpilogue {
  static constexpr bool PAIRED = false;
  typedef bf16 Out;
  const DenseParams& p;
  __device__ int cols(const Tile& tile) const { return p.n[tile.b]; }
  __device__ float column(const Tile& tile, int i) const {
    const int col = tile.n0 + i;
    return col < p.n[tile.b] ? __ldg(p.c[tile.b] + col) : 0.0f;
  }
  __device__ float operator()(float v, float bias) const {
    v += bias;
    return SWISH ? __fdividef(v, 1.0f + __expf(-v)) : v;
  }
};

template <int BN, bool SWISH>
__global__ void __launch_bounds__(rs::sm90::NT, 1)
dense_kernel(const __grid_constant__ DenseParams p) {
  rs::sm90::gemm_persistent<BN>(&p.a, p.b, p.out, p.k_tiles, p.M, Schedule<BN>{p},
                                DenseEpilogue<SWISH>{p});
}

template <int BN, bool SWISH>
int launch_dense(DenseParams& p, int sms, cudaStream_t s) {
  constexpr int smem = rs::sm90::Config<BN>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<BN, SWISH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.total = 0;
  for (int i = 0; i < MAX_SEG; ++i) {
    p.tiles[i] = (p.n[i] + BN - 1) / BN;
    p.total += p.m_tiles * p.tiles[i];
  }
  dense_kernel<BN, SWISH><<<p.total < sms ? p.total : sms, rs::sm90::NT, smem, s>>>(p);
  RS_RETURN_LAST_ERROR();
}

// tile-columns of work in whole waves (rs::sm90::wave_cost) over every segment
int wave_cost(const DenseParams& p, int bn, int sms) {
  int tiles = 0;
  for (int i = 0; i < MAX_SEG; ++i) tiles += p.m_tiles * ((p.n[i] + bn - 1) / bn);
  return rs::sm90::wave_cost(tiles, bn, sms);
}

// launch (1) with or without the residual add, then launch (2) with a
// column tile by wave_cost (rs::sm90::pick_tile_n)
int ln_dense_impl(const float* x, const bf16* delta, float scale, const float* g, const float* b,
                  const Segments& seg, bf16* xn, float* stream_out, bf16* out, int M, int D,
                  int swish, float eps, cudaStream_t s) {
  int N = 0;
  for (int i = 0; i < MAX_SEG; ++i) {
    if (seg.n[i] < 0 || seg.n[i] % ALIGN != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (seg.n[i] > 0 && (i > 0 && seg.n[i - 1] == 0)) return static_cast<int>(cudaErrorInvalidValue);
    N += seg.n[i];
  }
  if (M <= 0 || D <= 0 || D % ALIGN != 0 || N == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_ln_rows<bf16, false>(x, delta, scale, g, b, stream_out, xn, nullptr, M, M, D,
                                        eps, s);
  if (err != 0) return err;

  DenseParams p = {};
  err = rs::sm90::encode_map(&p.a, xn, M, D, D, rs::sm90::BM);
  for (int i = 0, off = 0; i < MAX_SEG && err == 0; off += seg.n[i], ++i) {
    p.c[i] = seg.c[i];
    p.n[i] = seg.n[i];
    if (seg.n[i] == 0) continue;
    err = rs::sm90::encode_map(&p.b[i], seg.w[i], D, seg.n[i], seg.n[i], rs::sm90::BK);
    if (err == 0) err = rs::sm90::encode_map(&p.out[i], out + off, M, seg.n[i], N, 64);
  }
  if (err != 0) return err;
  p.M = M;
  p.m_tiles = (M + rs::sm90::BM - 1) / rs::sm90::BM;
  p.k_tiles = (D + rs::sm90::BK - 1) / rs::sm90::BK;
  const int sms = rs::sm90::sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const int bn = rs::sm90::pick_tile_n(wave_cost(p, 256, sms), wave_cost(p, 128, sms));
  if (bn == 256)
    return swish ? launch_dense<256, true>(p, sms, s) : launch_dense<256, false>(p, sms, s);
  return swish ? launch_dense<128, true>(p, sms, s) : launch_dense<128, false>(p, sms, s);
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
