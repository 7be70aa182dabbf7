// Zipformer shared-weights attention: one application of the layer's
// softmax weights to one value set.
//
// Replaces: reazonspeech_tpu/ops/zipformer_attention.py,
// shared_rel_attention (:69, pallas_call :100) and
// shared_rel_attention_blockwise (:174, pallas_call :204), Pallas TPU
// kernels, with one kernel source and two C entries. Contract, per row g of
// G (B·H per-head applications, or B for the single-head nonlin one):
//   s[t, s'] = (q[t]·k[s'] + qp[t]·pos[g % heads][T-1-t+s']) / sqrt(qd)
//   keys s' >= length[g] score -1e30; fp32 softmax over s'; out = p·v (fp32)
// q, k [G, T, qd], qp [G, T, pd], pos [heads, 2T-1, pd], v [G, T, dv] bf16;
// out [G, T, dv] fp32. Every query row t < T is computed; rows past the
// length are garbage (finite) and the caller masks them.
//
// The two entries differ where they round, as the TPU kernels do:
// - rs_shared_rel_attention (single pass on the TPU, the whole key range in
//   VMEM): probabilities normalised in fp32, cast to bf16, then ·v. Hopper
//   has no room for a [64, T] fp32 score block at T = 2048 beside the value
//   tiles, so this entry sweeps the keys twice: the first sweep keeps only
//   the running row max and sum, the second forms p = exp(s - m) / l, casts
//   it to bf16 and accumulates p·v. Scores are recomputed, which is cheap
//   (qd = 32, pd = 4).
// - rs_shared_rel_attention_blockwise (streamed KV on the TPU): one sweep
//   with an online softmax over 64-key tiles: running max and sum in fp32,
//   unnormalised p cast to bf16 for p·v, the accumulator rescaled per tile
//   and divided by the sum at the end.
// Neither has a T cap, so the model's T <= 2048 dispatch between them is
// kept only to map the entries one to one.
//
// What bounds it on the H100: at the k2 main path's stack-0 shape (G = 16,
// T = 1596, qd = 32, pd = 4, dv = 12) one application does ~3.9 GFLOP of
// T² products (q·kᵀ, the position term, p·v) against ~5 MB of q/k/qp/v/out:
// ~4 µs of bf16 tensor-core time against ~1.6 µs of HBM time, so the bound
// is the operations; the nonlin application (G = 4, dv = 144 .. 576) does
// more p·v work per byte still. What bounds this version is latency: per
// key tile, four block-wide barriers between the tensor-core products (S =
// q·kᵀ and O += P·V through nvcuda::wmma, bf16 in, fp32 out) and the
// softmax on the CUDA cores, and the score and output tiles round-tripping
// through shared memory.
//
// Design: one block of 8 warps per (64 query rows, row g, chunk of value
// columns). The position term has pd = 4, so it is 4 FMAs per score on the
// CUDA cores: the TPU's strided lane rotate (pltpu.roll with stride=1) is
// not needed. For query rows t0..t0+63 and keys s0..s0+63 the table rows
// T-1-t+s form one band of 127 rows starting at T-1-(t0+63)+s0; the band is
// staged in shared memory (fp32, transposed so that the 32 lanes of a warp
// read 32 banks) and score (r, c) reads band row 63-r+c. Each thread owns
// one query row's quarter for the softmax and keeps that row's qp in
// registers. dv = 12 is zero-padded to one 16-column tensor-core tile; wider
// value sets (the nonlin attention's 3/4·D) go in chunks of 192 columns, one
// chunk per block (grid z), each chunk recomputing the scores. qd (8 to
// 32, a multiple of 8) is zero-padded to 32 columns. The output accumulator lives in shared
// memory in fp32, because a wmma accumulator's element layout is opaque and
// the streamed entry rescales its rows. Edges: query rows past T read zeros
// and are not written; keys past T are excluded (-inf), keys in
// [length, T) score -1e30; key tiles wholly past the length are skipped
// (their probabilities are exactly 0), except when the length is 0, where
// every key scores -1e30 as in the JAX kernel.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // 8 warps: 4 row blocks of 16 x 2 column halves
constexpr int NBAND = 128;  // position band rows staged per tile (127 used)
constexpr int PDMAX = 8;    // largest position-query width
constexpr float MASK_SCORE = -1.0e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;  // rows as columns
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout for qd padded to QDP and NCB 16-column blocks of
// values. Strides keep every wmma pointer 32-byte aligned (bf16 strides a
// multiple of 8, fp32 strides a multiple of 4).
template <int QDP, int NCB>
struct Layout {
  static constexpr int DVC = 16 * NCB;  // value columns per block
  static constexpr int LDQ = QDP + 8;   // bf16 q and k tiles
  static constexpr int LDS = BK + 4;    // fp32 S
  static constexpr int LDP = BK + 8;    // bf16 P
  static constexpr int LDV = DVC + 8;   // bf16 V
  static constexpr int LDO = DVC + 4;   // fp32 O
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(size_t(BQ) * LDQ * 2);
  static constexpr size_t band = k + align128(size_t(BK) * LDQ * 2);
  static constexpr size_t s = band + align128(size_t(PDMAX) * NBAND * 4);
  static constexpr size_t p = s + align128(size_t(BQ) * LDS * 4);
  static constexpr size_t v = p + align128(size_t(BQ) * LDP * 2);
  static constexpr size_t o = v + align128(size_t(BK) * LDV * 2);
  static constexpr size_t bytes = o + align128(size_t(BQ) * LDO * 4);
};

// Rows [row0, row0 + 64) of a [T, qd] bf16 matrix into shared memory
// (stride QDP + 8), 8 elements per load; rows past T and columns past qd
// are zero. qd is a multiple of 8.
template <int QDP>
__device__ __forceinline__ void load_qk(bf16* dst, const bf16* src, int row0, int T, int qd) {
  constexpr int LD = QDP + 8;
  constexpr int VECS = QDP / 8;
  for (int i = threadIdx.x; i < 64 * VECS; i += NT) {
    const int r = i / VECS, d = (i % VECS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < T && d < qd) val = *reinterpret_cast<const uint4*>(src + size_t(row) * qd + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

template <int QDP, int NCB, bool TWO_PASS>
__global__ void __launch_bounds__(NT)
shared_rel_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ qp, const bf16* __restrict__ pos,
                            const bf16* __restrict__ v, const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int qd, int pd, int dv, int heads,
                            float scale) {
  using L = Layout<QDP, NCB>;
  constexpr int DVC = L::DVC;
  constexpr int NPER = (NCB + 1) / 2;  // O column blocks per column half
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem + L::q);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L::k);
  float* s_band = reinterpret_cast<float*>(smem + L::band);  // [PDMAX][NBAND]
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  bf16* s_p = reinterpret_cast<bf16*>(smem + L::p);
  bf16* s_v = reinterpret_cast<bf16*>(smem + L::v);
  float* s_o = reinterpret_cast<float*>(smem + L::o);

  const int tid = threadIdx.x;
  const int wi = tid / 64, wj = (tid / 32) % 2;  // warp: row block wi, column half wj
  const int r = tid / 4, quarter = tid % 4;      // softmax: row r, columns quarter + 4j
  const int t0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int c0 = blockIdx.z * DVC;  // first value column of this block
  const int len = lengths[g];
  const int kend = len > 0 ? min(len, T) : T;  // keys past kend have p == 0
  const size_t gT = size_t(g) * T;
  const bf16* kg = k + gT * qd;
  const bf16* vg = v + gT * dv;
  const bf16* posg = pos + size_t(g % heads) * (2 * T - 1) * pd;

  load_qk<QDP>(s_q, q + gT * qd, t0, T, qd);
  float qpr[PDMAX];  // this thread's query row of qp (fp32; zero past T and pd)
#pragma unroll
  for (int d = 0; d < PDMAX; ++d)
    qpr[d] = (t0 + r < T && d < pd) ? __bfloat162float(qp[(gT + t0 + r) * pd + d]) : 0.0f;

  // Stage the key tile at s0 and its position band (and the value chunk).
  auto stage = [&](int s0, bool with_v) {
    load_qk<QDP>(s_k, kg, s0, T, qd);
    const int b0 = T - BQ - t0 + s0;  // table row of band row 0: T-1-(t0+63)+s0
    for (int i = tid; i < NBAND * pd; i += NT) {
      const int row = i / pd, d = i % pd, l = b0 + row;
      s_band[d * NBAND + row] =
          (l >= 0 && l < 2 * T - 1) ? __bfloat162float(posg[size_t(l) * pd + d]) : 0.0f;
    }
    if (with_v) {
      for (int i = tid; i < BK * DVC; i += NT) {
        const int row = i / DVC, c = i % DVC;
        const int key = s0 + row, col = c0 + c;
        s_v[row * L::LDV + c] =
            (key < T && col < dv) ? vg[size_t(key) * dv + col] : __float2bfloat16(0.0f);
      }
    }
  };

  // S = q·kᵀ for the staged tile: this warp's 16 rows x 32 keys.
  auto qk_tile = [&]() {
    FragC acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int d0 = 0; d0 < QDP; d0 += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s_q + wi * 16 * L::LDQ + d0, L::LDQ);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBt kt;
        wmma::load_matrix_sync(kt, s_k + (wj * 32 + j * 16) * L::LDQ + d0, L::LDQ);
        wmma::mma_sync(acc[j], a, kt, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_s + wi * 16 * L::LDS + wj * 32 + j * 16, acc[j], L::LDS,
                              wmma::mem_row_major);
  };

  // This thread's 16 scores of row r (columns quarter + 4j) in the tile at s0.
  auto row_scores = [&](int s0, float (&vals)[BK / 4]) {
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = quarter + 4 * j, key = s0 + c;
      const float* band = s_band + (BQ - 1 - r + c);
      float bd = 0.0f;
#pragma unroll
      for (int d = 0; d < PDMAX; ++d)
        if (d < pd) bd += qpr[d] * band[d * NBAND];
      float val = (s_s[r * L::LDS + c] + bd) * scale;
      if (key >= T) val = rs::neg_inf();
      else if (key >= len) val = MASK_SCORE;
      vals[j] = val;
    }
  };

  auto row_max = [&](const float (&vals)[BK / 4]) {
    float mx = rs::neg_inf();
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, vals[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  };
  auto quad_sum = [](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };

  float m_run = rs::neg_inf(), l_run = 0.0f;
  float vals[BK / 4];

  if (TWO_PASS) {  // sweep 1: the rows' max and sum
    for (int s0 = 0; s0 < kend; s0 += BK) {
      __syncthreads();  // the previous tile's readers are done
      stage(s0, false);
      __syncthreads();
      qk_tile();
      __syncthreads();
      row_scores(s0, vals);
      const float m_new = fmaxf(m_run, row_max(vals));  // finite: key s0 is scored
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) sum += expf(vals[j] - m_new);
      l_run = l_run * expf(m_run - m_new) + quad_sum(sum);
      m_run = m_new;
    }
  }

  for (int i = tid; i < BQ * L::LDO; i += NT) s_o[i] = 0.0f;

  for (int s0 = 0; s0 < kend; s0 += BK) {
    __syncthreads();
    stage(s0, true);
    __syncthreads();
    qk_tile();
    __syncthreads();
    row_scores(s0, vals);
    if (TWO_PASS) {  // probabilities normalised, then rounded to bf16
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        s_p[r * L::LDP + quarter + 4 * j] = __float2bfloat16(expf(vals[j] - m_run) / l_run);
    } else {  // online softmax: unnormalised p, rescaled accumulator
      const float m_new = fmaxf(m_run, row_max(vals));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p = expf(vals[j] - m_new);
        s_p[r * L::LDP + quarter + 4 * j] = __float2bfloat16(p);
        sum += p;
      }
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + quad_sum(sum);
      m_run = m_new;
      for (int d = quarter; d < DVC; d += 4) s_o[r * L::LDO + d] *= alpha;
    }
    __syncthreads();

    // O += P·V: this warp's 16 rows x its column blocks of the chunk
#pragma unroll
    for (int cb = 0; cb < NPER; ++cb) {
      const int col = (wj * NPER + cb) * 16;
      if (col >= DVC) break;
      FragC o;
      wmma::load_matrix_sync(o, s_o + wi * 16 * L::LDO + col, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, s_p + wi * 16 * L::LDP + k0, L::LDP);
        wmma::load_matrix_sync(vb, s_v + k0 * L::LDV + col, L::LDV);
        wmma::mma_sync(o, pa, vb, o);
      }
      wmma::store_matrix_sync(s_o + wi * 16 * L::LDO + col, o, L::LDO, wmma::mem_row_major);
    }
  }

  __syncthreads();
  const int t = t0 + r;
  if (t < T) {
    float* orow = out + (gT + t) * dv;
    for (int d = quarter; d < DVC && c0 + d < dv; d += 4) {
      const float o = s_o[r * L::LDO + d];
      orow[c0 + d] = TWO_PASS ? o : o / l_run;
    }
  }
}

template <int QDP, int NCB, bool TWO_PASS>
int launch(const void* q, const void* k, const void* qp, const void* pos, const void* v,
           const void* lengths, void* out, int G, int T, int qd, int pd, int dv, int heads,
           float scale, cudaStream_t stream) {
  using L = Layout<QDP, NCB>;
  const cudaError_t err = cudaFuncSetAttribute(shared_rel_attention_kernel<QDP, NCB, TWO_PASS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, G, (dv + L::DVC - 1) / L::DVC);
  shared_rel_attention_kernel<QDP, NCB, TWO_PASS><<<grid, NT, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(pos), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, qd, pd, dv, heads, scale);
  RS_RETURN_LAST_ERROR();
}

template <bool TWO_PASS>
int launch_any(const void* q, const void* k, const void* qp, const void* pos, const void* v,
               const void* lengths, void* out, int G, int T, int qd, int pd, int dv, int heads,
               float scale, void* stream) {
  if (G <= 0 || G > 65535 || T <= 0 || heads <= 0 || qd <= 0 || qd > 32 || qd % 8 ||
      pd <= 0 || pd > PDMAX || dv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dv <= 16: one 16-column tile (the per-head applications, dv = 12);
  // wider: chunks of 192 columns (the nonlin attention's 144 .. 576)
  if (dv <= 16)
    return launch<32, 1, TWO_PASS>(q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads,
                                   scale, s);
  return launch<32, 12, TWO_PASS>(q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads,
                                  scale, s);
}

}  // namespace

// single-pass contract: probabilities normalised before the bf16 cast
extern "C" int rs_shared_rel_attention(const void* q, const void* k, const void* qp,
                                       const void* pos, const void* v, const void* lengths,
                                       void* out, int G, int T, int qd, int pd, int dv,
                                       int heads, float scale, void* stream) {
  return launch_any<true>(q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads, scale,
                          stream);
}

// streamed contract: online softmax over 64-key tiles, division at the end
extern "C" int rs_shared_rel_attention_blockwise(const void* q, const void* k, const void* qp,
                                                 const void* pos, const void* v,
                                                 const void* lengths, void* out, int G, int T,
                                                 int qd, int pd, int dv, int heads, float scale,
                                                 void* stream) {
  return launch_any<false>(q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads, scale,
                           stream);
}
