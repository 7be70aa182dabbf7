// Relative-position multi-head attention, the four contracts of the TPU
// kernels on one kernel.
//
// Replaces: reazonspeech_tpu/ops/relpos_attention.py, Pallas TPU kernels:
// - relpos_attention_fused (:341) and relpos_attention_fused_packed (:402):
//   q, k, v are rows of row stride ld, [B, T, D] tensors of their own
//   (ld = D) or the column blocks 0, D and 2D of one packed [B, T, 3D]
//   projection (ld = 3D); the u/v biases are added to q here (the sums
//   rounded to bf16, the JAX kernel's chain); out [B, T, D] bf16;
// - relpos_attention (:76) and relpos_attention_blockwise (:199): separate
//   qu = q+u and qv = q+v (already summed and rounded by the caller), k, v
//   as [B, H, T, dh] (head stride T·dh, row stride dh); out [B, H, T, dh]
//   fp32.
// Contract, per head h (bf16 inputs):
//   scores = (qu·kᵀ + shift(qv·posᵀ)) / sqrt(dh), shift(x)[t,s] = x[t, T-1-t+s]
//   keys s >= length[b] score -1e30; fp32 softmax; out = p·v
// pos is [2T-1, H, dh] bf16 (offsets T-1 .. -(T-1)). Every query row t < T
// is computed (rows past the length too; the caller masks them later).
//
// Where the probabilities round to bf16 follows the TPU kernel each entry
// replaces. The fused, packed and blockwise contracts (:378, :430, :241)
// stream keys with an online softmax: here one sweep over 64-key tiles,
// unnormalised p rounded to bf16 for p·v, the accumulator rescaled per tile
// and divided by the row sum at the end. The single-pass contract (:112)
// holds a whole [BQ, T] score block and normalises the probabilities before
// their bf16 cast; Hopper has no room for a [64, T] fp32 block beside the
// tiles, so that entry sweeps the keys twice: the row max and sum first,
// then p = exp(s - m) / l rounded to bf16, times v (the scores are
// recomputed). None has a T cap; the caller's T <= 1024 dispatch between
// the last two is kept only to map the entries one to one.
//
// What bounds it on the H100: at the nemo bucket (B=4, T=401, D=1024, H=8,
// dh=128) a call moves ~13 MB (q, k, v, out, pos) and does ~4 GFLOP of
// products (q·kᵀ, the (q+v)·pos band, p·v): a few microseconds of either
// HBM or bf16 tensor-core time; at espnet's 20 s window (B·H=8, T=549,
// dh=64) ~0.5 GFLOP against ~3 MB. What bounds this version is the
// shared-memory round trips between its tensor-core products and its fp32
// softmax, and the grid: one block per 64 query rows and head, 72 blocks
// on 132 SMs at espnet's window.
//
// Design: one block per (query tile of 64 rows, head, batch item) loops
// over key tiles of 64, so no score leaves the SM. The TPU kernels'
// rel-shift was a strided lane rotate (pltpu.roll with stride=1), which has
// no Hopper counterpart. Here: for query rows t0..t0+63 and keys s0..s0+63
// the pos rows needed, l = T-1-t+s, form one contiguous band of 127 rows
// starting at T-1-(t0+63)+s0. Per key tile, 8 warps compute on the tensor
// cores (nvcuda::wmma, bf16 in, fp32 out) S = qu·kᵀ [64 x 64] and
// BD = qv·bandᵀ [64 x 128]; the softmax then reads BD skewed, score (r, c)
// = S[r][c] + BD[r][63-r+c]. Probabilities go to shared memory as bf16 for
// O += P·V on the tensor cores; O lives in shared memory in fp32 because a
// wmma accumulator's element layout is opaque and its rows must be
// rescaled by the running-max correction. Edges: rows past T read zeros and
// are not written; key columns past T are excluded (-inf); band rows
// outside [0, 2T-1) read zeros (they only meet excluded scores).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NBAND = 128;   // pos band rows staged per tile (127 used)
constexpr int NT = 256;      // 8 warps: 4 row blocks of 16 x 2 column halves
constexpr float MASK_SCORE = -1.0e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;  // rows as columns
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared-memory layout. Strides keep every wmma pointer 32-byte aligned
// (bf16 strides a multiple of 8, fp32 strides a multiple of 4).
template <int DH>
struct Layout {
  static constexpr int LD = DH + 8;      // bf16 q/k/v/band tiles
  static constexpr int LDS = BK + 4;     // fp32 S
  static constexpr int LDBD = NBAND + 4; // fp32 BD
  static constexpr int LDP = BK + 8;     // bf16 P
  static constexpr int LDO = DH + 4;     // fp32 O
  static constexpr size_t qu = 0;
  static constexpr size_t qv = qu + size_t(BQ) * LD * 2;
  static constexpr size_t k = qv + size_t(BQ) * LD * 2;
  static constexpr size_t v = k + size_t(BK) * LD * 2;
  static constexpr size_t band = v + size_t(BK) * LD * 2;
  static constexpr size_t s = band + size_t(NBAND) * LD * 2;
  static constexpr size_t bd = s + size_t(BQ) * LDS * 4;
  static constexpr size_t p = bd + size_t(BQ) * LDBD * 4;
  static constexpr size_t o = p + size_t(BQ) * LDP * 2;
  static constexpr size_t bytes = o + size_t(BQ) * LDO * 4;
};

// Where a tensor's rows lie: element (b, h, t, d) is at
// b·batch + h·head + t·row + d. [B, T, D] with row stride ld: (T·ld, dh,
// ld); [B, H, T, dh]: (H·T·dh, T·dh, dh).
struct Strides {
  size_t batch, head;
  int row;
};

struct Args {
  const bf16* qu;      // qu and qv may be the same q (the fused contracts)
  const bf16* qv;
  const bf16* k;
  const bf16* v;
  const bf16* pos;     // [2T-1, H, dh]
  const bf16* bias_u;  // [H, dh], added to qu; null: qu is already summed
  const bf16* bias_v;
  const int* lengths;  // [B]
  void* out;           // bf16 or fp32 (OutT)
  Strides in, o;       // q/k/v rows, out rows
  int T, H;
  float scale;
};

// Rows [row0, row0 + nrows) of a bf16 matrix (row stride row_stride, DH
// columns from src) into shared memory (stride LD), 8 elements per load;
// rows outside [0, nvalid) are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                          int nvalid, size_t row_stride) {
  constexpr int LD = Layout<DH>::LD;
  constexpr int VECS = DH / 8;
  for (int i = threadIdx.x; i < nrows * VECS; i += NT) {
    const int r = i / VECS, d = (i % VECS) * 8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < nvalid) val = *reinterpret_cast<const uint4*>(src + size_t(g) * row_stride + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

// The query tile's rows t0.. of src (row stride row_stride), plus bias when
// given (the sums rounded to bf16); rows past T are zero.
template <int DH>
__device__ __forceinline__ void load_query(bf16* dst, const bf16* src, const bf16* bias, int t0,
                                           int T, int row_stride) {
  if (bias == nullptr) {
    load_rows<DH>(dst, src, t0, BQ, T, row_stride);
    return;
  }
  constexpr int LD = Layout<DH>::LD;
  for (int i = threadIdx.x; i < BQ * (DH / 8); i += NT) {
    const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
    __align__(16) bf16 sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = __float2bfloat16(0.0f);
    if (t0 + r < T) {
      const uint4 x4 = *reinterpret_cast<const uint4*>(src + size_t(t0 + r) * row_stride + d);
      const uint4 b4 = *reinterpret_cast<const uint4*>(bias + d);
      const bf16* x = reinterpret_cast<const bf16*>(&x4);
      const bf16* u = reinterpret_cast<const bf16*>(&b4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sum[e] = __float2bfloat16(__bfloat162float(x[e]) + __bfloat162float(u[e]));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + d) = *reinterpret_cast<const uint4*>(sum);
  }
}

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int DH, bool TWO_PASS, typename OutT>
__global__ void __launch_bounds__(NT) relpos_attention_kernel(const Args a) {
  using L = Layout<DH>;
  constexpr int LD = L::LD;
  constexpr int NCOL = DH / 16;           // 16-wide column blocks of O
  constexpr int NPER = (NCOL + 1) / 2;    // per column half
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_qu = reinterpret_cast<bf16*>(smem + L::qu);
  bf16* s_qv = reinterpret_cast<bf16*>(smem + L::qv);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L::k);
  bf16* s_v = reinterpret_cast<bf16*>(smem + L::v);
  bf16* s_band = reinterpret_cast<bf16*>(smem + L::band);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* s_bd = reinterpret_cast<float*>(smem + L::bd);
  bf16* s_p = reinterpret_cast<bf16*>(smem + L::p);
  float* s_o = reinterpret_cast<float*>(smem + L::o);

  const int tid = threadIdx.x;
  const int wi = tid / 64, wj = (tid / 32) % 2;  // warp: row block wi, column half wj
  const int t0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = a.T;
  const int len = a.lengths[b];
  const size_t base = size_t(b) * a.in.batch + size_t(h) * a.in.head;  // this (b, h)'s rows
  const bf16* kb = a.k + base;
  const bf16* vb = a.v + base;
  const bf16* posh = a.pos + h * DH;  // table row l of head h at posh + l·H·DH

  load_query<DH>(s_qu, a.qu + base, a.bias_u ? a.bias_u + h * DH : nullptr, t0, T, a.in.row);
  load_query<DH>(s_qv, a.qv + base, a.bias_v ? a.bias_v + h * DH : nullptr, t0, T, a.in.row);
  for (int i = tid; i < BQ * L::LDO; i += NT) s_o[i] = 0.0f;

  const int r = tid / 4, quarter = tid % 4;  // softmax: row r, columns quarter + 4j

  // Stage the key tile at s0 (its values too when with_v) and its pos band,
  // then S = qu·kᵀ and BD = qv·bandᵀ into shared memory.
  auto score_tile = [&](int s0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<DH>(s_k, kb, s0, BK, T, a.in.row);
    if (with_v) load_rows<DH>(s_v, vb, s0, BK, T, a.in.row);
    load_rows<DH>(s_band, posh, T - 1 - (t0 + BQ - 1) + s0, NBAND, 2 * T - 1,
                  size_t(a.H) * DH);
    __syncthreads();
    {  // S: this warp's 16 rows x 32 keys
      FragC acc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, s_qu + wi * 16 * LD + d0, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBt kt;
          wmma::load_matrix_sync(kt, s_k + (wj * 32 + j * 16) * LD + d0, LD);
          wmma::mma_sync(acc[j], fa, kt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(s_s + wi * 16 * L::LDS + wj * 32 + j * 16, acc[j], L::LDS,
                                wmma::mem_row_major);
    }
    {  // BD: this warp's 16 rows x 64 band rows
      FragC acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, s_qv + wi * 16 * LD + d0, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBt pt;
          wmma::load_matrix_sync(pt, s_band + (wj * 64 + j * 16) * LD + d0, LD);
          wmma::mma_sync(acc[j], fa, pt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(s_bd + wi * 16 * L::LDBD + wj * 64 + j * 16, acc[j], L::LDBD,
                                wmma::mem_row_major);
    }
    __syncthreads();
  };

  // This thread's 16 scores of row r (columns quarter + 4j) in the tile at
  // s0, and their max over the row (its 4 threads).
  auto row_scores = [&](int s0, float (&vals)[BK / 4]) {
    float mx = rs::neg_inf();
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = quarter + 4 * j, s = s0 + c;
      float val = (s_s[r * L::LDS + c] + s_bd[r * L::LDBD + (BQ - 1 - r + c)]) * a.scale;
      if (s >= T) val = rs::neg_inf();
      else if (s >= len) val = MASK_SCORE;
      vals[j] = val;
      mx = fmaxf(mx, val);
    }
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
    for (int s0 = 0; s0 < T; s0 += BK) {
      score_tile(s0, false);
      const float m_new = fmaxf(m_run, row_scores(s0, vals));  // finite: key s0 < T is scored
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) sum += expf(vals[j] - m_new);
      l_run = l_run * expf(m_run - m_new) + quad_sum(sum);
      m_run = m_new;
    }
  }

  for (int s0 = 0; s0 < T; s0 += BK) {
    score_tile(s0, true);
    const float mx = row_scores(s0, vals);
    if (TWO_PASS) {  // probabilities normalised, then rounded to bf16
      const float inv = 1.0f / l_run;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        s_p[r * L::LDP + quarter + 4 * j] = __float2bfloat16(expf(vals[j] - m_run) * inv);
    } else {  // online softmax: unnormalised p, rescaled accumulator
      const float m_new = fmaxf(m_run, mx);
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
      for (int d = quarter; d < DH; d += 4) s_o[r * L::LDO + d] *= alpha;
    }
    __syncthreads();

    // O += P·V: this warp's 16 rows x its column blocks of dh
#pragma unroll
    for (int cb = 0; cb < NPER; ++cb) {
      const int c0 = (wj * NPER + cb) * 16;
      if (c0 >= DH) break;
      FragC o;
      wmma::load_matrix_sync(o, s_o + wi * 16 * L::LDO + c0, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        FragA pa;
        FragB vf;
        wmma::load_matrix_sync(pa, s_p + wi * 16 * L::LDP + k0, L::LDP);
        wmma::load_matrix_sync(vf, s_v + k0 * LD + c0, LD);
        wmma::mma_sync(o, pa, vf, o);
      }
      wmma::store_matrix_sync(s_o + wi * 16 * L::LDO + c0, o, L::LDO, wmma::mem_row_major);
    }
  }

  __syncthreads();
  const int t = t0 + r;
  if (t < T) {
    const float inv = TWO_PASS ? 1.0f : 1.0f / l_run;
    OutT* orow = static_cast<OutT*>(a.out) + size_t(b) * a.o.batch + size_t(h) * a.o.head +
                 size_t(t) * a.o.row;
    for (int d = quarter; d < DH; d += 4) store(orow + d, s_o[r * L::LDO + d] * inv);
  }
}

template <int DH, bool TWO_PASS, typename OutT>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(relpos_attention_kernel<DH, TWO_PASS, OutT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, B);
  relpos_attention_kernel<DH, TWO_PASS, OutT><<<grid, NT, smem, stream>>>(a);
  RS_RETURN_LAST_ERROR();
}

template <bool TWO_PASS, typename OutT>
int launch_any(Args a, int B, int dh, void* stream) {
  if (B <= 0 || B > 65535 || a.T <= 0 || a.H <= 0 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16, TWO_PASS, OutT>(a, B, s);
    case 32: return launch<32, TWO_PASS, OutT>(a, B, s);
    case 64: return launch<64, TWO_PASS, OutT>(a, B, s);
    case 128: return launch<128, TWO_PASS, OutT>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fused contracts: q, k, v rows of stride ld in [B, T, *], biases added
// here, out [B, T, H·dh] bf16.
int launch_fused(const void* q, const void* k, const void* v, const void* pos, const void* bu,
                 const void* bv, const void* lengths, void* out, int B, int T, int H, int dh,
                 int ld, void* stream) {
  Args a;
  a.qu = a.qv = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = static_cast<const bf16*>(pos);
  a.bias_u = static_cast<const bf16*>(bu);
  a.bias_v = static_cast<const bf16*>(bv);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.in = Strides{size_t(T) * ld, size_t(dh), ld};
  a.o = Strides{size_t(T) * H * dh, size_t(dh), H * dh};
  a.T = T;
  a.H = H;
  return launch_any<false, bf16>(a, B, dh, stream);
}

// The [B, H, T, dh] contracts: qu, qv, k, v summed by the caller, out fp32.
template <bool TWO_PASS>
int launch_bhtd(const void* qu, const void* qv, const void* k, const void* v, const void* pos,
                const void* lengths, void* out, int B, int T, int H, int dh, void* stream) {
  Args a;
  a.qu = static_cast<const bf16*>(qu);
  a.qv = static_cast<const bf16*>(qv);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = static_cast<const bf16*>(pos);
  a.bias_u = a.bias_v = nullptr;
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.in = a.o = Strides{size_t(H) * T * dh, size_t(T) * dh, dh};
  a.T = T;
  a.H = H;
  return launch_any<TWO_PASS, float>(a, B, dh, stream);
}

}  // namespace

// q, k, v [B, T, H·dh] bf16 each
extern "C" int rs_relpos_attention_fused(const void* q, const void* k, const void* v,
                                         const void* pos, const void* bias_u,
                                         const void* bias_v, const void* lengths, void* out,
                                         int B, int T, int H, int dh, void* stream) {
  return launch_fused(q, k, v, pos, bias_u, bias_v, lengths, out, B, T, H, dh, H * dh, stream);
}

// qkv [B, T, 3·H·dh] bf16: q, k, v are its column blocks 0, D and 2D
extern "C" int rs_relpos_attention_fused_packed(const void* qkv, const void* pos,
                                                const void* bias_u, const void* bias_v,
                                                const void* lengths, void* out, int B, int T,
                                                int H, int dh, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int d = H * dh;
  return launch_fused(q, q + d, q + 2 * d, pos, bias_u, bias_v, lengths, out, B, T, H, dh,
                      3 * d, stream);
}

// single-pass contract: qu, qv, k, v [B, H, T, dh] bf16, out fp32;
// probabilities normalised before the bf16 cast (two key sweeps)
extern "C" int rs_relpos_attention(const void* qu, const void* qv, const void* k, const void* v,
                                   const void* pos, const void* lengths, void* out, int B, int T,
                                   int H, int dh, void* stream) {
  return launch_bhtd<true>(qu, qv, k, v, pos, lengths, out, B, T, H, dh, stream);
}

// streamed contract: the same inputs, online softmax over 64-key tiles
extern "C" int rs_relpos_attention_blockwise(const void* qu, const void* qv, const void* k,
                                             const void* v, const void* pos, const void* lengths,
                                             void* out, int B, int T, int H, int dh,
                                             void* stream) {
  return launch_bhtd<false>(qu, qv, k, v, pos, lengths, out, B, T, H, dh, stream);
}
