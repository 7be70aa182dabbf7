// Relative-position multi-head attention on projection-layout tensors.
//
// Replaces: reazonspeech_tpu/ops/relpos_attention.py, relpos_attention_fused
// (:341) and relpos_attention_fused_packed (:402), Pallas TPU kernels, with
// one kernel and two C entries: q, k, v are rows of row stride ld, [B, T, D]
// tensors of their own (ld = D) or the column blocks 0, D and 2D of one
// packed [B, T, 3D] projection (ld = 3D). Contract, per head h (bf16):
//   scores = ((q+u)·kᵀ + shift((q+v)·posᵀ)) / sqrt(dh), shift(x)[t,s] = x[t, T-1-t+s]
//   keys s >= length[b] score -1e30; fp32 softmax; out = p·v -> bf16 [B, T, D]
// Every query row t < T is computed (the packed kernel's query rows past
// the length too; the caller masks them later).
// pos is [2T-1, H, dh] bf16 (offsets T-1 .. -(T-1)); u, v are [H, dh] bf16.
//
// What bounds it on the H100: at the slice's shapes (B=4, T=376, D=1024,
// H=8, dh=128) a call moves ~11 MB (q, k, v, out, pos) and does ~3.6 GFLOP
// of products (q·kᵀ, the (q+v)·pos band, p·v): a few microseconds of either
// HBM or bf16 tensor-core time. What bounds this version is the shared-memory
// round trips between its tensor-core products and its fp32 softmax, and the
// grid: 192 blocks of ~195 KB of shared memory, one block per SM.
//
// Design: one block per (query tile of 64 rows, head, batch item) loops over
// key tiles of 64 with an online softmax (running max, running sum, fp32
// accumulator), so there is no T cap and no score leaves the SM. The TPU
// kernel's rel-shift was a strided lane rotate (pltpu.roll with stride=1),
// which has no Hopper counterpart. Here: for query rows t0..t0+63 and keys
// s0..s0+63 the pos rows needed, l = T-1-t+s, form one contiguous band of
// 127 rows starting at T-1-(t0+63)+s0. Per key tile, 8 warps compute on the
// tensor cores (nvcuda::wmma, bf16 in, fp32 out) S = (q+u)·kᵀ [64 x 64] and
// BD = (q+v)·bandᵀ [64 x 128]; the softmax then reads BD skewed, score
// (r, c) = S[r][c] + BD[r][63-r+c]. Probabilities go to shared memory as
// bf16 (the JAX kernel also multiplies v by bf16 probabilities) for
// O += P·V on the tensor cores; O lives in shared memory in fp32 because a
// wmma accumulator's element layout is opaque and its rows must be rescaled
// by the running-max correction. The u/v biases are added to q as the tile
// loads, rounded to bf16 as in the JAX kernel. Edges: rows past T read zeros
// and are not written; key columns past T are excluded (-inf); band rows
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

// Rows [row0, row0 + nrows) of a [*, row_stride] bf16 matrix, columns
// col0 .. col0+DH, into shared memory (stride LD), 8 elements per load;
// rows outside [0, nvalid) are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                          int nvalid, size_t row_stride, int col0) {
  constexpr int LD = Layout<DH>::LD;
  constexpr int VECS = DH / 8;
  for (int i = threadIdx.x; i < nrows * VECS; i += NT) {
    const int r = i / VECS, d = (i % VECS) * 8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < nvalid)
      val = *reinterpret_cast<const uint4*>(src + size_t(g) * row_stride + col0 + d);
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
relpos_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ pos,
                        const bf16* __restrict__ bias_u, const bf16* __restrict__ bias_v,
                        const int* __restrict__ lengths, bf16* __restrict__ out, int T, int H,
                        int ld, float scale) {
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
  const int D = H * DH;
  const int len = lengths[b];
  const size_t batch = size_t(b) * T * ld;  // q, k, v row stride ld, out row stride D
  const bf16* qb = q + batch;

  // q tile with the biases added (bf16-rounded sums, the JAX kernel's chain)
  for (int i = tid; i < BQ * (DH / 8); i += NT) {
    const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
    const int t = t0 + r;
    __align__(16) bf16 qu[8];
    __align__(16) bf16 qv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) qu[e] = qv[e] = __float2bfloat16(0.0f);
    if (t < T) {
      const uint4 x4 = *reinterpret_cast<const uint4*>(qb + size_t(t) * ld + h * DH + d);
      const uint4 u4 = *reinterpret_cast<const uint4*>(bias_u + h * DH + d);
      const uint4 w4 = *reinterpret_cast<const uint4*>(bias_v + h * DH + d);
      const bf16* x = reinterpret_cast<const bf16*>(&x4);
      const bf16* u = reinterpret_cast<const bf16*>(&u4);
      const bf16* w = reinterpret_cast<const bf16*>(&w4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qu[e] = __float2bfloat16(__bfloat162float(x[e]) + __bfloat162float(u[e]));
        qv[e] = __float2bfloat16(__bfloat162float(x[e]) + __bfloat162float(w[e]));
      }
    }
    *reinterpret_cast<uint4*>(s_qu + r * LD + d) = *reinterpret_cast<const uint4*>(qu);
    *reinterpret_cast<uint4*>(s_qv + r * LD + d) = *reinterpret_cast<const uint4*>(qv);
  }
  for (int i = tid; i < BQ * L::LDO; i += NT) s_o[i] = 0.0f;

  const int r = tid / 4, quarter = tid % 4;  // softmax: row r, columns quarter + 4j
  float m_run = rs::neg_inf(), l_run = 0.0f;

  for (int s0 = 0; s0 < T; s0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<DH>(s_k, k + batch, s0, BK, T, ld, h * DH);
    load_rows<DH>(s_v, v + batch, s0, BK, T, ld, h * DH);
    load_rows<DH>(s_band, pos, T - 1 - (t0 + BQ - 1) + s0, NBAND, 2 * T - 1, D, h * DH);
    __syncthreads();

    {  // S = (q+u)·kᵀ: this warp's 16 rows x 32 keys
      FragC acc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, s_qu + wi * 16 * LD + d0, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBt kt;
          wmma::load_matrix_sync(kt, s_k + (wj * 32 + j * 16) * LD + d0, LD);
          wmma::mma_sync(acc[j], a, kt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(s_s + wi * 16 * L::LDS + wj * 32 + j * 16, acc[j], L::LDS,
                                wmma::mem_row_major);
    }
    {  // BD = (q+v)·bandᵀ: this warp's 16 rows x 64 band rows
      FragC acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, s_qv + wi * 16 * LD + d0, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBt pt;
          wmma::load_matrix_sync(pt, s_band + (wj * 64 + j * 16) * LD + d0, LD);
          wmma::mma_sync(acc[j], a, pt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(s_bd + wi * 16 * L::LDBD + wj * 64 + j * 16, acc[j], L::LDBD,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax for row r over this tile; 4 threads per row
    float vals[BK / 4];
    float mx = rs::neg_inf();
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = quarter + 4 * j, s = s0 + c;
      float val = (s_s[r * L::LDS + c] + s_bd[r * L::LDBD + (BQ - 1 - r + c)]) * scale;
      if (s >= T) val = rs::neg_inf();
      else if (s >= len) val = MASK_SCORE;
      vals[j] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);  // finite: key s0 < T is in every tile
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = expf(vals[j] - m_new);
      s_p[r * L::LDP + quarter + 4 * j] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    for (int d = quarter; d < DH; d += 4) s_o[r * L::LDO + d] *= alpha;
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
        FragB vb;
        wmma::load_matrix_sync(pa, s_p + wi * 16 * L::LDP + k0, L::LDP);
        wmma::load_matrix_sync(vb, s_v + k0 * LD + c0, LD);
        wmma::mma_sync(o, pa, vb, o);
      }
      wmma::store_matrix_sync(s_o + wi * 16 * L::LDO + c0, o, L::LDO, wmma::mem_row_major);
    }
  }

  __syncthreads();
  const int t = t0 + r;
  if (t < T) {
    const float inv = 1.0f / l_run;
    bf16* orow = out + (size_t(b) * T + t) * D + h * DH;
    for (int d = quarter; d < DH; d += 4) orow[d] = __float2bfloat16(s_o[r * L::LDO + d] * inv);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* bu,
           const void* bv, const void* lengths, void* out, int B, int T, int H, int ld,
           cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(relpos_attention_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  relpos_attention_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(pos), static_cast<const bf16*>(bu), static_cast<const bf16*>(bv),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), T, H, ld,
      1.0f / sqrtf(static_cast<float>(DH)));
  RS_RETURN_LAST_ERROR();
}

int launch_any(const void* q, const void* k, const void* v, const void* pos, const void* bu,
               const void* bv, const void* lengths, void* out, int B, int T, int H, int dh,
               int ld, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, pos, bu, bv, lengths, out, B, T, H, ld, s);
    case 32: return launch<32>(q, k, v, pos, bu, bv, lengths, out, B, T, H, ld, s);
    case 64: return launch<64>(q, k, v, pos, bu, bv, lengths, out, B, T, H, ld, s);
    case 128: return launch<128>(q, k, v, pos, bu, bv, lengths, out, B, T, H, ld, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v [B, T, H·dh] bf16 each
extern "C" int rs_relpos_attention_fused(const void* q, const void* k, const void* v,
                                         const void* pos, const void* bias_u,
                                         const void* bias_v, const void* lengths, void* out,
                                         int B, int T, int H, int dh, void* stream) {
  return launch_any(q, k, v, pos, bias_u, bias_v, lengths, out, B, T, H, dh, H * dh, stream);
}

// qkv [B, T, 3·H·dh] bf16: q, k, v are its column blocks 0, D and 2D
extern "C" int rs_relpos_attention_fused_packed(const void* qkv, const void* pos,
                                                const void* bias_u, const void* bias_v,
                                                const void* lengths, void* out, int B, int T,
                                                int H, int dh, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int d = H * dh;
  return launch_any(q, q + d, q + 2 * d, pos, bias_u, bias_v, lengths, out, B, T, H, dh,
                    3 * d, stream);
}
