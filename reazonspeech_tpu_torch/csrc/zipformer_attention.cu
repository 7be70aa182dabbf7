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
//   has no room for a [T, T] score block, so this entry sweeps the keys
//   twice: the first sweep keeps only the running row max and sum, the
//   second forms p = exp(s - m) / l, casts it to bf16 and accumulates p·v.
//   Scores are recomputed, which is cheap (qd = 32, pd = 4).
// - rs_shared_rel_attention_blockwise (streamed KV on the TPU): one sweep
//   with an online softmax over 64-key tiles: running max and sum in fp32,
//   unnormalised p cast to bf16 for p·v, the accumulator rescaled per tile
//   and divided by the sum at the end.
// Neither has a T cap, so the model's T <= 2048 dispatch between them is
// kept only to map the entries one to one.
//
// What bounds it on the H100: at the k2 main path's stack-0 shape (G = 16,
// T = 1596, qd = 32, pd = 4, dv = 12) one application does ~3.9 GFLOP of
// T² products (q·kᵀ, the position term, p·v) against ~5 MB of q/k/qp/v/out,
// ~4 us of tensor-core time; but the softmax takes one exponential a score,
// 40.8 M scores, and the SMs' special-function units do 16 a clock each
// (~4.2e12 a second): ~10 us a sweep, ~20 us for the single-pass entry's
// two. The position term (pd FMAs a score), the scaling, max and sum are
// ~12 more instructions a score on the CUDA cores, so the floor is the
// issue of those, not the tensor cores or the bytes.
//
// Design: everything per score stays in registers. A block of 4 warps
// takes 16 query rows a warp of one row g (and one chunk of value columns)
// and sweeps the keys in 64-key tiles. 4 warps share each K, V and band tile
// among 64 rows; blocks of 1 or 2 warps would fill more SMs at small G·T,
// but timed slower at every shape of the k2 path, stack 3's 128 blocks and
// the nonlin T=3196's 50 included (PERF.md §6). Each warp computes S = q·kᵀ with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators; q's A fragments loaded
// once, K's B fragments by ldmatrix; qd zero-padded to 32), adds the
// position term qp[t]·pos[T-1-t+s'] by FMAs into the score registers from a
// staged band of 16·warps + 63 table rows (fp32, [band row][pd padded to 4
// or 8], so pd = 4 is one 16-byte load; a thread's rows t and t+8 read the
// same band rows one n-tile apart, so each loaded row serves two scores),
// and folds log2(e) into the scale, so that an exponential is one FFMA and
// one ex2.approx. A row's scores lie on the 4 threads of a quad: its max
// and sum take two shuffles each. The fp32 score fragments of two adjacent
// key n-tiles are exactly the A fragment of a k16 step of P·V, so p is
// rounded to bf16 in registers and multiplied by V's B fragments
// (ldmatrix.trans) into O accumulators that never leave the registers
// (dv = 12 padded to 16: two n8 tiles; wider value sets in chunks of 192
// columns over the grid). K and V tiles arrive by cp.async into two
// shared-memory stages and the band through registers, so tile i+1 loads
// while tile i computes; the one block-wide barrier a tile is the buffer
// hand-off. Every loop bound is a compile-time constant (a runtime one
// turns the unrolled score loops into integer bookkeeping), and the position
// term goes into the accumulators before the products add to them, so its
// FMAs never wait on the tensor cores. What holds this version back
// (PERF.md §6): the grid has G·T/16 warps, ~12 an SM at stack 0 (registers
// allow 16), too few to hide the latency of the ldmatrix -> mma -> FMA ->
// max -> shuffle -> exp chain of a tile, so the SMs issue far below their
// rate; the scores (mma and position term) take the larger part of the
// time, the exponentials a small one. Edges: query rows past T read zeros and
// are not written; keys past T are excluded; keys in [length, T) are
// excluded too (the JAX kernel's -1e30 gives them p = 0 exactly, as
// length >= 1 leaves a finite row max), and key tiles wholly past the
// length are skipped; a length of 0 gives every key in [0, T) the same
// score, as the JAX kernel's -1e30 everywhere does (a uniform row).

#include "warp_mma.cuh"

namespace {

using namespace rs;
typedef __nv_bfloat16 bf16;

constexpr int QW = 4;                // warps a block (16 query rows each)
constexpr int NT = 32 * QW;          // threads a block
constexpr int BQ = 16 * QW;          // query rows a block
constexpr int KT = 64;               // keys a tile
constexpr int NJ = KT / 8;           // score n-tiles of a warp's tile
constexpr int NB = BQ + KT - 1;      // band rows of a tile
constexpr int MAX_QD = 128, MAX_PD = 32;  // the widest q/k and qp the kernel takes
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// One stage: the K tile [KT][LDK] (QDP = qd zero-padded; LDK = QDP + 8, an
// odd number of 16-byte words: conflict-free ldmatrix), the V tile
// [KT][LDV] (DVC = 8·NV value columns, +8 so that ldmatrix.trans rows fall
// in distinct banks) and the band [NB][PDP] fp32; two stages. Past PDP = 8
// the block's qp rows [BQ][PDP] fp32 follow (QP_SMEM).
template <int NV, int PDP, int QDP>
struct Layout {
  static constexpr int DVC = 8 * NV;
  static constexpr int LDK = QDP + 8;
  static constexpr int LDV = DVC + 8;
  static constexpr bool QP_SMEM = PDP > 8;
  static constexpr int k = 0;
  static constexpr int v = k + align16(KT * LDK * 2);
  static constexpr int band = v + align16(KT * LDV * 2);
  static constexpr int stage = band + align16(NB * PDP * 4);
  static constexpr int qp = 2 * stage;
  static constexpr int bytes = qp + (QP_SMEM ? BQ * PDP * 4 : 0);
};

// the sweeps: the single-pass entry's STATS (row max and sum) then APPLY
// (normalised p·v); the streamed entry's ONLINE
enum Phase { STATS, APPLY, ONLINE };

// QW warps, BQ query rows of row gi, value columns [c0, c0 + 8·NV)
template <int NV, int PDP, int QDP, bool TWO_PASS>
__global__ void __launch_bounds__(NT)
shared_rel_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ qp, const bf16* __restrict__ pos,
                            const bf16* __restrict__ v, const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int qd, int pd, int dv, int heads,
                            float scale) {
  using L = Layout<NV, PDP, QDP>;
  constexpr int DVC = L::DVC, LDK = L::LDK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4, mi = lane / 8;
  const int t0 = blockIdx.x * BQ, tw = t0 + 16 * warp;  // block's, warp's first query row
  const int gi = blockIdx.y, c0 = blockIdx.z * DVC;
  const int len = lengths[gi];
  const int kend = len > 0 ? min(len, T) : T;  // keys past kend have p == 0
  const int n_tiles = (kend + KT - 1) / KT;
  const size_t gT = size_t(gi) * T;
  const bf16* kg = k + gT * qd;
  const bf16* vg = v + gT * dv;
  const bf16* posg = pos + size_t(gi % heads) * (2 * T - 1) * pd;
  const float c = scale * LOG2E;  // log2 domain: p = 2^(x·c - m·c)

  // q's A fragments (QDP / 16 k16 steps) and qp of rows tw + gid (lo) and
  // + 8 (hi): in registers up to PDP = 8, else the block's rows in shared
  // memory. (The published widths' code is kept as it was: a rewrite of
  // these lines with the same meaning slowed the streamed entry on the
  // H100, PERF.md §6.)
  uint32_t qa[QDP / 16][4];
  constexpr int PQR = L::QP_SMEM ? 1 : PDP;  // qp values a row in registers
  float qp_lo[PQR], qp_hi[PQR];
  const float4* s_qp = reinterpret_cast<const float4*>(smem + L::qp);
  if constexpr (QDP == 32) {  // qd a multiple of 8, pd <= 8
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tw + gid + 8 * (i & 1), col = 16 * ks + 2 * tig + 8 * (i >> 1);
        qa[ks][i] = row < T && col < qd
                        ? *reinterpret_cast<const uint32_t*>(q + (gT + row) * qd + col)
                        : 0u;
      }
#pragma unroll
    for (int d = 0; d < PDP; ++d) {
      qp_lo[d] =
          tw + gid < T && d < pd ? __bfloat162float(qp[(gT + tw + gid) * pd + d]) : 0.0f;
      qp_hi[d] = tw + gid + 8 < T && d < pd
                     ? __bfloat162float(qp[(gT + tw + gid + 8) * pd + d])
                     : 0.0f;
    }
  } else {  // any qd (a 2-byte load an element where qd is odd), qp staged
#pragma unroll
    for (int ks = 0; ks < QDP / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tw + gid + 8 * (i & 1), col = 16 * ks + 2 * tig + 8 * (i >> 1);
        const bf16* p = q + (gT + row) * qd + col;
        if (row >= T || col >= qd)
          qa[ks][i] = 0u;
        else if (qd % 2 == 0)
          qa[ks][i] = *reinterpret_cast<const uint32_t*>(p);
        else
          qa[ks][i] = pack_bf16(__bfloat162float(p[0]),
                                col + 1 < qd ? __bfloat162float(p[1]) : 0.0f);
      }
    float* qs = reinterpret_cast<float*>(smem + L::qp);
    for (int i = tid; i < BQ * PDP; i += NT) {
      const int r = i / PDP, d = i % PDP;
      qs[i] = t0 + r < T && d < pd ? __bfloat162float(qp[(gT + t0 + r) * pd + d]) : 0.0f;
    }
  }

  // the K tile (copies of VW elements: 16 bytes where qd is a multiple of
  // 8, as every model's is; narrower where it is not) and the V tile (8-byte
  // copies where dv is a multiple of 4; else element by element) at s0
  auto k_rows = [&](bf16* ks, int s0, auto width) {
    constexpr int VW = decltype(width)::value;
    for (int i = tid; i < KT * (QDP / VW); i += NT) {
      const int r = i / (QDP / VW), col = (i % (QDP / VW)) * VW, key = s0 + r;
      const bool ok = key < T && col < qd;
      const bf16* src = ok ? kg + size_t(key) * qd + col : kg;
      if constexpr (VW == 1)
        ks[r * LDK + col] = ok ? *src : __float2bfloat16(0.0f);
      else
        cp_async<2 * VW>(ks + r * LDK + col, src, ok ? 2 * VW : 0);
    }
  };
  const bool v8 = dv % 4 == 0;
  auto issue_kv = [&](int s0, int b, bool with_v) {
    bf16* ks = reinterpret_cast<bf16*>(smem + b * L::stage + L::k);
    if (QDP == 32 || qd % 8 == 0)  // QDP = 32: qd a multiple of 8
      k_rows(ks, s0, Tag<8>());
    else if (qd % 4 == 0)
      k_rows(ks, s0, Tag<4>());
    else if (qd % 2 == 0)
      k_rows(ks, s0, Tag<2>());
    else
      k_rows(ks, s0, Tag<1>());
    if (with_v) {
      bf16* vs = reinterpret_cast<bf16*>(smem + b * L::stage + L::v);
      if (v8) {
        for (int i = tid; i < KT * (DVC / 4); i += NT) {
          const int r = i / (DVC / 4), cc = (i % (DVC / 4)) * 4, key = s0 + r, col = c0 + cc;
          const bool ok = key < T && col < dv;
          cp_async<8>(vs + r * L::LDV + cc, ok ? vg + size_t(key) * dv + col : vg, ok ? 8 : 0);
        }
      } else {
        for (int i = tid; i < KT * DVC; i += NT) {
          const int r = i / DVC, cc = i % DVC, key = s0 + r, col = c0 + cc;
          vs[r * L::LDV + cc] =
              key < T && col < dv ? vg[size_t(key) * dv + col] : __float2bfloat16(0.0f);
        }
      }
    }
    cp_async_commit();
  };
  // band row tid of the tile at s0 (table row T-1-(t0+BQ-1)+s0+tid; NB <=
  // NT, so one row a thread) into stage b: up to PDP = 8 through registers,
  // loaded before a tile computes and stored after; wider rows straight
  // into the stage (which the previous tile has left)
  static_assert(NB <= NT, "one band row a thread");
  float band_next[PQR];
  auto load_band = [&](int s0, int b) {
    const int l = T - BQ - t0 + s0 + tid;
    const bool ok = tid < NB && l >= 0 && l < 2 * T - 1;
    if constexpr (!L::QP_SMEM) {
      if (pd == PDP) {  // the row in 8-byte loads (pd = 4: one)
#pragma unroll
        for (int d = 0; d < PDP; d += 4) {
          const uint2 u = ok ? *reinterpret_cast<const uint2*>(posg + size_t(l) * PDP + d)
                             : make_uint2(0u, 0u);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          band_next[d] = lo.x, band_next[d + 1] = lo.y;
          band_next[d + 2] = hi.x, band_next[d + 3] = hi.y;
        }
      } else {
#pragma unroll
        for (int d = 0; d < PDP; ++d)
          band_next[d] = ok && d < pd ? __bfloat162float(posg[size_t(l) * pd + d]) : 0.0f;
      }
    } else if (tid < NB) {  // straight into the stage, 8-byte loads where pd allows
      float* row = reinterpret_cast<float*>(smem + b * L::stage + L::band) + tid * PDP;
      for (int d = 0; d < PDP; d += 4) {
        if (pd % 4 == 0) {
          const uint2 u = ok && d < pd
                              ? *reinterpret_cast<const uint2*>(posg + size_t(l) * pd + d)
                              : make_uint2(0u, 0u);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          *reinterpret_cast<float4*>(row + d) = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            row[d + e] = ok && d + e < pd ? __bfloat162float(posg[size_t(l) * pd + d + e]) : 0.0f;
        }
      }
    }
  };
  auto store_band = [&](int b) {
    if constexpr (!L::QP_SMEM) {
      float4* band = reinterpret_cast<float4*>(smem + b * L::stage + L::band);
      if (tid < NB) {
#pragma unroll
        for (int d = 0; d < PDP; d += 4)
          band[tid * (PDP / 4) + d / 4] =
              make_float4(band_next[d], band_next[d + 1], band_next[d + 2], band_next[d + 3]);
      }
    }
  };

  // the warp's raw scores (qp·pos + q·k, not yet scaled) of the tile at s0
  // in stage b: s[j][i] is row gid + 8·(i / 2), key s0 + 8j + 2tig + i % 2
  auto scores = [&](int b, int s0, float (&s)[NJ][4]) {
    // the position term first, on the CUDA cores, as the accumulators the
    // products then add to (the FMAs need not wait for the tensor cores):
    // row gid at n-tile j and row gid + 8 at n-tile j + 1 read the same band
    // row (T-1-t+s' is one apart per row and per key)
    const float4* band = reinterpret_cast<const float4*>(smem + b * L::stage + L::band);
    const int base = BQ - 1 - 16 * warp - gid + 2 * tig;
#pragma unroll
    for (int j = -1; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4* br = band + (base + 8 * j + e) * (PDP / 4);
#pragma unroll
        for (int d4 = 0; d4 < PDP / 4; ++d4) {
          if (L::QP_SMEM && 4 * d4 >= pd) break;
          const float4 w = br[d4];
          float4 lo, hi;  // qp of rows gid and gid + 8, columns 4·d4 ..
          if constexpr (L::QP_SMEM) {
            lo = s_qp[(16 * warp + gid) * (PDP / 4) + d4];
            hi = s_qp[(16 * warp + gid + 8) * (PDP / 4) + d4];
          } else {
            lo = make_float4(qp_lo[4 * d4], qp_lo[4 * d4 + 1], qp_lo[4 * d4 + 2],
                             qp_lo[4 * d4 + 3]);
            hi = make_float4(qp_hi[4 * d4], qp_hi[4 * d4 + 1], qp_hi[4 * d4 + 2],
                             qp_hi[4 * d4 + 3]);
          }
          if (j >= 0) {
            float& x = s[j][e];
            x = d4 == 0 ? lo.x * w.x : fmaf(lo.x, w.x, x);
            x = fmaf(lo.y, w.y, x);
            x = fmaf(lo.z, w.z, x);
            x = fmaf(lo.w, w.w, x);
          }
          if (j + 1 < NJ) {
            float& x = s[j + 1][2 + e];
            x = d4 == 0 ? hi.x * w.x : fmaf(hi.x, w.x, x);
            x = fmaf(hi.y, w.y, x);
            x = fmaf(hi.z, w.z, x);
            x = fmaf(hi.w, w.w, x);
          }
        }
      }
    const bf16* ks = reinterpret_cast<const bf16*>(smem + b * L::stage + L::k);
#pragma unroll
    for (int kk = 0; kk < QDP / 16; ++kk) {
      if (QDP > 32 && 16 * kk >= qd) break;  // k16 steps wholly past qd are zero
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (16 * jp + lane % 8 + 8 * (mi >> 1)) * LDK + 16 * kk + 8 * (mi & 1));
        mma_bf16(s[2 * jp], qa[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bf[2], bf[3]);
      }
    }
    if (len == 0 || s0 + KT > kend) {  // an edge tile: keys past T or the length
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = s0 + 8 * j + 2 * tig + (i & 1);
          if (key >= T || (len > 0 && key >= len))
            s[j][i] = rs::neg_inf();
          else if (len == 0)
            s[j][i] = 0.0f;
        }
    }
  };

  // o += p·v for the tile in stage b, p in s (fp32, rounded to bf16 here)
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  auto pv = [&](int b, const float (&p)[NJ][4]) {
    const bf16* rows = reinterpret_cast<const bf16*>(smem + b * L::stage + L::v) +
                       (lane % 8 + 8 * (mi & 1)) * L::LDV + 8 * (mi >> 1);
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int vp = 0; vp < NV / 2; ++vp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, rows + 16 * kk * L::LDV + 16 * vp);
        mma_bf16(o[2 * vp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * vp + 1], pa, bf[2], bf[3]);
      }
    }
  };

  // per row (lo, hi): running max (raw) and this thread's part of the sum;
  // for APPLY the final m·c and 1 / l
  float m[2] = {rs::neg_inf(), rs::neg_inf()}, l[2] = {0.0f, 0.0f};
  float mc[2] = {0.0f, 0.0f}, inv_l[2] = {1.0f, 1.0f};

  // one sweep over the tiles, double-buffered
  auto sweep = [&](auto phase) {
    constexpr int P = decltype(phase)::value;
    issue_kv(0, 0, P != STATS);
    load_band(0, 0);
    store_band(0);
    cp_async_wait_all();
    __syncthreads();
    for (int i = 0; i < n_tiles; ++i) {
      const int b = i & 1, s0 = i * KT;
      const bool next = i + 1 < n_tiles;
      if (next) {
        issue_kv(s0 + KT, b ^ 1, P != STATS);
        load_band(s0 + KT, b ^ 1);
      }
      float s[NJ][4];
      scores(b, s0, s);
      if constexpr (P == APPLY) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], c, -mc[e / 2])) * inv_l[e / 2];
        pv(b, s);
      } else {
        float mu[2], alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m[h], quad_max(row_max(s, h)));
          mu[h] = m_new == rs::neg_inf() ? 0.0f : m_new;  // no key yet: p = 0, not NaN
          alpha[h] = ex2((m[h] - mu[h]) * c);
          m[h] = m_new;
        }
        float sum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // two partial sums a row
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = ex2(fmaf(s[j][e], c, -mu[e / 2] * c));
            sum[e / 2][j % 2] += s[j][e];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (sum[h][0] + sum[h][1]);
        if constexpr (P == ONLINE) {
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            o[n][0] *= alpha[0], o[n][1] *= alpha[0];
            o[n][2] *= alpha[1], o[n][3] *= alpha[1];
          }
          pv(b, s);
        }
      }
      if (next) store_band(b ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }
  };

  if constexpr (TWO_PASS) {
    sweep(Tag<STATS>());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mc[h] = m[h] * c;
      inv_l[h] = 1.0f / quad_sum(l[h]);
    }
    sweep(Tag<APPLY>());
  } else {
    sweep(Tag<ONLINE>());
#pragma unroll
    for (int h = 0; h < 2; ++h) inv_l[h] = 1.0f / quad_sum(l[h]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = tw + gid + 8 * h;
    if (t >= T) continue;
    float* orow = out + (gT + t) * dv + c0;
    const float inv = TWO_PASS ? 1.0f : inv_l[h];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * tig + e;
        if (c0 + col < dv) orow[col] = o[n][2 * h + e] * inv;
      }
  }
}

template <int NV, int PDP, int QDP, bool TWO_PASS>
int launch(const void* q, const void* k, const void* qp, const void* pos, const void* v,
           const void* lengths, void* out, int G, int T, int qd, int pd, int dv, int heads,
           float scale, cudaStream_t stream) {
  using L = Layout<NV, PDP, QDP>;
  auto kernel = shared_rel_attention_kernel<NV, PDP, QDP, TWO_PASS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (dv + L::DVC - 1) / L::DVC;
  const dim3 grid((T + BQ - 1) / BQ, G, chunks);
  kernel<<<grid, NT, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(pos), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, qd, pd, dv, heads, scale);
  RS_RETURN_LAST_ERROR();
}

template <bool TWO_PASS>
int launch_any(const void* q, const void* k, const void* qp, const void* pos, const void* v,
               const void* lengths, void* out, int G, int T, int qd, int pd, int dv, int heads,
               float scale, void* stream) {
  if (G <= 0 || G > 65535 || T <= 0 || heads <= 0 || qd <= 0 || qd > MAX_QD || pd <= 0 ||
      pd > MAX_PD || dv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dv <= 16: two n8 tiles (the per-head applications, dv = 12); wider:
  // chunks of 192 columns (the nonlin attention's 144 .. 576). qd a
  // multiple of 8 up to 32 and pd up to 8 (every published Zipformer2):
  // q·kᵀ in two k16 steps, qp in registers; any other width up to 128 and
  // 32: q·kᵀ in up to eight k16 steps, qp in shared memory
#define RS_LAUNCH(NV, PDP, QDP)                                                                \
  launch<NV, PDP, QDP, TWO_PASS>(q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads,      \
                                 scale, s)
  const int nv = dv <= 16 ? 2 : 24;
  if (qd > 32 || qd % 8 || pd > 8) return nv == 2 ? RS_LAUNCH(2, 32, 128) : RS_LAUNCH(24, 32, 128);
  if (nv == 2) return pd <= 4 ? RS_LAUNCH(2, 4, 32) : RS_LAUNCH(2, 8, 32);
  return pd <= 4 ? RS_LAUNCH(24, 4, 32) : RS_LAUNCH(24, 8, 32);
#undef RS_LAUNCH
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
