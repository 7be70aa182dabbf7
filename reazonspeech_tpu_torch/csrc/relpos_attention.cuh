#pragma once

// The kernel and its launchers, included by the two sources that hold the
// C entries: relpos_attention.cu (the fused, packed and streamed contracts:
// the TWO_PASS = false instances) and relpos_attention_single.cu (the
// single-pass contract: TWO_PASS = true). Each source instantiates only its
// own half of the templates, so nvcc compiles the halves side by side.
//
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
// Contract, per head h (bf16 inputs, any dh from 1 to 256):
//   scores = (qu·kᵀ + shift(qv·posᵀ)) / sqrt(dh), shift(x)[t,s] = x[t, T-1-t+s]
//   keys s >= length[b] score -1e30; fp32 softmax; out = p·v
// pos is [2T-1, H, dh] bf16 (offsets T-1 .. -(T-1)). Every query row t < T
// is computed (rows past the length too; the caller masks them later).
//
// Where the probabilities round to bf16 follows the TPU kernel each entry
// replaces. The fused, packed and blockwise contracts (:378, :430, :241)
// stream keys with an online softmax: one sweep over 64-key tiles,
// unnormalised p rounded to bf16 for p·v, the accumulator rescaled per tile
// and divided by the row sum at the end. The single-pass contract (:112)
// holds a whole [BQ, T] score block and normalises the probabilities before
// their bf16 cast; here that entry sweeps the keys twice: the row max and
// sum first, then p = exp(s - m) / l rounded to bf16, times v (the scores
// are recomputed). None has a T cap; the caller's T <= 1024 dispatch
// between the last two is kept only to map the entries one to one.
//
// What bounds it on the H100: at the nemo bucket (B=4, T=401, D=1024, H=8,
// dh=128) a call moves ~15 MB (q, k, v, out, pos) and does ~4 GFLOP of
// products (q·kᵀ, the (q+v)·pos band, p·v) and 1.3 M exponentials: a few
// microseconds of HBM or bf16 tensor-core time; at espnet's 20 s window
// (B·H=8, T=549, dh=64) ~0.5 GFLOP against ~3 MB. A block's work is a
// chain of dependent steps per key tile (products, the skewed band read,
// max, shuffles, exponentials, p·v), so latency and the number of warps in
// flight bound it, not a pipe.
//
// Design (the shared attention's in zipformer_attention.cu, with the
// position term on the tensor cores): a block takes 64 query rows of one
// (batch item, head) in strips of 16, one strip a warp, and sweeps the
// keys in 64-key tiles; scores, probabilities and the output accumulator
// never leave the registers. Per tile a warp computes with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators) the position term BD =
// qv·bandᵀ [16 x 80] against the 79 table rows its strip needs (l =
// T-1-t+s spans 15 + 64 rows per strip, not the block's 127), writes it to
// a per-warp fp32 buffer in shared memory and reads it back skewed,
// score(r, c) = BD[r][15 - r + c] (the skew is row-dependent: in the
// fragment it would need dynamic register indexing), as the accumulators
// that S = qu·kᵀ [16 x 64] then adds to. qu's A fragments stay in registers
// for the whole sweep (dh <= 128), qv's too up to dh = 64 (above that they
// would spill: they are read from shared memory at each use). log2(e) is
// folded into the scale, so an exponential is one FFMA and one ex2.approx;
// a row's max and sum take two quad shuffles; the fp32 score fragments of
// two adjacent key n-tiles are exactly the A fragment of a k16 step of
// P·V, so p is rounded to bf16 in registers and multiplied by V's B
// fragments (ldmatrix.trans) into O accumulators.
//
// The tiles: q, K, V and the band arrive by TMA (one thread issues a
// tile's 64-column boxes against an mbarrier; rows past T or outside the
// table and columns past dh read zeros) where dh is 64 or a multiple of 8
// above 112, every model's head: at the main paths' shapes on the H100,
// issuing thread-level cp.async copies of them took a large share of each
// warp's time, second only to the scores (PERF.md §6). Other widths are
// zero-padded to the next multiple of 16 (an instance each up to 128, then
// 256) and staged by cp.async in 16-, 8-, 4- or 2-byte copies, the widest
// that divides dh. V of tile i
// loads while tile i's scores are computed; K of tile i+1 and the next 64
// band rows during all of tile i (DEEP, see Cfg) or while its p·v runs;
// consecutive tiles' 128-row band windows overlap by 64 rows, so the band
// is a ring of 64-row chunks and each row is loaded once. At dh = 128 a
// streamed block holds ~105 KB of shared memory: two blocks (8 warps) an
// SM. The single-pass entry has the fewest blocks (B·H = 8 at espnet's
// window: 72 blocks of 64 rows) and two sweeps, so its block is 8 warps:
// each strip's warp pair splits every key tile in halves of 32 (its
// normalised p needs only the final row max and sum, so the split is
// exact): the two halves' max and sum are combined after the first sweep
// and their p·v sums after the second. dh in (128, 256] runs at 256 with
// the value columns split over two blocks that both compute the scores.
//
// Edges: query rows past T read zeros and are not written; keys past T
// score -inf; keys in [length, T) score -inf too (the JAX kernel's -1e30
// gives them p = 0 exactly, as length >= 1 leaves a finite row max), and
// key tiles wholly past the length are skipped; a length of 0 gives every
// key in [0, T) the same score, as -1e30 everywhere does (a uniform row);
// band rows outside [0, 2T-1) read zeros (they only meet excluded scores).

#include "gemm_sm90.cuh"  // mbarriers, TMA and the tensor-map encoder
#include "warp_mma.cuh"

namespace {

using namespace rs;
namespace sm90 = rs::sm90;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;  // query rows a block: 4 strips of 16
constexpr int KT = 64;  // keys a tile
constexpr int MAX_DH = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_BLOCK = 232448;          // the most a block may hold
constexpr int SMEM_HALF = 233472 / 2 - 1024;  // two blocks an SM, with their reserve
constexpr int BOX_BYTES = KT * 64 * 2;      // one TMA box: 64 rows of 64 bf16 columns

// The geometry of one instance: DHP = dh padded to a multiple of 16;
// TWO_PASS, the single-pass contract's two sweeps (8 warps: 2 key halves a
// strip); TMA, the tiles by TMA (DHP = 64, 128 or 256 and dh a multiple of
// 8 from 64 on: every model's head) or by cp.async. Tiles of KT rows: K
// [KST], V, the band ring [BSL], and the qu and qv tiles (qu's A fragments
// live in registers where dh <= 128, qv's where dh <= 64: such a tile is
// staged in the band ring and moved there; the others stay in tiles of
// their own, read by ldmatrix at each use). With TMA a tile is DHP / 64
// boxes of [64 rows][64 columns] bf16, 128-byte swizzled (the 16-byte group
// g of row r at group g ^ (r % 8)), TMA's layout; with cp.async, rows of
// DHP + 8 columns (an odd number of 16-byte words). Either way ldmatrix
// reads 8 rows without bank conflicts. Then a [16][LDB] fp32 BD buffer a
// warp (LDB = 8 mod 32: conflict-free float2 stores), the two key halves'
// row max and sum, and the mbarriers of the TMA copies. DEEP staging (two
// K stages, three band chunks: tile i+1's K and band load during all of
// tile i) wherever it leaves the streamed instances two blocks an SM and
// the single-pass ones (one block of 8 warps an SM) room; else one K stage
// and two chunks, loaded during p·v (dh = 128 streamed: the SM's second
// block hides them; dh > 128).
template <int DHP, bool TWO_PASS, bool TMA>
struct Cfg {
  static constexpr int KS = TWO_PASS ? 2 : 1;  // key groups a strip
  static constexpr int NW = 4 * KS;            // warps a block
  static constexpr int NT = 32 * NW;
  static constexpr int NKW = KT / KS;  // keys of a tile a warp scores
  static constexpr int NJ = NKW / 8;   // its score n8 tiles
  static constexpr int NBW = NKW + 16; // band rows it multiplies (NKW + 15 used)
  static constexpr int NBJ = NBW / 8;
  static constexpr int NK = DHP / 16;  // k16 steps of the two score products
  static constexpr bool QUREG = DHP <= 128;  // qu's fragments in registers
  static constexpr bool QVREG = DHP <= 64;   // qv's (above 64, registers would spill)
  static constexpr int QTILES = !QUREG + !QVREG;  // q tiles kept in shared memory
  static constexpr int DVC = QUREG ? DHP : 128;  // value columns a block
  static constexpr int NV = DVC / 8;
  static_assert(!TMA || DHP % 64 == 0, "TMA tiles are whole 64-column boxes");
  static constexpr int LD = TMA ? DHP : DHP + 8;  // row stride of the padded layout
  static constexpr int LDV = TMA ? DVC : DVC + 8;
  static constexpr int LDB = NBW + 8;
  static constexpr int LDO = DVC + 8;  // fp32 stride of the key halves' p·v combine
  static constexpr int TILE = KT * LD * 2;  // bytes of a K tile, a band chunk or a q tile
  static constexpr int VTILE = KT * LDV * 2;
  static constexpr int REST = VTILE + NW * 16 * LDB * 4 + QTILES * TILE +
                              (TWO_PASS ? KS * BQ * 2 * 4 : 0) + 64 + 1024;
  static constexpr bool DEEP = 5 * TILE + REST <= (TWO_PASS ? SMEM_BLOCK : SMEM_HALF);
  static constexpr int KST = DEEP ? 2 : 1;  // K stages
  static constexpr int BSL = DEEP ? 3 : 2;  // band chunks of KT rows
  static constexpr int k = 0;
  static constexpr int v = k + KST * TILE;
  static constexpr int band = v + VTILE;
  static constexpr int q = band + BSL * TILE;
  static constexpr int skew = q + QTILES * TILE;
  static constexpr int stats = skew + NW * 16 * LDB * 4;
  static constexpr int bars = stats + (TWO_PASS ? KS * BQ * 2 * 4 : 0);
  static constexpr int bytes = bars + 64 + 1024;  // + the alignment of the swizzled boxes
  static constexpr int qu = QUREG ? band : q;  // the q tiles while staged
  static constexpr int qv = QVREG ? band + TILE : q + (QUREG ? 0 : TILE);
  static_assert(BQ * LDO * 4 <= band + BSL * TILE, "the p·v combine fits over K, V and the band");
  static_assert(KT == BQ && 2 + KST + BSL <= 8, "a q tile has a K tile's shape; 8 mbarriers");
};

// the element offset of 16-byte group g (8 columns) of row r in a tile (see
// Cfg): swizzled boxes (TMA) or padded rows of stride LD
template <bool TMA, int LD>
__device__ __forceinline__ int toff(int r, int g) {
  if constexpr (TMA)
    return (g >> 3) * (KT * 64) + r * 64 + (((g & 7) ^ (r & 7)) << 3);
  else
    return r * LD + (g << 3);
}

// the same in bytes, for ldmatrix at a 32-bit shared-window address: the
// per-lane parts and the compile-time parts add to a tile's base, and no
// 64-bit pointer a load is kept in registers
template <bool TMA, int LD>
__device__ __forceinline__ uint32_t tbyte(int r, int g) {
  return static_cast<uint32_t>(toff<TMA, LD>(r, g)) * 2;
}

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
  void* out;           // bf16 (out_bf16) or fp32
  Strides in, o;       // q/k/v rows, out rows
  int T, H, dh;
  int vw;              // elements a cp.async copy: 8, 4, 2 or 1, the widest dividing dh
  int chunks;          // value-column blocks of a head
  bool out_bf16;
  float scale;
};

// The TMA maps of the tiles: qu, qv, k and v as [B][H][T][dh] (the Strides
// of the contract), pos as [1][H][2T-1][dh]; boxes of [64 rows][64 columns],
// 128-byte swizzled, zeros past every edge (rows past T or outside the
// table, columns past dh).
struct Maps {
  CUtensorMap qu, qv, k, v, pos;
};

// KT rows of a bf16 matrix into a padded tile (row stride LD) by cp.async:
// row r from source row row0 + r (zero outside [0, nvalid)), NCOLS columns
// from col0 (zero from column ``width`` on), VW elements a copy (VW divides
// width, col0 and the row stride)
template <int NCOLS, int NT, int LD, int VW>
__device__ __forceinline__ void stage_vw(bf16* dst, const bf16* src, size_t stride, int row0,
                                         int nvalid, int col0, int width) {
  constexpr int PER_ROW = NCOLS / VW;
  for (int i = threadIdx.x; i < KT * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VW, g = row0 + r;
    const bool ok = g >= 0 && g < nvalid && col0 + c < width;
    const bf16* s = ok ? src + size_t(g) * stride + col0 + c : src;
    bf16* d = dst + r * LD + c;
    if constexpr (VW == 1)
      *d = ok ? *s : __float2bfloat16(0.0f);
    else
      cp_async<2 * VW>(d, s, ok ? 2 * VW : 0);
  }
}

template <int NCOLS, int NT, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t stride, int row0,
                                      int nvalid, int col0, int width, int vw) {
  if (vw == 8)
    stage_vw<NCOLS, NT, LD, 8>(dst, src, stride, row0, nvalid, col0, width);
  else if (vw == 4)
    stage_vw<NCOLS, NT, LD, 4>(dst, src, stride, row0, nvalid, col0, width);
  else if (vw == 2)
    stage_vw<NCOLS, NT, LD, 2>(dst, src, stride, row0, nvalid, col0, width);
  else
    stage_vw<NCOLS, NT, LD, 1>(dst, src, stride, row0, nvalid, col0, width);
}

// the sweeps: the single-pass contract's STATS (row max and sum) then APPLY
// (normalised p·v); the streamed contracts' ONLINE
enum Phase { STATS, APPLY, ONLINE };

template <int DHP, bool TWO_PASS, bool TMA>
__global__ void __launch_bounds__(Cfg<DHP, TWO_PASS, TMA>::NT, TWO_PASS ? 1 : 2)
relpos_attention_kernel(const __grid_constant__ Args a, const __grid_constant__ Maps m) {
  using C = Cfg<DHP, TWO_PASS, TMA>;
  constexpr int NT = C::NT, NJ = C::NJ, NK = C::NK, NV = C::NV;
  constexpr int LD = C::LD, LDV = C::LDV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* s_k = reinterpret_cast<bf16*>(smem + C::k);
  bf16* s_v = reinterpret_cast<bf16*>(smem + C::v);
  bf16* s_band = reinterpret_cast<bf16*>(smem + C::band);
  bf16* s_qu = reinterpret_cast<bf16*>(smem + C::qu);
  bf16* s_qv = reinterpret_cast<bf16*>(smem + C::qv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bars);  // q, v, K stages, band chunks
  constexpr int BAR_Q = 0, BAR_V = 1, BAR_K = 2, BAR_BAND = 2 + C::KST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4, mi = lane / 8;
  const int strip = warp % 4, grp = warp / 4;  // rows 16·strip.., keys NKW·grp.. of a tile
  const int t0 = blockIdx.x * BQ, tw = t0 + 16 * strip;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.chunks, c0 = (blockIdx.z % a.chunks) * C::DVC;
  const int T = a.T, dh = a.dh, vw = a.vw;
  const bool fused = a.bias_u != nullptr;
  const int len = a.lengths[b];
  const int kend = len > 0 ? min(len, T) : T;  // keys past kend have p == 0
  const int n_tiles = (kend + KT - 1) / KT;
  const size_t base = size_t(b) * a.in.batch + size_t(h) * a.in.head;  // this (b, h)'s rows
  const bf16* kb = a.k + base;
  const bf16* vb = a.v + base;
  const bf16* posh = a.pos + size_t(h) * dh;  // table row l of head h at posh + l·H·dh
  const size_t pos_stride = size_t(a.H) * dh;
  const int lb0 = T - BQ - t0;  // table row of band chunk 0's first row
  const float c = a.scale * LOG2E;  // log2 domain: p = 2^(x·c - m·c)

  // TMA: thread 0 arms a tile's mbarrier with its bytes and issues its boxes
  // (NC / 64 of them, columns col0 ..); every thread waits on the barrier,
  // each use of it one phase later than the last (par: the parity bits)
  uint32_t par = 0;
  auto wait_bar = [&](int i) {
    sm90::mbar_wait(&bars[i], (par >> i) & 1);
    par ^= 1u << i;
  };
  auto tma_tile = [&](bf16* dst, const CUtensorMap* map, int bar, int ncols, int col0, int row0,
                      int head, int batch) {
    for (int x = 0; x < ncols; x += 64)
      tma_load_4d(dst + x * KT, map, &bars[bar], col0 + x, row0, head, batch);
  };
  if (TMA && tid == 0) {
    for (int i = 0; i < 8; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // qu and qv of the block's rows (rows past T zero), with the biases added
  // in the fused contracts (the sums rounded to bf16)
  if constexpr (TMA) {
    if (tid == 0) {
      sm90::mbar_expect_tx(&bars[BAR_Q], (fused ? 1 : 2) * (DHP / 64) * BOX_BYTES);
      tma_tile(s_qu, &m.qu, BAR_Q, DHP, 0, t0, h, b);
      if (!fused) tma_tile(s_qv, &m.qv, BAR_Q, DHP, 0, t0, h, b);
    }
    wait_bar(BAR_Q);
  } else {
    stage<DHP, NT, LD>(s_qu, a.qu + base, a.in.row, t0, T, 0, dh, vw);
    if (!fused) stage<DHP, NT, LD>(s_qv, a.qv + base, a.in.row, t0, T, 0, dh, vw);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  if (fused) {
    const bf16* bu = a.bias_u + size_t(h) * dh;
    const bf16* bv = a.bias_v + size_t(h) * dh;
    for (int i = tid; i < BQ * DHP; i += NT) {
      const int r = i / DHP, col = i % DHP, e = toff<TMA, LD>(r, col >> 3) + (col & 7);
      float su = 0.0f, sv = 0.0f;
      if (t0 + r < T && col < dh) {
        const float x = __bfloat162float(s_qu[e]);
        su = x + __bfloat162float(bu[col]);
        sv = x + __bfloat162float(bv[col]);
      }
      s_qu[e] = __float2bfloat16(su);
      s_qv[e] = __float2bfloat16(sv);
    }
    __syncthreads();
  }
  // this warp's A fragments of qu and qv at k16 step ks
  auto q_addr = [&](const bf16* tile, int ks) {
    return smem_u32(tile) + tbyte<TMA, LD>(16 * strip + lane % 16, 2 * ks + lane / 16);
  };
  uint32_t qa[C::QUREG ? NK : 1][4], qb[C::QVREG ? NK : 1][4];
  if constexpr (C::QUREG) {
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      ldmatrix_x4_at(qa[ks], q_addr(s_qu, ks));
      if constexpr (C::QVREG) ldmatrix_x4_at(qb[ks], q_addr(s_qv, ks));
    }
    sm90::fence_async_smem();  // the band ring that held them is refilled next, by TMA too
    __syncthreads();
  }
  // the A fragment of k16 step ks: from registers, or by ldmatrix from its tile
  auto q_frag = [&](int ks, const bf16* tile, auto& regs, uint32_t (&tmp)[4],
                    auto in_regs) -> const uint32_t(&)[4] {
    if constexpr (decltype(in_regs)::value) {
      return regs[ks];
    } else {
      ldmatrix_x4_at(tmp, q_addr(tile, ks));
      return tmp;
    }
  };

  // the tiles: K of key tile i (into stage i % KST), V of key tile i (its
  // value columns c0 ..), band chunk j (table rows lb0 + 64j .., into ring
  // slot j % BSL); TMA or cp.async
  auto issue_k = [&](int i) {
    bf16* dst = s_k + (i % C::KST) * KT * LD;
    if constexpr (!TMA) {
      stage<DHP, NT, LD>(dst, kb, a.in.row, i * KT, T, 0, dh, vw);
    } else if (tid == 0) {
      sm90::mbar_expect_tx(&bars[BAR_K + i % C::KST], (DHP / 64) * BOX_BYTES);
      tma_tile(dst, &m.k, BAR_K + i % C::KST, DHP, 0, i * KT, h, b);
    }
  };
  auto issue_v = [&](int i) {
    if constexpr (!TMA) {
      stage<C::DVC, NT, LDV>(s_v, vb, a.in.row, i * KT, T, c0, dh, vw);
    } else if (tid == 0) {
      sm90::mbar_expect_tx(&bars[BAR_V], (C::DVC / 64) * BOX_BYTES);
      tma_tile(s_v, &m.v, BAR_V, C::DVC, c0, i * KT, h, b);
    }
  };
  auto issue_band = [&](int j) {
    bf16* dst = s_band + (j % C::BSL) * KT * LD;
    if constexpr (!TMA) {
      stage<DHP, NT, LD>(dst, posh, pos_stride, lb0 + j * KT, 2 * T - 1, 0, dh, vw);
    } else if (tid == 0) {
      sm90::mbar_expect_tx(&bars[BAR_BAND + j % C::BSL], (DHP / 64) * BOX_BYTES);
      tma_tile(dst, &m.pos, BAR_BAND + j % C::BSL, DHP, 0, lb0 + j * KT, h, 0);
    }
  };

  float* sk = reinterpret_cast<float*>(smem + C::skew) + warp * 16 * C::LDB;
  const int ow = 48 - 16 * strip + C::NKW * grp;  // the warp's first row of a tile's band window

  // the warp's raw scores (qu·k + qv·pos, not yet scaled) of tile i (keys
  // s0 + NKW·grp ..): s[j][e] is row gid + 8·(e / 2), key 8j + 2tig + e % 2
  auto scores = [&](int i, int s0, float (&s)[NJ][4]) {
    const int kg = mi & 1;  // the 16-byte group of a k16 step this lane's rows read
    const uint32_t kt = smem_u32(s_k) + (i % C::KST) * C::TILE;
    const uint32_t chunk0 = smem_u32(s_band) + (i % C::BSL) * C::TILE;  // window rows 0..63
    const uint32_t chunk1 = smem_u32(s_band) + ((i + 1) % C::BSL) * C::TILE;  // 64..127
    // BD = qv·bandᵀ over the warp's window rows, through its buffer, in two
    // halves of the n8 tiles (fewer accumulators live at once)
    auto bd_half = [&](auto half) {
      constexpr int NBP = C::NBJ / 2, MID = (NBP + 1) / 2;  // ldmatrix pairs of n8 tiles
      constexpr int P0 = decltype(half)::value ? MID : 0, P1 = decltype(half)::value ? NBP : MID;
      float bd[2 * (P1 - P0)][4];
#pragma unroll
      for (int j = 0; j < 2 * (P1 - P0); ++j) bd[j][0] = bd[j][1] = bd[j][2] = bd[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t tmp[4];
        const uint32_t(&fv)[4] = q_frag(ks, s_qv, qb, tmp, Tag<C::QVREG>());
#pragma unroll
        for (int jp = P0; jp < P1; ++jp) {
          const int x = ow + 16 * jp + lane % 8 + 8 * (mi >> 1);  // window row, in [0, 128)
          uint32_t bf[4];
          ldmatrix_x4_at(bf, (x < KT ? chunk0 : chunk1) + tbyte<TMA, LD>(x & 63, 2 * ks + kg));
          mma_bf16(bd[2 * (jp - P0)], fv, bf[0], bf[1]);
          mma_bf16(bd[2 * (jp - P0) + 1], fv, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * (P1 - P0); ++j) {
        const int col = 8 * (2 * P0 + j) + 2 * tig;
        *reinterpret_cast<float2*>(sk + gid * C::LDB + col) = make_float2(bd[j][0], bd[j][1]);
        *reinterpret_cast<float2*>(sk + (gid + 8) * C::LDB + col) =
            make_float2(bd[j][2], bd[j][3]);
      }
    };
    bd_half(Tag<0>());
    bd_half(Tag<1>());
    __syncwarp();
    // the position term read back skewed (row r, key c: band column
    // 15 - r + c) as the accumulators that qu·kᵀ then adds to
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e >> 1);
        s[j][e] = sk[r * C::LDB + 15 - r + 8 * j + 2 * tig + (e & 1)];
      }
    __syncwarp();  // the buffer is rewritten at the next tile
    const int krow = C::NKW * grp + lane % 8 + 8 * (mi >> 1);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t tmp[4];
      const uint32_t(&fu)[4] = q_frag(ks, s_qu, qa, tmp, Tag<C::QUREG>());
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4_at(bf, kt + tbyte<TMA, LD>(krow + 16 * jp, 2 * ks + kg));
        mma_bf16(s[2 * jp], fu, bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], fu, bf[2], bf[3]);
      }
    }
    const int k0 = s0 + C::NKW * grp;
    if (len == 0 || k0 + C::NKW > kend) {  // an edge tile: keys past T or the length
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          if (key >= T || (len > 0 && key >= len))
            s[j][e] = neg_inf();
          else if (len == 0)
            s[j][e] = 0.0f;
        }
    }
  };

  // o += p·v for the tile in shared memory, p in s (fp32, rounded to bf16 here)
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  auto pv = [&](const float (&p)[NJ][4]) {
    const int vrow = C::NKW * grp + lane % 8 + 8 * (mi & 1);
    const uint32_t vs = smem_u32(s_v);
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int vp = 0; vp < NV / 2; ++vp) {
        uint32_t bf[4];
        ldmatrix_x4_trans_at(bf, vs + tbyte<TMA, LDV>(vrow + 16 * kk, (mi >> 1) + 2 * vp));
        mma_bf16(o[2 * vp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * vp + 1], pa, bf[2], bf[3]);
      }
    }
  };

  // per row (lo, hi): running max (raw) and this thread's part of the sum;
  // for APPLY the final m·c and 1 / l
  float m_[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f};
  float mc[2] = {0.0f, 0.0f}, inv_l[2] = {1.0f, 1.0f};

  // one sweep over the key tiles; V of tile i loads while its scores are
  // computed, K of tile i+1 and the band's next chunk during all of tile i
  // (DEEP) or while its p·v runs
  auto sweep = [&](auto phase) {
    constexpr int P = decltype(phase)::value;
    issue_k(0);
    issue_band(0);
    issue_band(1);
    cp_async_commit();
    for (int i = 0; i < n_tiles; ++i) {
      const int s0 = i * KT;
      const bool next = i + 1 < n_tiles;
      if constexpr (TMA) {
        wait_bar(BAR_K + i % C::KST);
        if (i == 0) wait_bar(BAR_BAND);
        wait_bar(BAR_BAND + (i + 1) % C::BSL);
      } else {
        cp_async_wait_all();
      }
      __syncthreads();  // K and band of tile i in; every warp is done with tile i-1
      if constexpr (P != STATS) {
        issue_v(i);
        cp_async_commit();
      }
      if (C::DEEP && next) {  // into the stage and chunk tile i-1 left
        issue_k(i + 1);
        issue_band(i + 2);
        cp_async_commit();
      }
      float s[NJ][4];
      scores(i, s0, s);
      float alpha[2] = {1.0f, 1.0f};
      if constexpr (P == APPLY) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], c, -mc[e / 2])) * inv_l[e / 2];
      } else {
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_[r], quad_max(row_max(s, r)));
          mu[r] = m_new == neg_inf() ? 0.0f : m_new;  // no key yet: p = 0, not NaN
          alpha[r] = ex2((m_[r] - mu[r]) * c);
          m_[r] = m_new;
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
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
      }
      if constexpr (P != STATS) {
        if constexpr (TMA)
          wait_bar(BAR_V);
        else if (C::DEEP && next)
          cp_async_wait<1>();  // V of tile i, not tile i+1's K and band
        else
          cp_async_wait_all();
      }
      if (!C::DEEP || P != STATS)
        __syncthreads();  // V of tile i in; every warp is done with K and band chunk i
      if (!C::DEEP && next) {
        issue_k(i + 1);
        issue_band(i + 2);
        cp_async_commit();
      }
      if constexpr (P != STATS) {
        if constexpr (P == ONLINE) {
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            o[n][0] *= alpha[0], o[n][1] *= alpha[0];
            o[n][2] *= alpha[1], o[n][3] *= alpha[1];
          }
        }
        pv(s);
      }
    }
  };

  const int row_lo = 16 * strip + gid;  // the block row of accumulator row lo; hi is + 8
  if constexpr (TWO_PASS) {
    sweep(Tag<STATS>());
    // the two key halves' max and sum, combined in a fixed order
    float* st = reinterpret_cast<float*>(smem + C::stats);  // [KS][BQ][2]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      if (tig == 0) {
        st[(grp * BQ + row_lo + 8 * r) * 2] = m_[r];
        st[(grp * BQ + row_lo + 8 * r) * 2 + 1] = l[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* h0 = st + (row_lo + 8 * r) * 2;
      const float* h1 = st + (BQ + row_lo + 8 * r) * 2;
      const float mm = fmaxf(h0[0], h1[0]);  // finite: key 0 is scored by half 0
      const float ll = h0[1] * ex2((h0[0] - mm) * c) + h1[1] * ex2((h1[0] - mm) * c);
      mc[r] = mm * c;
      inv_l[r] = 1.0f / ll;
    }
    sweep(Tag<APPLY>());
    // the second half's p·v added to the first's, over K, V and the band
    float* ob = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(ob + (row_lo + 8 * r) * C::LDO + 8 * n + 2 * tig) =
              make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 x =
            *reinterpret_cast<const float2*>(ob + (row_lo + 8 * r) * C::LDO + 8 * n + 2 * tig);
        o[n][2 * r] += x.x;
        o[n][2 * r + 1] += x.y;
      }
  } else {
    sweep(Tag<ONLINE>());
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.0f / quad_sum(l[r]);
  }

  const bool pairs = dh % 2 == 0;  // two adjacent columns at an even offset
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + gid + 8 * r;
    if (t >= T) continue;
    const size_t row = size_t(b) * a.o.batch + size_t(h) * a.o.head + size_t(t) * a.o.row;
    const float inv = TWO_PASS ? 1.0f : inv_l[r];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = c0 + 8 * n + 2 * tig;
      const float x0 = o[n][2 * r] * inv, x1 = o[n][2 * r + 1] * inv;
      if (a.out_bf16) {
        bf16* p = static_cast<bf16*>(a.out) + row + col;
        if (pairs && col + 1 < dh) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < dh) p[0] = __float2bfloat16(x0);
          if (col + 1 < dh) p[1] = __float2bfloat16(x1);
        }
      } else {
        float* p = static_cast<float*>(a.out) + row + col;
        if (pairs && col + 1 < dh) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (col < dh) p[0] = x0;
          if (col + 1 < dh) p[1] = x1;
        }
      }
    }
  }
}

// The TMA map of a contract's bf16 tensor as [batch][heads][rows][dh]
// (strides in elements), in boxes of [KT rows][64 columns]. Returns 0 or a
// CUDA error.
int encode_rows(CUtensorMap* map, const void* base, int dh, int rows, int heads, int batch,
                size_t row, size_t head, size_t batch_stride) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {row * 2, head * 2, batch_stride * 2};
  const cuuint32_t box[4] = {64, KT, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DHP, bool TWO_PASS, bool TMA>
int launch(Args a, int B, cudaStream_t stream) {
  using C = Cfg<DHP, TWO_PASS, TMA>;
  auto kernel = relpos_attention_kernel<DHP, TWO_PASS, TMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.chunks = (a.dh + C::DVC - 1) / C::DVC;
  if (B * a.chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Maps m{};
  if constexpr (TMA) {
    const int T = a.T, H = a.H, dh = a.dh;
    const Strides& s = a.in;
    int e = encode_rows(&m.qu, a.qu, dh, T, H, B, s.row, s.head, s.batch);
    if (!e) e = encode_rows(&m.qv, a.qv, dh, T, H, B, s.row, s.head, s.batch);
    if (!e) e = encode_rows(&m.k, a.k, dh, T, H, B, s.row, s.head, s.batch);
    if (!e) e = encode_rows(&m.v, a.v, dh, T, H, B, s.row, s.head, s.batch);
    if (!e)
      e = encode_rows(&m.pos, a.pos, dh, 2 * T - 1, H, 1, size_t(H) * dh, dh,
                      size_t(2 * T - 1) * H * dh);
    if (e) return e;
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, B * a.chunks);
  kernel<<<grid, C::NT, C::bytes, stream>>>(a, m);
  RS_RETURN_LAST_ERROR();
}

template <bool TWO_PASS>
int launch_any(Args a, int B, void* stream) {
  const int dh = a.dh;
  if (B <= 0 || a.T <= 0 || a.H <= 0 || a.H > 65535 || dh <= 0 || dh > MAX_DH)
    return static_cast<int>(cudaErrorInvalidValue);
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  a.vw = dh % 8 == 0 ? 8 : dh % 4 == 0 ? 4 : dh % 2 == 0 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA where the tiles are whole 64-column boxes (dh padded to 64, 128 or
  // 256, at least one box of it) and the rows 16-byte strided
  if (dh % 8 == 0 && (dh == 64 || dh > 112)) {
    if (dh == 64) return launch<64, TWO_PASS, true>(a, B, s);
    if (dh <= 128) return launch<128, TWO_PASS, true>(a, B, s);
    return launch<256, TWO_PASS, true>(a, B, s);
  }
  switch ((dh + 15) / 16) {
    case 1: return launch<16, TWO_PASS, false>(a, B, s);
    case 2: return launch<32, TWO_PASS, false>(a, B, s);
    case 3: return launch<48, TWO_PASS, false>(a, B, s);
    case 4: return launch<64, TWO_PASS, false>(a, B, s);
    case 5: return launch<80, TWO_PASS, false>(a, B, s);
    case 6: return launch<96, TWO_PASS, false>(a, B, s);
    case 7: return launch<112, TWO_PASS, false>(a, B, s);
    case 8: return launch<128, TWO_PASS, false>(a, B, s);
    default: return launch<256, TWO_PASS, false>(a, B, s);
  }
}

// The [B, H, T, dh] contracts: qu, qv, k, v summed by the caller, out fp32.
template <bool TWO_PASS>
int launch_bhtd(const void* qu, const void* qv, const void* k, const void* v, const void* pos,
                const void* lengths, void* out, int B, int T, int H, int dh, void* stream) {
  Args a{};
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
  a.dh = dh;
  a.out_bf16 = false;
  return launch_any<TWO_PASS>(a, B, stream);
}

}  // namespace
