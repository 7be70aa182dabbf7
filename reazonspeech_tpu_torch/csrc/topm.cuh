// Exact top-m in lax.top_k's order from keys kept in registers, and the
// merges that combine them; shared by beam_topk.cu and joint_topm.cu (plain
// C interface, no PyTorch headers).
//
// The JAX kernels' contract (reazonspeech_tpu/ops/beam_topk.py:33-55): the
// blank column reads as EXCLUDED = -1e30, then m rounds each take the
// largest value, the lowest column among ties, and rewrite it to EXCLUDED.
// The rounds therefore pick, in order (value desc, column asc), every
// column other than blank whose value is above EXCLUDED: a "candidate".
// Only once those run out does a round meet the EXCLUDED pool (blank, the
// columns already picked, columns equal to EXCLUDED); it takes the pool's
// lowest column, which stays EXCLUDED, so every later round takes the same
// one: min(blank, the lowest column with a value >= EXCLUDED), reported as
// EXCLUDED - lse.
//
// So the row's picks are its best min(m, candidates) candidates in that
// order, and the best m of any set of columns lie among the best m of each
// part of it. A lane keeps its candidates as 64-bit keys in registers
// (ordered value above, ~column below: one integer compare orders them), a
// warp takes its best m in m rounds of a warp argmax over the lanes' heads
// (warp_select_keys), and the warps' picks meet in one merge of their
// lists (list_merge). The partial results of a row split over blocks are
// merged by the block(s) that arrive last (arrive, last_to_arrive): by a
// whole block (block_merge: each warp a run of the parts' picks, then one
// merge of the warps' lists) or by one warp (merge_parts). Slots too many
// for one warp's keys are cut down chunk by chunk, each chunk's best m kept
// (select_slots). Everything compares (value, column) pairs, so the result
// does not depend on the order in which parts are visited or finish. Where
// m is too large for a chunk to shrink, a merge takes rounds that each pick
// the best candidate strictly after the last pick (no list of picks), so m
// has no cap.
#pragma once

#include <climits>

#include "common.cuh"

namespace rs {
namespace topm {

constexpr float EXCLUDED = -1.0e30f;
constexpr int NONE = INT_MAX;  // the column of an empty slot, whose value is -inf

__device__ __forceinline__ bool candidate(float v, int c, int blank) {
  return c != blank && v > EXCLUDED;
}

// (v, c) comes strictly after the last pick (pv, pc) in the order
__device__ __forceinline__ bool after(float v, int c, float pv, int pc) {
  return rs::better(pv, pc, v, c);
}

// No pick yet: every candidate comes after it.
__device__ __forceinline__ float first_v() { return __int_as_float(0x7f800000); }  // +inf
constexpr int FIRST_C = -1;

// Fold the (max, Σexp(x - max)) of another set into (mx, s). The same two
// inputs give the same result in either order (IEEE addition commutes), so
// a butterfly leaves every lane with equal values.
__device__ __forceinline__ void lse_fold(float& mx, float& s, float omx, float os) {
  const float nm = fmaxf(mx, omx);
  if (nm == rs::neg_inf()) return;  // both empty (or all -inf)
  s = s * expf(mx - nm) + os * expf(omx - nm);
  mx = nm;
}

__device__ __forceinline__ void warp_lse(float& mx, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lse_fold(mx, s, __shfl_xor_sync(0xffffffffu, mx, off), __shfl_xor_sync(0xffffffffu, s, off));
}

// A float's bits as an unsigned that orders as the float does (-0 taken as
// +0, as == compares them), and back.
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// The warp's best (value, column) in the order (value desc, column asc):
// two warp reductions (redux.sync), the largest value, then the lowest
// column holding it. Every lane returns it; all 32 lanes must call.
__device__ __forceinline__ void warp_best(float& v, int& c) {
  const unsigned k = ordered(v), best = __reduce_max_sync(0xffffffffu, k);
  c = __reduce_min_sync(0xffffffffu, k == best ? c : NONE);
  v = unordered(best);
}

__device__ __forceinline__ float warp_max_f(float v) {
  return unordered(__reduce_max_sync(0xffffffffu, ordered(v)));
}

// A candidate as one 64-bit key that orders as (value desc, column asc):
// ordered(value) above, ~column below; 0 for a column that is no candidate
// (every candidate's key is above 0).
__device__ __forceinline__ unsigned long long cand_key(float v, int c, int blank) {
  return candidate(v, c, blank)
             ? (static_cast<unsigned long long>(ordered(v)) << 32) | static_cast<unsigned>(~c)
             : 0ull;
}

// The largest of a lane's N keys strictly below ``below`` (0: none), as a
// tree of depth log2 N.
template <int N>
__device__ __forceinline__ unsigned long long best_below(const unsigned long long (&key)[N],
                                                         unsigned long long below) {
  unsigned long long t[N];
#pragma unroll
  for (int q = 0; q < N; ++q) t[q] = key[q] < below ? key[q] : 0ull;
#pragma unroll
  for (int s = 1; s < N; s *= 2)
#pragma unroll
    for (int q = 0; q + s < N; q += 2 * s) t[q] = t[q] > t[q + s] ? t[q] : t[q + s];
  return t[0];
}

// The warp's best k of its lanes' candidates, each lane's N keys in
// registers: k rounds, each a warp argmax (two redux.sync) over the lanes'
// heads, a lane's head being its best key below its last pick; only the
// winning lane finds its next head. Any k. emit(i, v, c) on lane 0; returns
// the picks made, fewer than k where the candidates ran out.
template <int N, typename Emit>
__device__ __forceinline__ int warp_select_keys(const unsigned long long (&key)[N], int k,
                                                Emit emit) {
  const int lane = threadIdx.x & 31;
  unsigned long long head = best_below(key, ~0ull);
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    const unsigned hi = static_cast<unsigned>(head >> 32), lo = static_cast<unsigned>(head);
    const unsigned bhi = __reduce_max_sync(0xffffffffu, hi);
    if (bhi == 0u) return i;
    const unsigned blo = __reduce_max_sync(0xffffffffu, hi == bhi ? lo : 0u);
    if (lane == 0) emit(i, unordered(bhi), static_cast<int>(~blo));
    if (hi == bhi && lo == blo) head = best_below(key, head);
  }
  return k;
}

// One warp's best m of L <= 32 sorted lists (list l: n[l] <= m entries at
// v + l * stride and c + l * stride, its columns distinct from the other
// lists'): m rounds of a warp argmax over the lists' heads, lane l holding
// list l's. emit(i, v, c) on lane 0; returns the picks made.
template <typename Emit>
__device__ __forceinline__ int list_merge(const float* v, const int* c, const int* n, int L,
                                          int stride, int m, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int len = lane < L ? n[lane] : 0;
  const float* lv = v + lane * stride;
  const int* lc = c + lane * stride;
  int at = 0;
  float hv = len > 0 ? lv[0] : rs::neg_inf();  // the head, and the entry after it
  int hc = len > 0 ? lc[0] : NONE;
  float nv = len > 1 ? lv[1] : rs::neg_inf();
  int nc = len > 1 ? lc[1] : NONE;
#pragma unroll 1
  for (int i = 0; i < m; ++i) {
    float bv = hv;
    int bc = hc;
    warp_best(bv, bc);
    if (bc == NONE) return i;
    if (lane == 0) emit(i, bv, bc);
    if (hc == bc) {
      hv = nv;
      hc = nc;
      ++at;
      nv = at + 1 < len ? lv[at + 1] : rs::neg_inf();
      nc = at + 1 < len ? lc[at + 1] : NONE;
    }
  }
  return m;
}

constexpr int KEYS = 16;          // slots a lane holds as keys, at most
constexpr int CHUNK = 32 * KEYS;  // slots a warp holds at once

// A lane's share of the slots [base, end) (end > base, at most 32·N of
// them): slot base + lane + 32q in entry q, every load issued at once
// (clamped to the last slot), then its keys (0 past end and for an empty
// slot).
template <int N>
struct Slots {
  float v[N];
  int c[N];

  __device__ __forceinline__ void load(const float* cv, const int* cc, int base, int end) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int i = min(base + lane + 32 * q, end - 1);
      v[q] = __ldcg(cv + i);
      c[q] = __ldcg(cc + i);
    }
  }

  __device__ __forceinline__ void keys(int base, int end, unsigned long long (&key)[N]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < N; ++q)
      key[q] = base + lane + 32 * q < end && c[q] != NONE
                   ? (static_cast<unsigned long long>(ordered(v[q])) << 32) |
                         static_cast<unsigned>(~c[q])
                   : 0ull;
  }
};

// One warp's best m of the slots [base, end) (end > base, at most 32·N),
// as keys. emit(i, v, c) on lane 0; returns the picks made.
template <int N, typename Emit>
__device__ __forceinline__ int select_keys(const float* cv, const int* cc, int base, int end,
                                           int m, Emit emit) {
  Slots<N> sl;
  unsigned long long key[N];
  sl.load(cv, cc, base, end);
  sl.keys(base, end, key);
  return warp_select_keys(key, m, emit);
}

// One warp's best m of the n > CHUNK candidate slots (cv[i], cc[i]) that
// blocks of this grid wrote (read through L2, and overwritten: the caller
// needs them no more). While they exceed a chunk, each chunk's best m are
// written over the slots already read, in chunk order (chunk j's at j·m <
// its own start, so no unread slot is lost), and the chunks' picks become
// the slots. Where m >= CHUNK a chunk would not shrink: m rounds, each the
// best slot strictly after the last pick. emit(i, v, c) on lane 0; returns
// the picks made.
template <typename Emit>
__device__ int select_slots(float* cv, int* cc, int n, int m, Emit emit) {
  const int lane = threadIdx.x & 31;
  if (m >= CHUNK) {
    float pv = first_v();
    int pc = FIRST_C;
    for (int i = 0; i < m; ++i) {
      float bv = rs::neg_inf();
      int bc = NONE;
      for (int k = lane; k < n; k += 32) {
        const float v = __ldcg(cv + k);
        const int c = __ldcg(cc + k);
        if (c != NONE && after(v, c, pv, pc) && rs::better(v, c, bv, bc)) {
          bv = v;
          bc = c;
        }
      }
      warp_best(bv, bc);
      if (bc == NONE) return i;
      if (lane == 0) emit(i, bv, bc);
      pv = bv;
      pc = bc;
    }
    return m;
  }
  while (n > CHUNK) {
    int out = 0;
#pragma unroll 1
    for (int base = 0; base < n; base += CHUNK) {
      const int k = select_keys<KEYS>(cv, cc, base, min(n, base + CHUNK), m,
                                      [&](int i, float v, int c) {
                                        __stcg(cv + out + i, v);
                                        __stcg(cc + out + i, c);
                                      });
      out += k;
      __syncwarp();  // lane 0's stores are seen by the warp's next loads
    }
    if (out == 0) return 0;
    n = out;
  }
  return select_keys<KEYS>(cv, cc, 0, n, m, emit);
}

// One warp's best m of the slots [base, end) (end > base): as keys, N
// fitted to their count (a pick's cost grows with N), else select_slots.
template <typename Emit>
__device__ __forceinline__ int select_range(float* cv, int* cc, int base, int end, int m,
                                            Emit emit) {
  const int n = end - base;
  if (n <= 32) return select_keys<1>(cv, cc, base, end, m, emit);
  if (n <= 128) return select_keys<4>(cv, cc, base, end, m, emit);
  if (n <= CHUNK) return select_keys<KEYS>(cv, cc, base, end, m, emit);
  return select_slots(cv + base, cc + base, n, m, emit);
}

// One warp merges ``parts`` partial results that other blocks of this grid
// wrote: their (max, Σexp) and lowest columns into ``lse`` and ``low``
// (lanes in turn, then a fixed tree, so the result does not depend on
// which block wrote last), then the best m of their n >= 1 candidate slots:
// as keys, every load issued before any is used, where they fit a chunk,
// else select_slots (which overwrites them). emit(i, v, c) on lane 0
// (``lse`` is set first); returns the picks made.
template <typename Emit>
__device__ __forceinline__ int merge_parts(const float* pmax, const float* psum, const int* plow,
                                           int parts, float* cv, int* cc, int n, int m,
                                           float& lse, int& low, Emit emit) {
  constexpr int PU = 4;  // partials a lane loads at once
  const int lane = threadIdx.x & 31;
  const bool one = n <= CHUNK;
  Slots<KEYS> sl;
  if (one) sl.load(cv, cc, 0, n);
  float mx = rs::neg_inf(), s = 0.0f;
  low = NONE;
  for (int t0 = 0; t0 < parts; t0 += 32 * PU) {
    float pm[PU], ps[PU];
    int pl[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int t = min(t0 + lane + 32 * u, parts - 1);
      pm[u] = __ldcg(pmax + t);
      ps[u] = __ldcg(psum + t);
      pl[u] = __ldcg(plow + t);
    }
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      if (t0 + lane + 32 * u >= parts) break;
      lse_fold(mx, s, pm[u], ps[u]);
      low = min(low, pl[u]);
    }
  }
  warp_lse(mx, s);
  low = __reduce_min_sync(0xffffffffu, low);
  lse = mx + logf(s);
  if (!one) return select_slots(cv, cc, n, m, emit);
  unsigned long long key[KEYS];
  sl.keys(0, n, key);
  return warp_select_keys(key, m, emit);
}

// All NT threads of a block merge one row's ``parts`` partial results that
// other blocks of this grid wrote: warp w takes the w-th of NT/32 equal runs
// of the n slots and puts its best m (m <= LM) into the shared list
// lv/lc[w·LM ..], its length in ln[w]; meanwhile the partials' loads are in
// flight (thread t folds parts t, t + NT, ...). The (max, lowest column)
// and then Σexp meet over the block in warp order, so the result does not
// depend on which block wrote last; their barriers also publish the lists,
// and warp 0 merges them (list_merge). emit(i, v, c) on thread 0, ``lse``
// set first. Returns the picks made, with lse and low, on every thread.
// sh_f and sh_i hold NT/32 entries. Five barriers.
template <int NT, int LM, typename Emit>
__device__ int block_merge(const float* pmax, const float* psum, const int* plow, int parts,
                           float* cv, int* cc, int n, int m, float* lv, int* lc, int* ln,
                           float* sh_f, int* sh_i, float& lse, int& low, Emit emit) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = threadIdx.x;
  const float pm0 = t0 < parts ? __ldcg(pmax + t0) : rs::neg_inf();
  const float ps0 = t0 < parts ? __ldcg(psum + t0) : 0.0f;
  const int pl0 = t0 < parts ? __ldcg(plow + t0) : NONE;
  const int b = int(static_cast<long long>(n) * warp / NW);
  const int e = int(static_cast<long long>(n) * (warp + 1) / NW);
  int kw = 0;
  if (e > b)
    kw = select_range(cv, cc, b, e, m, [&](int i, float v, int c) {
      lv[warp * LM + i] = v;
      lc[warp * LM + i] = c;
    });
  if (lane == 0) ln[warp] = kw;
  float mx = pm0;
  low = pl0;
  for (int t = t0 + NT; t < parts; t += NT) {
    mx = fmaxf(mx, __ldcg(pmax + t));
    low = min(low, __ldcg(plow + t));
  }
  mx = warp_max_f(mx);
  low = __reduce_min_sync(0xffffffffu, low);
  if (lane == 0) {
    sh_f[warp] = mx;
    sh_i[warp] = low;
  }
  __syncthreads();  // also publishes the lists
  mx = sh_f[0];
  low = sh_i[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    mx = fmaxf(mx, sh_f[w]);
    low = min(low, sh_i[w]);
  }
  float s = pm0 != rs::neg_inf() ? ps0 * expf(pm0 - mx) : 0.0f;
  for (int t = t0 + NT; t < parts; t += NT) {
    const float pm = __ldcg(pmax + t);
    if (pm != rs::neg_inf()) s += __ldcg(psum + t) * expf(pm - mx);
  }
  s = rs::warp_sum(s);
  __syncthreads();  // sh_f is read
  if (lane == 0) sh_f[warp] = s;
  __syncthreads();
  s = sh_f[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += sh_f[w];
  lse = mx + logf(s);
  if (warp == 0) {
    const int k = list_merge(lv, lc, ln, NW, LM, m, emit);
    if (lane == 0) sh_i[0] = k;
  }
  __syncthreads();
  const int k = sh_i[0];
  __syncthreads();  // sh_i is read: the block may merge again
  return k;
}

// A grid's blocks arrive once their partial results are written; the last
// B to arrive merge them. ticket[0] counts this call's arrivals, ticket[1]
// the calls ended: the last arrival resets the one and advances the other.
// Called by one thread of a block after a barrier over its writes; returns
// its arrival (0 .. parts - 1) and the calls ended before it, ``epoch``.
// The acquire-release add publishes the block's writes and, in the last
// block, makes every other block's visible.
__device__ __forceinline__ int arrive(unsigned* ticket, int parts, unsigned& epoch) {
  unsigned e, old;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(e) : "l"(ticket + 1) : "memory");
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  if (old == unsigned(parts - 1)) {
    ticket[0] = 0u;
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(ticket + 1), "r"(e + 1) : "memory");
  }
  epoch = e;
  return static_cast<int>(old);
}

// Until the call that ``epoch`` saw has ended (the last arrival advanced
// ticket[1]); then every block's writes are visible to the caller.
__device__ __forceinline__ void wait_end(const unsigned* ticket, unsigned epoch) {
  unsigned e;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(e) : "l"(ticket + 1) : "memory");
    if (e == epoch) __nanosleep(32);
  } while (e == epoch);
}

// Called by every thread of a block once its partial results are written:
// true in the one block of the ``parts`` counted at ``*ticket`` that arrives
// last, which also resets the counter for the next call (stream order makes
// that visible to it). The barrier orders the block's writes before thread
// 0's ticket, whose acquire-release add publishes them and, in the last
// block, makes every other block's visible. Two barriers; ``flag`` is a
// shared int.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, int parts, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
    const bool last = old == unsigned(parts - 1);
    if (last) *ticket = 0u;
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// A row's results after its picks: lp_blank, and past the k picks (written
// by the caller) the EXCLUDED pool's lowest column. For the threads of one
// warp (lane 0 writes lp_blank) or of a block.
__device__ __forceinline__ void finish_row(float* lp_blank, float* top_lp, int* top_tok, int row,
                                           int m, int k, float lse, float x_blank, int low,
                                           int blank, int first, int step) {
  if (first == 0) lp_blank[row] = x_blank - lse;
  for (int j = k + first; j < m; j += step) {
    top_lp[size_t(row) * m + j] = EXCLUDED - lse;
    top_tok[size_t(row) * m + j] = min(blank, low);
  }
}

}  // namespace topm
}  // namespace rs
