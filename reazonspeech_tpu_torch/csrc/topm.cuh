// Exact top-m in lax.top_k's order, picked in rounds, and the merge of
// per-tile partial results; shared by beam_topk.cu and joint_topm.cu
// (plain C interface, no PyTorch headers).
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
// So a round needs no list of the columns picked so far, only the last
// pick: it takes the best candidate strictly after that pick in the order.
// m has no cap, and a tile's partial result is its own top-m candidates
// (each of the row's top-m candidates is among its tile's), its max and
// Σexp, its lowest column with a value >= EXCLUDED, and the blank logit
// where it holds blank.
#pragma once

#include <climits>

#include "common.cuh"

namespace rs {
namespace topm {

constexpr float EXCLUDED = -1.0e30f;

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

}  // namespace topm
}  // namespace rs

namespace {  // each source that launches it has its own copy

// The merge of ``tiles`` partial results per row, one block of NT threads
// per row (blockIdx.x): pmax, psum, plow [R, tiles]; pblank [R]; cval, cidx
// [R, tiles, m] (a tile's candidates, padded with (-inf, INT_MAX)). A tile
// of -inf (max -inf) adds nothing to Σexp. Writes lp_blank [R], top_lp and
// top_tok [R, m].
template <int NT>
__global__ void __launch_bounds__(NT)
merge_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
             const int* __restrict__ plow, const float* __restrict__ pblank,
             const float* __restrict__ cval, const int* __restrict__ cidx,
             float* __restrict__ lp_blank, float* __restrict__ top_lp, int* __restrict__ top_tok,
             int tiles, int m, int blank) {
  __shared__ float s_f[NT / 32];
  __shared__ int s_i[NT / 32];
  const int row = blockIdx.x;
  const size_t part = size_t(row) * tiles;
  float mx = rs::neg_inf();
  int low = INT_MAX;
  for (int t = threadIdx.x; t < tiles; t += NT) {
    mx = fmaxf(mx, pmax[part + t]);
    low = min(low, plow[part + t]);
  }
  mx = rs::block_max<NT>(mx, s_f);
  low = rs::block_min<NT>(low, s_i);
  float s = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += NT) {
    const float tm = pmax[part + t];
    if (tm != rs::neg_inf()) s += psum[part + t] * expf(tm - mx);
  }
  const float lse = mx + logf(rs::block_sum<NT>(s, s_f));
  if (threadIdx.x == 0) lp_blank[row] = pblank[row] - lse;

  const float* v_row = cval + part * m;
  const int* i_row = cidx + part * m;
  const int slots = tiles * m;
  float pv = rs::topm::first_v();
  int pc = rs::topm::FIRST_C;
  int i = 0;
  for (; i < m; ++i) {
    float bv = rs::neg_inf();
    int bi = INT_MAX;
    for (int k = threadIdx.x; k < slots; k += NT) {
      const float v = v_row[k];
      const int c = i_row[k];
      if (c != INT_MAX && rs::topm::after(v, c, pv, pc) && rs::better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    rs::block_argmax<NT>(bv, bi, s_f, s_i);
    if (bi == INT_MAX) break;  // the candidates ran out
    if (threadIdx.x == 0) {
      top_lp[size_t(row) * m + i] = bv - lse;
      top_tok[size_t(row) * m + i] = bi;
    }
    pv = bv;
    pc = bi;
  }
  for (int j = i + threadIdx.x; j < m; j += NT) {  // the EXCLUDED pool's lowest column
    top_lp[size_t(row) * m + j] = rs::topm::EXCLUDED - lse;
    top_tok[size_t(row) * m + j] = min(blank, low);
  }
}

}  // namespace
