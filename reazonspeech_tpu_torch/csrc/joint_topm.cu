// Fused transducer joint + log-softmax + blank split + exact top-m, the whole
// per-step tail of the beam decoders.
//
// Replaces: reazonspeech_tpu/ops/beam_topk.py, joint_topm (a Pallas TPU
// kernel). Contract, for R rows, in fp32 (the only dtype the beam decoders
// pass: compute_dtype="float32"):
//   z      = act(enc + (dec · Wp + bp))      enc [R, J], dec [R, H], Wp [H, J]
//   logits = z · Wo + bo                     Wo [J, V]
//   then topm_logsoftmax's body (beam_topk.cu): lse over all V columns,
//   lp_blank = logits[blank] - lse, and the m largest labels, blank
//   excluded, as logits - lse, ties to the LOWEST column (lax.top_k's order).
//
// What bounds it on the H100: at the decoders' shapes (nemo ALSD: R = 16,
// H = J = 640, V = 3,001; espnet Graves: R = 4, H = J = 256, V = 2,182; k2
// ALSD: R = 16, H = J = 512, V = 2,179) one call must read Wo and Wp once
// (9.3, 2.5 and 5.5 MB in fp32: 2.8, 0.75 and 1.6 µs at HBM rate, less from
// L2, which holds them) and does 2·R·J·(H + V) flops (75, 5 and 44
// million). At these R it is bound by latency: three launches and each
// block's serial k loop.
//
// Design, three launches on the caller's stream:
// 1. z: one block per 32 columns of J computes z for all rows with
//    decode_step.cuh's product into a small [R, J] scratch.
// 2. tiles: one block per 32 columns of V (94 blocks at nemo's V: the whole
//    card, where one block per row would leave 116 of 132 SMs idle and read
//    Wo R times) holds z's row tile in shared memory and computes its
//    [16, 32] logits; then one warp per row takes the tile's max and sum of
//    exponentials, the blank logit where the tile holds it, and the tile's
//    top-m (value, column) by m warp argmax passes (blank reads as -1e30,
//    as the JAX kernel rewrites it). Wo is read once a row tile.
// 3. merge: one warp per row combines the tiles' (max, sum) into the
//    log-sum-exp and merges the tiles' sorted candidate lists into the
//    row's top-m, the lowest column winning ties. Every global top-m column
//    is among its own tile's top-m under the same order, so the candidates
//    suffice.
// The [R, V] logits never reach device memory (the unfused chain writes and
// reads them three times).

#include <climits>

#include "decode_step.cuh"

namespace {

using namespace rs::step;

constexpr int MAX_M = 32;
constexpr int MAX_TILES_PER_LANE = 48;  // V <= 32 lanes x 48 tiles x 32 columns = 49,152
constexpr int NW = NT / NC;  // warps
constexpr float EXCLUDED = -1.0e30f;

enum Act { RELU = 0, TANH = 1, SIGMOID = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == RELU) return fmaxf(v, 0.0f);
  if (act == TANH) return tanhf(v);
  return rs::sigmoid(v);
}

__global__ void __launch_bounds__(NT)
joint_hidden_kernel(const float* __restrict__ enc, const float* __restrict__ dec,
                    const float* __restrict__ wp, const float* __restrict__ bp,
                    float* __restrict__ z, int R, int H, int J, int act) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [H][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float o_s[RT * NC];
  const int j0 = blockIdx.x * NC;
  const int col = j0 + threadIdx.x % NC;
  for (int r0 = 0; r0 < R; r0 += RT) {
    stage(a_s, dec, H, nullptr, 0, R, r0);
    dot(a_s, wp, H, nullptr, 0, J, col, col < J, red, o_s);
    for (int idx = threadIdx.x; idx < RT * NC; idx += NT) {
      const int row = r0 + idx / NC, j = j0 + idx % NC;
      if (row < R && j < J) {
        const size_t at = size_t(row) * J + j;
        z[at] = activate(enc[at] + (o_s[idx] + bp[j]), act);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
joint_tile_kernel(const float* __restrict__ z, const float* __restrict__ wo,
                  const float* __restrict__ bo, float* __restrict__ pmax,
                  float* __restrict__ psum, float* __restrict__ pblank,
                  float* __restrict__ cval, int* __restrict__ cidx, int R, int J, int V, int m,
                  int blank) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [J][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float o_s[RT * NC];
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int lane = threadIdx.x % NC, warp = threadIdx.x / NC;
  const int col = tile * NC + lane;
  const bool valid = col < V;
  const float b = valid ? bo[col] : 0.0f;
  for (int r0 = 0; r0 < R; r0 += RT) {
    stage(a_s, z, J, nullptr, 0, R, r0);
    dot(a_s, wo, J, nullptr, 0, V, col, valid, red, o_s);
    for (int r = warp; r < RT && r0 + r < R; r += NW) {
      const int row = r0 + r;
      const float x = valid ? o_s[r * NC + lane] + b : rs::neg_inf();
      const float tmax = rs::warp_max(x);
      const float tsum = rs::warp_sum(valid ? expf(x - tmax) : 0.0f);
      const size_t part = size_t(row) * tiles + tile;
      if (lane == 0) {
        pmax[part] = tmax;
        psum[part] = tsum;
      }
      if (valid && col == blank) pblank[row] = x;
      float v = !valid ? rs::neg_inf() : (col == blank ? EXCLUDED : x);
      int i = valid ? col : INT_MAX;
      for (int p = 0; p < m; ++p) {
        float bv = v;
        int bi = i;
        rs::warp_argmax(bv, bi);
        if (lane == 0) {
          cval[part * m + p] = bv;
          cidx[part * m + p] = bi;
        }
        if (i == bi) {  // the lane that holds the pick leaves the pool
          v = rs::neg_inf();
          i = INT_MAX;
        }
      }
    }
    __syncthreads();
  }
}

// One warp per row. Each tile's candidates are already in top-m order, so
// the row's top-m is a merge of sorted lists: m times, every lane offers the
// best head among its tiles, the warp takes the best offer (value, then the
// lowest column) and its lane advances that tile's head.
__global__ void __launch_bounds__(32)
joint_merge_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
                   const float* __restrict__ pblank, const float* __restrict__ cval,
                   const int* __restrict__ cidx, float* __restrict__ lp_blank,
                   float* __restrict__ top_lp, int* __restrict__ top_tok, int tiles, int m) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const float* mx_row = pmax + size_t(row) * tiles;
  const float* sum_row = psum + size_t(row) * tiles;
  float mx = rs::neg_inf();
  for (int t = lane; t < tiles; t += 32) mx = fmaxf(mx, mx_row[t]);
  mx = rs::warp_max(mx);
  float s = 0.0f;
  for (int t = lane; t < tiles; t += 32) s += sum_row[t] * expf(mx_row[t] - mx);
  const float lse = mx + logf(rs::warp_sum(s));
  if (lane == 0) lp_blank[row] = pblank[row] - lse;

  const float* v_row = cval + size_t(row) * tiles * m;
  const int* i_row = cidx + size_t(row) * tiles * m;
  int head[MAX_TILES_PER_LANE] = {};  // next candidate of tile lane + 32 q
  for (int p = 0; p < m; ++p) {
    float bv = rs::neg_inf();
    int bi = INT_MAX, bq = 0;
    for (int q = 0, t = lane; t < tiles; ++q, t += 32) {
      if (head[q] < m && rs::better(v_row[t * m + head[q]], i_row[t * m + head[q]], bv, bi)) {
        bv = v_row[t * m + head[q]];
        bi = i_row[t * m + head[q]];
        bq = q;
      }
    }
    const float mine_v = bv;
    const int mine_i = bi;
    rs::warp_argmax(bv, bi);
    // the offering lane (columns are unique) moves past the pick
    if (mine_i == bi && mine_v == bv && bi != INT_MAX) ++head[bq];
    if (lane == 0) {
      top_lp[size_t(row) * m + p] = bv - lse;
      top_tok[size_t(row) * m + p] = bi;
    }
  }
}

}  // namespace

// Scratch the caller allocates: f32 of R·J + R·(2·tiles + 1 + tiles·m)
// floats, i32 of R·tiles·m, with tiles = ceil(V / 32).
extern "C" int rs_joint_topm(const void* w_pred, const void* b_pred, const void* w_out,
                             const void* b_out, const void* enc, const void* dec, void* f32,
                             void* i32, void* lp_blank, void* top_lp, void* top_tok, int R,
                             int H, int J, int V, int m, int blank, int act, void* stream) {
  const size_t smem_z = stage_bytes(H), smem_t = stage_bytes(J);
  if (R <= 0 || H <= 0 || J <= 0 || H % 4 || J % 4 || m < 1 || m > MAX_M || m > V - 1 ||
      V > 32 * MAX_TILES_PER_LANE * NC || blank < 0 ||
      blank >= V || act < RELU || act > SIGMOID || smem_z > MAX_STAGE_BYTES ||
      smem_t > MAX_STAGE_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_smem(joint_hidden_kernel, smem_z);
  if (err == 0) err = allow_smem(joint_tile_kernel, smem_t);
  if (err != 0) return err;
  const int tiles = (V + NC - 1) / NC;
  float* z = static_cast<float*>(f32);
  float* pmax = z + size_t(R) * J;
  float* psum = pmax + size_t(R) * tiles;
  float* pblank = psum + size_t(R) * tiles;
  float* cval = pblank + R;
  int* cidx = static_cast<int*>(i32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  joint_hidden_kernel<<<(J + NC - 1) / NC, NT, smem_z, s>>>(
      static_cast<const float*>(enc), static_cast<const float*>(dec),
      static_cast<const float*>(w_pred), static_cast<const float*>(b_pred), z, R, H, J, act);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  joint_tile_kernel<<<tiles, NT, smem_t, s>>>(z, static_cast<const float*>(w_out),
                                              static_cast<const float*>(b_out), pmax, psum,
                                              pblank, cval, cidx, R, J, V, m, blank);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  joint_merge_kernel<<<R, 32, 0, s>>>(pmax, psum, pblank, cval, cidx,
                                      static_cast<float*>(lp_blank), static_cast<float*>(top_lp),
                                      static_cast<int*>(top_tok), tiles, m);
  RS_RETURN_LAST_ERROR();
}
