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
// Any m >= 1, V, H and J: the depth is staged in chunks (decode_step.cuh)
// and the top-m is picked in rounds (topm.cuh).
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
//    Wo R times) stages z's row tile in shared memory and computes its
//    [16, 32] logits; then one warp per row takes the tile's max and sum of
//    exponentials, the blank logit where the tile holds it, its lowest
//    column >= -1e30, and the tile's top-m candidates (topm.cuh: blank and
//    values <= -1e30 excluded) by warp argmax passes, each picked lane
//    leaving the pool. Wo is read once a row tile.
// 3. merge: topm.cuh's merge_kernel, a block per row, combines the tiles'
//    (max, sum) into the log-sum-exp and picks the row's top-m from the
//    tiles' candidates in rounds, the lowest column winning ties. Every
//    global top-m column is among its own tile's top-m under the same
//    order, so the candidates suffice.
// The [R, V] logits never reach device memory (the unfused chain writes and
// reads them three times).

#include "decode_step.cuh"
#include "topm.cuh"

namespace {

using namespace rs::step;
using namespace rs::topm;

constexpr int NW = NT / NC;  // warps
constexpr int MERGE_NT = 256;

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
  float* a_s = reinterpret_cast<float*>(smem4);  // [min(H, KC)][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float o_s[RT * NC];
  const int j0 = blockIdx.x * NC;
  const int col = j0 + threadIdx.x % NC;
  for (int r0 = 0; r0 < R; r0 += RT) {
    dot(a_s, dec, H, nullptr, 0, R, r0, wp, nullptr, J, col, col < J, red, o_s);
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
                  float* __restrict__ psum, float* __restrict__ pblank, int* __restrict__ plow,
                  float* __restrict__ cval, int* __restrict__ cidx, int R, int J, int V, int m,
                  int blank) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [min(J, KC)][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float o_s[RT * NC];
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int lane = threadIdx.x % NC, warp = threadIdx.x / NC;
  const int col = tile * NC + lane;
  const bool valid = col < V;
  const float b = valid ? bo[col] : 0.0f;
  for (int r0 = 0; r0 < R; r0 += RT) {
    dot(a_s, z, J, nullptr, 0, R, r0, wo, nullptr, V, col, valid, red, o_s);
    for (int r = warp; r < RT && r0 + r < R; r += NW) {
      const int row = r0 + r;
      const float x = valid ? o_s[r * NC + lane] + b : rs::neg_inf();
      const float tmax = rs::warp_max(x);
      const float tsum = rs::warp_sum(valid ? expf(x - tmax) : 0.0f);
      const int low = rs::warp_min(valid && x >= EXCLUDED ? col : INT_MAX);
      const size_t part = size_t(row) * tiles + tile;
      if (lane == 0) {
        pmax[part] = tmax;
        psum[part] = tsum;
        plow[part] = low;
      }
      if (valid && col == blank) pblank[row] = x;
      const bool cand = valid && candidate(x, col, blank);
      float v = cand ? x : rs::neg_inf();
      int i = cand ? col : INT_MAX;
      for (int p = 0; p < m; ++p) {  // past the tile's candidates: (-inf, INT_MAX)
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

}  // namespace

// Scratch the caller allocates: f32 of R·J + R·(2·tiles + 1 + tiles·m)
// floats, i32 of R·tiles·(m + 1), with tiles = ceil(V / 32).
extern "C" int rs_joint_topm(const void* w_pred, const void* b_pred, const void* w_out,
                             const void* b_out, const void* enc, const void* dec, void* f32,
                             void* i32, void* lp_blank, void* top_lp, void* top_tok, int R,
                             int H, int J, int V, int m, int blank, int act, void* stream) {
  if (R <= 0 || H <= 0 || J <= 0 || V <= 0 || m < 1 || blank < 0 || blank >= V || act < RELU ||
      act > SIGMOID)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_z = stage_bytes(H), smem_t = stage_bytes(J);
  int err = allow_smem(joint_hidden_kernel, smem_z);
  if (err == 0) err = allow_smem(joint_tile_kernel, smem_t);
  if (err != 0) return err;
  const int tiles = (V + NC - 1) / NC;
  float* z = static_cast<float*>(f32);
  float* pmax = z + size_t(R) * J;
  float* psum = pmax + size_t(R) * tiles;
  float* pblank = psum + size_t(R) * tiles;
  float* cval = pblank + R;
  int* plow = static_cast<int*>(i32);
  int* cidx = plow + size_t(R) * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  joint_hidden_kernel<<<(J + NC - 1) / NC, NT, smem_z, s>>>(
      static_cast<const float*>(enc), static_cast<const float*>(dec),
      static_cast<const float*>(w_pred), static_cast<const float*>(b_pred), z, R, H, J, act);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  joint_tile_kernel<<<tiles, NT, smem_t, s>>>(z, static_cast<const float*>(w_out),
                                              static_cast<const float*>(b_out), pmax, psum,
                                              pblank, plow, cval, cidx, R, J, V, m, blank);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  merge_kernel<MERGE_NT><<<R, MERGE_NT, 0, s>>>(pmax, psum, plow, pblank, cval, cidx,
                                                static_cast<float*>(lp_blank),
                                                static_cast<float*>(top_lp),
                                                static_cast<int*>(top_tok), tiles, m, blank);
  RS_RETURN_LAST_ERROR();
}
