// Fused transducer joint + log-softmax + blank split + exact top-m, the whole
// per-step tail of the beam decoders.
//
// Replaces: reazonspeech_tpu/ops/beam_topk.py, joint_topm (a Pallas TPU
// kernel). Contract, for R rows, in fp32 (the only dtype the beam decoders
// pass: compute_dtype="float32"), plain FMA and no TF32 (TF32 flips the
// decoders' near-ties):
//   z      = act(enc + (dec · Wp + bp))      enc [R, J], dec [R, H], Wp [H, J]
//   logits = z · Wo + bo                     Wo [J, V]
//   then topm_logsoftmax's body (beam_topk.cu): lse over all V columns,
//   lp_blank = logits[blank] - lse, and the m largest labels, blank
//   excluded, as logits - lse, ties to the LOWEST column (lax.top_k's order).
// Any m >= 1, V, H and J: the depth is staged in chunks (decode_step.cuh)
// and the top-m is merged from keys (topm.cuh).
//
// What bounds it on the H100: at the decoders' shapes (nemo ALSD: R = 16,
// H = J = 640, V = 3,001; espnet Graves: R = 4, H = J = 256, V = 2,182; k2
// ALSD: R = 16, H = J = 512, V = 2,179) one call must read Wo and Wp once
// (9.3, 2.5 and 5.5 MB in fp32: 2.8, 0.75 and 1.6 µs at HBM rate, less from
// L2, which holds them) and does 2·R·J·(H + V) flops (75, 5 and 44
// million). At these R it is bound by latency: the launches and each
// block's serial k loop.
//
// Design, two launches on the caller's stream:
// 1. z: a cluster of 4 blocks per 16 columns of J (160 blocks at nemo's J,
//    where a block per 32 columns would leave 112 of 132 SMs idle), block p
//    of it a quarter of the depth: each reads its quarter of Wp's 16
//    columns (16-byte loads) and of dec, its lanes split that quarter, a
//    warp reduce-scatter joins them and the quarters meet through
//    distributed shared memory; then z = act(enc + (s + bp)) into the
//    scratch ([R, J]).
// 2. tiles: one block per 32 columns of V (94 blocks at nemo's V: the whole
//    card, where one block per row would leave 116 of 132 SMs idle and read
//    Wo R times) stages z's row tile in shared memory and computes its
//    [16, 32] logits; then one warp per row takes the tile's max and sum of
//    exponentials, the blank logit where the tile holds it, its lowest
//    column >= -1e30, and the tile's best min(m, 32) candidates (topm.cuh's
//    warp_select_keys, a lane's key being its own column). Wo is read once
//    a row tile.
// 3. No merge launch: the last B = min(R, tiles, 16) tile blocks to finish
//    (an atomic ticket the wrapper keeps per device and stream) merge the
//    rows, block j rows j, j + B, ..., each row over the whole block
//    (topm.cuh's block_merge: each warp a run of the tiles' candidates as
//    keys, then one merge of the warps' lists; the tiles' (max, Σexp) in a
//    fixed order, so the result does not depend on which block finished
//    last). All but the last of them wait for it (B - 1 blocks spinning,
//    each on an SM of its own, while at most B - 1 others finish). Every
//    global top-m column is among its own tile's top-m under the same
//    order, so the candidates suffice.
// The [R, V] logits never reach device memory (the unfused chain writes and
// reads them three times).

#include <cooperative_groups.h>

#include "decode_step.cuh"
#include "topm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rs::step;
using namespace rs::topm;

constexpr int NW = NT / NC;  // warps
constexpr int LM = 40;       // the largest m merged over a whole block (its lists in shared memory)
constexpr int MB = 16;       // merging blocks, at most

enum Act { RELU = 0, TANH = 1, SIGMOID = 2 };

// launch 1
constexpr int ZT = 128;  // threads of a block: 4 warps of 4 rows
constexpr int ZC = 16;   // columns of J a cluster
constexpr int ZQ = 4;    // blocks of a cluster, a quarter of the depth each
constexpr int ZR = 16;   // rows a pass
constexpr int ZU = 10;   // depth rows a lane keeps in flight

__device__ __forceinline__ float activate(float v, int act) {
  if (act == RELU) return fmaxf(v, 0.0f);
  if (act == TANH) return tanhf(v);
  return rs::sigmoid(v);
}

// The scratch, 32-bit words: z [R, J]; pmax, psum, plow [R, T]; pblank
// [R]; pv, pc [R, T · K] (tile t of row r at r · T · K + t · K), for T
// tiles of NC columns and K = min(m, NC).
struct Scratch {
  float* z;
  float* pmax;
  float* psum;
  int* plow;
  float* pblank;
  float* pv;
  int* pc;
  __host__ __device__ Scratch(void* words, int R, int J, int T, int K) {
    const size_t rt = size_t(R) * T;
    z = static_cast<float*>(words);
    pmax = z + size_t(R) * J;
    psum = pmax + rt;
    plow = reinterpret_cast<int*>(psum + rt);
    pblank = psum + 2 * rt;
    pv = pblank + R;
    pc = reinterpret_cast<int*>(pv + rt * K);
  }
  __host__ __device__ static size_t words(int R, int J, int T, int K) {
    return size_t(R) * (size_t(J) + 3 * size_t(T) + 1 + 2 * size_t(T) * K);
  }
};

__host__ __device__ inline int tiles_of(int V) { return (V + NC - 1) / NC; }
__host__ __device__ inline int slots_of(int m) { return m < NC ? m : NC; }

// Sums over the 8 lanes of a warp that share lane bits 0-1 of 16 values a
// lane, scattered: after it lane l holds the sums of values 2(l >> 2) and
// 2(l >> 2) + 1 in v[0], v[1]. Each level trades half of a lane's values
// with its partner: 14 shuffles, where a butterfly per value takes 48.
__device__ __forceinline__ void reduce_scatter_8(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16, n = 8; o >= 4; o >>= 1, n >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      const float keep = upper ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

// launch 1: z[r, j] = act(enc[r, j] + (Σ_k dec[r, k] Wp[k, j] + bp[j])). A
// cluster of ZQ blocks owns 16 columns of J; block rank p of it a quarter
// of the depth, so each block reads only its quarter of Wp's columns and of
// dec. Warp w takes rows
// 4w .. 4w + 3 (16 a pass); lane l its column quad l & 3 and the depth rows
// k = l >> 2, + 8, ... of the quarter: one 16-byte load of Wp a row where J
// is a multiple of 4 (ALIGNED), else 4 single ones, ZU rows in flight, every
// load issued unconditionally (clamped to the arrays). The 8 depth slices
// of a warp meet in a reduce-scatter, the cluster's quarters through
// distributed shared memory, each summed in a fixed order.
template <bool ALIGNED>
__global__ void __cluster_dims__(ZQ, 1, 1) __launch_bounds__(ZT)
joint_z_kernel(const float* __restrict__ enc, const float* __restrict__ dec,
               const float* __restrict__ wp, const float* __restrict__ bp, float* __restrict__ z,
               int R, int H, int J, int act) {
  __shared__ float s_part[ZR][ZC];  // this block's sums over its quarter
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, ks = lane >> 2;
  const int j0 = blockIdx.x / ZQ * ZC;
  const int hq = (H + ZQ - 1) / ZQ, d0 = rank * hq, d1 = min(H, d0 + hq);
  const size_t total = size_t(H) * J, last = total - 1;
  for (int r0 = 0; r0 < R; r0 += ZR) {
    const int rb = r0 + 4 * warp;
    float acc[16];  // [row rb + i][column j0 + 4q + c] at 4i + c
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    for (int kb = d0 + ks; kb < d1; kb += 8 * ZU) {
      float4 w[ZU];
      float d[ZU][4];
#pragma unroll
      for (int u = 0; u < ZU; ++u) {
        const size_t k = max(0, min(kb + 8 * u, d1 - 1)), f = k * size_t(J) + j0 + 4 * q;
        if constexpr (ALIGNED) {  // total is a multiple of 4: the last whole float4 is safe
          w[u] = __ldg(reinterpret_cast<const float4*>(wp + (f + 4 <= total ? f : total - 4)));
        } else {
          float t[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = __ldg(wp + (f + e < last ? f + e : last));
          w[u] = make_float4(t[0], t[1], t[2], t[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) d[u][i] = __ldg(dec + size_t(min(rb + i, R - 1)) * H + k);
      }
#pragma unroll
      for (int u = 0; u < ZU; ++u) {
        const bool ok = kb + 8 * u < d1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ok ? d[u][i] : 0.0f;
          acc[4 * i + 0] = fmaf(a, w[u].x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(a, w[u].y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(a, w[u].z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(a, w[u].w, acc[4 * i + 3]);
        }
      }
    }
    reduce_scatter_8(acc);  // values 2ks, 2ks + 1: row ks / 2, columns 2(ks % 2) + 0, 1
    s_part[4 * warp + ks / 2][4 * q + 2 * (ks % 2)] = acc[0];
    s_part[4 * warp + ks / 2][4 * q + 2 * (ks % 2) + 1] = acc[1];
    cluster.sync();  // every quarter's sums are in
    if (threadIdx.x < 4 * ZC) {  // rank p sums rows 4p .. 4p + 3 of the pass
      const int i = 4 * rank + threadIdx.x / ZC, c = threadIdx.x % ZC;
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < ZQ; ++p) sum += cluster.map_shared_rank(&s_part[0][0], p)[i * ZC + c];
      const int r = r0 + i, j = j0 + c;
      if (r < R && j < J) {
        const size_t at = size_t(r) * J + j;
        z[at] = activate(enc[at] + (sum + bp[j]), act);
      }
    }
    cluster.sync();  // the quarters are read: s_part may change, the blocks may end
  }
}

__global__ void __launch_bounds__(NT)
joint_tile_kernel(const float* __restrict__ wo, const float* __restrict__ bo, void* scratch,
                  unsigned* __restrict__ ticket, float* __restrict__ lp_blank,
                  float* __restrict__ top_lp, int* __restrict__ top_tok, int R, int J, int V,
                  int m, int blank) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [min(J, KC)][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float o_s[RT * NC];
  __shared__ float s_lv[NW * LM], s_f[NW];
  __shared__ int s_lc[NW * LM], s_ln[NW], s_i[NW], s_arrival;
  const int tiles = gridDim.x, tile = blockIdx.x, K = slots_of(m);
  const Scratch ws(scratch, R, J, tiles, K);
  const int lane = threadIdx.x % NC, warp = threadIdx.x / NC;
  const int col = tile * NC + lane;
  const bool valid = col < V;
  const float b = valid ? bo[col] : 0.0f;
  for (int r0 = 0; r0 < R; r0 += RT) {
    dot(a_s, ws.z, J, nullptr, 0, R, r0, wo, nullptr, V, col, valid, red, o_s);
    for (int r = warp; r < RT && r0 + r < R; r += NW) {
      const int row = r0 + r;
      const float x = valid ? o_s[r * NC + lane] + b : rs::neg_inf();
      const float tmax = warp_max_f(x);
      const float tsum = rs::warp_sum(valid && tmax != rs::neg_inf() ? expf(x - tmax) : 0.0f);
      const int low = __reduce_min_sync(0xffffffffu, valid && x >= EXCLUDED ? col : NONE);
      const size_t part = size_t(row) * tiles + tile;
      if (lane == 0) {
        ws.pmax[part] = tmax;
        ws.psum[part] = tsum;
        ws.plow[part] = low;
      }
      if (valid && col == blank) ws.pblank[row] = x;
      float* cv = ws.pv + part * K;
      int* cc = ws.pc + part * K;
      const unsigned long long key[1] = {valid ? cand_key(x, col, blank) : 0ull};
      const int k = warp_select_keys(key, K, [&](int i, float v, int c) {
        cv[i] = v;
        cc[i] = c;
      });
      for (int j = k + lane; j < K; j += 32) {  // past the tile's candidates: empty slots
        cv[j] = rs::neg_inf();
        cc[j] = NONE;
      }
    }
    __syncthreads();
  }
  // the partials are written (the loop's last barrier): the last B blocks
  // to arrive merge the rows, block j rows j, j + B, ...
  const int B = min(min(R, tiles), MB);
  if (threadIdx.x == 0) {
    unsigned epoch;
    const int a = arrive(ticket, tiles, epoch);
    if (a >= tiles - B && a != tiles - 1) wait_end(ticket, epoch);
    s_arrival = a;
  }
  __syncthreads();
  const int j = s_arrival - (tiles - B);
  if (j < 0) return;
  for (int row = j; row < R; row += B) {
    const size_t first = size_t(row) * tiles;
    const float x_blank = __ldcg(ws.pblank + row);
    float lse;
    int low;
    auto emit = [&](int i, float v, int c) {
      top_lp[size_t(row) * m + i] = v - lse;
      top_tok[size_t(row) * m + i] = c;
    };
    if (m <= LM) {
      const int k = block_merge<NT, LM>(ws.pmax + first, ws.psum + first, ws.plow + first, tiles,
                                        ws.pv + first * K, ws.pc + first * K, tiles * K, m, s_lv,
                                        s_lc, s_ln, s_f, s_i, lse, low, emit);
      finish_row(lp_blank, top_lp, top_tok, row, m, k, lse, x_blank, low, blank, threadIdx.x, NT);
    } else if (warp == 0) {  // lists too long for shared memory: one warp
      const int k = merge_parts(ws.pmax + first, ws.psum + first, ws.plow + first, tiles,
                                ws.pv + first * K, ws.pc + first * K, tiles * K, m, lse, low,
                                emit);
      finish_row(lp_blank, top_lp, top_tok, row, m, k, lse, x_blank, low, blank, lane, 32);
    }
  }
}

}  // namespace

// The workspace a call needs: returns the 32-bit words of scratch and sets
// *tickets to the counters (2), which must be zero before the first call
// and are the kernel's alone from then on.
extern "C" long long rs_joint_workspace(int R, int J, int V, int m, int* tickets) {
  *tickets = 2;
  if (R <= 0 || J <= 0 || V <= 0 || m < 1) return 0;
  return static_cast<long long>(Scratch::words(R, J, tiles_of(V), slots_of(m)));
}

extern "C" int rs_joint_topm(const void* w_pred, const void* b_pred, const void* w_out,
                             const void* b_out, const void* enc, const void* dec, void* scratch,
                             void* tickets, void* lp_blank, void* top_lp, void* top_tok, int R,
                             int H, int J, int V, int m, int blank, int act, void* stream) {
  if (R <= 0 || H <= 0 || J <= 0 || V <= 0 || m < 1 || blank < 0 || blank >= V || act < RELU ||
      act > SIGMOID || scratch == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_t = stage_bytes(J);
  int err = allow_smem(joint_tile_kernel, smem_t);
  if (err != 0) return err;
  const int tiles = tiles_of(V);
  const Scratch ws(scratch, R, J, tiles, slots_of(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto z_kernel = J % 4 == 0 ? joint_z_kernel<true> : joint_z_kernel<false>;
  z_kernel<<<(J + ZC - 1) / ZC * ZQ, ZT, 0, s>>>(
      static_cast<const float*>(enc), static_cast<const float*>(dec),
      static_cast<const float*>(w_pred), static_cast<const float*>(b_pred), ws.z, R, H, J, act);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  joint_tile_kernel<<<tiles, NT, smem_t, s>>>(
      static_cast<const float*>(w_out), static_cast<const float*>(b_out), scratch,
      static_cast<unsigned*>(tickets), static_cast<float*>(lp_blank), static_cast<float*>(top_lp), static_cast<int*>(top_tok), R,
      J, V, m, blank);
  RS_RETURN_LAST_ERROR();
}
