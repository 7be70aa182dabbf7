// Fused log-softmax + blank split + exact top-m for transducer beam search.
//
// Replaces: reazonspeech_tpu/ops/beam_topk.py, topm_logsoftmax (a Pallas TPU
// kernel). Contract, per row of logits [R, V] (fp32 or bf16):
//   lse          = max + log Σ exp(x - max)             (fp32)
//   lp_blank     = x[blank] - lse
//   top_lp/tok   = the m largest labels, blank excluded, as x - lse, with
//                  ties going to the LOWEST column (the order of lax.top_k)
// Columns are exactly [0, V): there is no lane padding on this side. Any
// m >= 1 and any V: past the row's candidates the rounds take the JAX
// kernel's EXCLUDED pool (topm.cuh).
//
// What bounds it on the H100: at the slice's shapes (R = 4 utterances x
// beam 4 = 16 rows, V = 3001, m = 4) one call reads 192 KB and does a few
// hundred thousand flops: it is bound by launch latency and by the serial
// passes over each row, never by bandwidth. It runs once per ALSD step.
//
// Design: the row in tiles of TW = 8,192 columns, one block of 256 threads
// per (row, tile). The block copies its columns into shared memory as fp32
// (coalesced) while taking the max and the lowest column >= EXCLUDED, sums
// the exponentials, then picks in m rounds (topm.cuh): each round reads
// the cached tile once for the best candidate strictly after the last pick,
// each thread keeping its best (value, lowest column); warps reduce with
// shuffles and the 8 warp results are combined in a fixed order, so every
// thread sees the same winner. No list of picks is kept, so m has no cap;
// no sort and no torch.topk (whose tie order is unspecified on CUDA) is
// involved. A row of V <= TW (every vocabulary the repo's models have:
// V <= 3,001) is one tile, whose block writes the results: one launch. A
// longer row's tiles write their partials (max, Σexp, lowest column
// >= EXCLUDED, blank logit, top-m candidates) and topm.cuh's merge_kernel,
// a block per row, combines them exactly: a second launch. The row is
// cached because a pass straight from global memory is bound by the
// latency of each thread's serial loads, and the kernel makes m + 2
// passes.

#include "topm.cuh"

namespace {

using namespace rs::topm;

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int TW = 8192;         // columns of a tile: 32 KB of fp32, under the 48 KB default
constexpr int MAX_TILES = 65535;  // tiles run along gridDim.y: V < 2^29

template <typename T>
__global__ void __launch_bounds__(NT)
topm_tile_kernel(const T* __restrict__ logits, int V, int m, int blank,
                 float* __restrict__ lp_blank, float* __restrict__ top_lp,
                 int* __restrict__ top_tok, float* __restrict__ pmax, float* __restrict__ psum,
                 float* __restrict__ pblank, int* __restrict__ plow, float* __restrict__ cval,
                 int* __restrict__ cidx) {
  extern __shared__ float s_row[];  // this tile's columns as fp32
  __shared__ float s_f[NW];
  __shared__ int s_i[NW];
  const int row = blockIdx.x, tile = blockIdx.y, tiles = gridDim.y;
  const int c0 = tile * TW, n = min(TW, V - c0);
  const T* x = logits + size_t(row) * V + c0;

  float mx = rs::neg_inf();
  int low = INT_MAX;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float v = rs::to_float(x[i]);
    s_row[i] = v;
    mx = fmaxf(mx, v);
    if (v >= EXCLUDED) low = min(low, c0 + i);
  }
  mx = rs::block_max<NT>(mx, s_f);  // its barriers also publish s_row
  low = rs::block_min<NT>(low, s_i);
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += NT) sum += expf(s_row[i] - mx);
  sum = rs::block_sum<NT>(sum, s_f);

  const bool whole = tiles == 1;  // this block has the whole row: final results
  const float lse = mx + logf(sum);
  const size_t part = size_t(row) * tiles + tile;
  if (threadIdx.x == 0) {
    if (whole) {
      lp_blank[row] = s_row[blank] - lse;
    } else {
      pmax[part] = mx;
      psum[part] = sum;
      plow[part] = low;
      if (blank >= c0 && blank < c0 + n) pblank[row] = s_row[blank - c0];
    }
  }
  float* out_v = whole ? top_lp + size_t(row) * m : cval + part * m;
  int* out_c = whole ? top_tok + size_t(row) * m : cidx + part * m;
  float pv = first_v();
  int pc = FIRST_C;
  int i = 0;
  for (; i < m; ++i) {
    float bv = rs::neg_inf();
    int bi = INT_MAX;
    for (int k = threadIdx.x; k < n; k += NT) {
      const float v = s_row[k];
      const int c = c0 + k;
      if (candidate(v, c, blank) && after(v, c, pv, pc) && rs::better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    rs::block_argmax<NT>(bv, bi, s_f, s_i);
    if (bi == INT_MAX) break;  // the tile's candidates ran out
    if (threadIdx.x == 0) {
      out_v[i] = whole ? bv - lse : bv;
      out_c[i] = bi;
    }
    pv = bv;
    pc = bi;
  }
  // the rounds left: the EXCLUDED pool's lowest column (a whole row), or
  // the padding of a tile's candidate list
  for (int j = i + threadIdx.x; j < m; j += NT) {
    out_v[j] = whole ? EXCLUDED - lse : rs::neg_inf();
    out_c[j] = whole ? min(blank, low) : INT_MAX;
  }
}

template <typename T>
int launch(const void* logits, void* lp_blank, void* top_lp, void* top_tok, void* f32, void* i32,
           int R, int V, int m, int blank, cudaStream_t stream) {
  const int tiles = (V + TW - 1) / TW;
  if (tiles > 1 && (f32 == nullptr || i32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // partials when tiles > 1: f32 = pmax, psum [R, tiles], pblank [R], cval
  // [R, tiles, m]; i32 = plow [R, tiles], cidx [R, tiles, m]
  float* pmax = static_cast<float*>(f32);
  float* psum = pmax ? pmax + size_t(R) * tiles : nullptr;
  float* pblank = psum ? psum + size_t(R) * tiles : nullptr;
  float* cval = pblank ? pblank + R : nullptr;
  int* plow = static_cast<int*>(i32);
  int* cidx = plow ? plow + size_t(R) * tiles : nullptr;
  const size_t smem = size_t(V < TW ? V : TW) * sizeof(float);
  topm_tile_kernel<T><<<dim3(R, tiles), NT, smem, stream>>>(
      static_cast<const T*>(logits), V, m, blank, static_cast<float*>(lp_blank),
      static_cast<float*>(top_lp), static_cast<int*>(top_tok), pmax, psum, pblank, plow, cval,
      cidx);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || tiles == 1) return err;
  merge_kernel<NT><<<R, NT, 0, stream>>>(pmax, psum, plow, pblank, cval, cidx,
                                         static_cast<float*>(lp_blank),
                                         static_cast<float*>(top_lp),
                                         static_cast<int*>(top_tok), tiles, m, blank);
  RS_RETURN_LAST_ERROR();
}

}  // namespace

// Scratch the caller allocates when V > 8,192 (else null): f32 of
// R·(2·tiles + 1 + tiles·m) floats, i32 of R·tiles·(m + 1), tiles = ceil(V / 8,192).
extern "C" int rs_topm_logsoftmax(const void* logits, void* lp_blank, void* top_lp,
                                  void* top_tok, void* f32, void* i32, int R, int V, int m,
                                  int blank, int is_bf16, void* stream) {
  if (R <= 0 || V <= 0 || m < 1 || blank < 0 || blank >= V || (V + TW - 1) / TW > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(logits, lp_blank, top_lp, top_tok, f32, i32, R, V, m, blank, s);
  return launch<float>(logits, lp_blank, top_lp, top_tok, f32, i32, R, V, m, blank, s);
}

extern "C" const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
