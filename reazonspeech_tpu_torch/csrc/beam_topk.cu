// Fused log-softmax + blank split + exact top-m for transducer beam search.
//
// Replaces: reazonspeech_tpu/ops/beam_topk.py, topm_logsoftmax (a Pallas TPU
// kernel). Contract, per row of logits [R, V] (fp32 or bf16):
//   lse          = max + log Σ exp(x - max)             (fp32)
//   lp_blank     = x[blank] - lse
//   top_lp/tok   = the m largest labels, blank excluded, as x - lse, with
//                  ties going to the LOWEST column (the order of lax.top_k)
// Columns are exactly [0, V): there is no lane padding on this side.
//
// What bounds it on the H100: at the slice's shapes (R = 4 utterances x
// beam 4 = 16 rows, V = 3001, m = 4) one call reads 192 KB and does a few
// hundred thousand flops: it is bound by launch latency and by the serial
// passes over each row, never by bandwidth. It runs once per ALSD step.
//
// Design: one block of 256 threads per row. The first pass copies the row
// into shared memory as fp32 (coalesced) while taking the max; the sum of
// exponentials and the m masked argmax passes then read shared memory. A
// column excluded so far (blank, or already picked) reads as -1e30, exactly
// as the JAX kernel rewrites it, so the edge cases agree too. Each thread
// keeps its best (value, lowest column); warps reduce with shuffles and the
// 8 warp results are combined in a fixed order, so every thread sees the
// same winner and ties go to the lowest column. No sort and no torch.topk
// (whose tie order is unspecified on CUDA) is involved. The row is cached
// because a pass straight from global memory is bound by the latency of
// each thread's serial loads, and the kernel makes m + 2 passes.

#include "common.cuh"

namespace {

constexpr int MAX_M = 32;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr float EXCLUDED = -1.0e30f;

template <typename T>
__global__ void __launch_bounds__(NT)
topm_kernel(const T* __restrict__ logits, float* __restrict__ lp_blank,
            float* __restrict__ top_lp, int* __restrict__ top_tok, int V, int m, int blank) {
  extern __shared__ float s_row[];  // [V] fp32 copy of this row
  __shared__ float s_f[NW];
  __shared__ int s_i[NW];
  const int row = blockIdx.x;
  const T* x = logits + size_t(row) * V;

  float mx = rs::neg_inf();
  for (int c = threadIdx.x; c < V; c += NT) {
    const float v = rs::to_float(x[c]);
    s_row[c] = v;
    mx = fmaxf(mx, v);
  }
  mx = rs::block_max<NT>(mx, s_f);  // its barriers also publish s_row
  float sum = 0.0f;
  for (int c = threadIdx.x; c < V; c += NT) sum += expf(s_row[c] - mx);
  const float lse = mx + logf(rs::block_sum<NT>(sum, s_f));
  if (threadIdx.x == 0) lp_blank[row] = s_row[blank] - lse;

  int picked[MAX_M];
  for (int i = 0; i < m; ++i) {
    float bv = rs::neg_inf();
    int bi = 0x7fffffff;
    for (int c = threadIdx.x; c < V; c += NT) {
      bool excluded = c == blank;
      for (int p = 0; p < i; ++p) excluded |= c == picked[p];
      const float v = excluded ? EXCLUDED : s_row[c];
      if (rs::better(v, c, bv, bi)) { bv = v; bi = c; }
    }
    rs::block_argmax<NT>(bv, bi, s_f, s_i);
    picked[i] = bi;
    if (threadIdx.x == 0) {
      top_lp[size_t(row) * m + i] = bv - lse;
      top_tok[size_t(row) * m + i] = bi;
    }
  }
}

template <typename T>
int launch(const void* logits, void* lp_blank, void* top_lp, void* top_tok, int R, int V,
           int m, int blank, cudaStream_t stream) {
  const size_t smem = size_t(V) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      topm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topm_kernel<T><<<R, NT, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(lp_blank),
      static_cast<float*>(top_lp), static_cast<int*>(top_tok), V, m, blank);
  RS_RETURN_LAST_ERROR();
}

}  // namespace

extern "C" int rs_topm_logsoftmax(const void* logits, void* lp_blank, void* top_lp,
                                  void* top_tok, int R, int V, int m, int blank, int is_bf16,
                                  void* stream) {
  if (R <= 0 || V <= 0 || m < 1 || m > MAX_M || m > V || blank < 0 || blank >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(logits, lp_blank, top_lp, top_tok, R, V, m, blank, s);
  return launch<float>(logits, lp_blank, top_lp, top_tok, R, V, m, blank, s);
}

extern "C" const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
