// Fused log-softmax + blank split + exact top-m for transducer beam search.
//
// Replaces: reazonspeech_tpu/ops/beam_topk.py, topm_logsoftmax (a Pallas TPU
// kernel). Contract, per row of logits [R, V] (fp32 or bf16):
//   lse          = max + log Σ exp(x - max)             (fp32)
//   lp_blank     = x[blank] - lse
//   top_lp/tok   = the m largest labels, blank excluded, as x - lse, with
//                  ties going to the LOWEST column (the order of lax.top_k)
// Columns are exactly [0, V): there is no lane padding on this side. Any
// m >= 1 and any V: past the row's candidates the picks take the JAX
// kernel's EXCLUDED pool (topm.cuh).
//
// What bounds it on the H100: at the decoders' shapes (nemo ALSD: R = 16,
// V = 3,001, m = 4; espnet Graves: R = 80, V = 2,182, m = 20) a call reads
// 192 KB and 698 KB and does a few hundred thousand flops: a few hundred
// nanoseconds at HBM rate. What it takes is the chain of dependent steps in
// a block (loads, reductions, picks, barriers), so the design keeps that
// chain short. It runs once per ALSD step.
//
// Design, one launch for any V:
// - A block of 256 threads per row part of up to 4,096 columns: one part
//   at every vocabulary the repo's models have. A thread's share of the
//   part is 16 values in registers: a scalar head up to the first 16-byte
//   boundary (a row starts at r · V), 16-byte vectors (4 fp32 or 8 bf16)
//   and a scalar tail, every load issued before any is used; then its max
//   and Σexp with independent exponentials.
// - Its candidates become 64-bit keys (topm.cuh) and a warp takes its best
//   m in m rounds, two redux.sync a round for the best head, only the
//   winning lane finding its next head. The warps' picks and (max, Σexp)
//   meet once in shared memory behind one barrier, and warp 0 merges the 8
//   sorted lists in m rounds over their heads.
// - A row of more than one part: each part's block writes its partials
//   (max, Σexp, lowest column, best m) and takes a ticket; the last block of
//   the row to arrive merges them (topm.cuh's block_merge: each warp a run
//   of the parts' picks, then one merge of the warps' lists), its (max,
//   Σexp) in a fixed order, so the result does not depend on which block
//   finished last. It resets the ticket, which lives in a buffer the
//   wrapper keeps per (device, stream). No second launch.
// - m > 40: the block caches its part (8,192 columns) in shared memory and
//   picks in m block-wide rounds, each the best candidate strictly after
//   the last pick (topm.cuh), then merges as above.
// The wrapper sizes the workspace (scratch and tickets) by
// rs_topm_workspace, so the split is decided here alone.
// No sort and no torch.topk (whose tie order is unspecified on CUDA).

#include <cstdint>

#include "topm.cuh"

namespace {

using namespace rs::topm;

constexpr int NT = 256;               // threads of a block
constexpr int NW = NT / 32;
constexpr int PART = 16 * NT;         // columns of a row part: 16 a thread
constexpr int ROUNDS_PART = 8192;     // ... with rounds: 32 KB of fp32 in shared memory
constexpr int M_MAX = 40;             // the largest m picked from keys; above it, rounds
constexpr int LOADS = 4;              // 16-byte loads a thread keeps in flight
constexpr int MAX_PARTS = 65535;      // parts run along gridDim.y

// the 16/sizeof(T) values of a 16-byte load as fp32
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4], const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);  // the lower address is the low half
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One pass over n columns of a row part at x (column c0 first): every value
// into this thread's online (mx, s) and through visit(value, column).
// Threads take 16-byte vectors in turn, LOADS in flight.
template <typename T, typename Visit>
__device__ __forceinline__ void scan_part(const T* __restrict__ x, int c0, int n, float& mx,
                                          float& s, Visit visit) {
  constexpr int E = 16 / sizeof(T);
  const int nt = blockDim.x;
  const int mis = int((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
  const int head = min(n, mis ? E - mis : 0);
  const int nvec = (n - head) / E;
  const int tail = head + nvec * E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the scalar head and tail: one element a thread each
    const int i = h == 0 ? int(threadIdx.x) : tail + int(threadIdx.x);
    if (h == 0 ? i >= head : i >= n) continue;
    const float v = rs::to_float(x[i]);
    if (v > mx) {
      s = s * expf(mx - v) + 1.0f;
      mx = v;
    } else if (mx != rs::neg_inf()) {
      s += expf(v - mx);
    }
    visit(v, c0 + i);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int base = threadIdx.x; base < nvec; base += nt * LOADS) {
    uint4 raw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = base + u * nt;
      if (i < nvec) raw[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (base + u * nt >= nvec) break;
      float f[E];
      unpack(raw[u], f, x);
      float vm = f[0];
#pragma unroll
      for (int e = 1; e < E; ++e) vm = fmaxf(vm, f[e]);
      if (vm > mx) {  // rescale once a vector
        s *= expf(mx - vm);
        mx = vm;
      }
      if (mx != rs::neg_inf()) {
#pragma unroll
        for (int e = 0; e < E; ++e) s += expf(f[e] - mx);
      }
      const int col = c0 + head + (base + u * nt) * E;
#pragma unroll
      for (int e = 0; e < E; ++e) visit(f[e], col + e);
    }
  }
}

// columns of a row part for m picks
inline int part_cols(int m) { return m <= M_MAX ? PART : ROUNDS_PART; }

// The partials of a split row, 32-bit words: pmax, psum [R * P] (float),
// plow [R * P], pv [R * P * m] (float), pc [R * P * m]; part p of row r at
// r * P + p.
inline size_t scratch_words(int R, int P, int m) {
  return P > 1 ? size_t(R) * P * (3 + 2 * size_t(m)) : 0;
}

struct Partials {
  float* pmax;
  float* psum;
  int* plow;
  float* pv;
  int* pc;
  __host__ __device__ Partials(void* words, int R, int P, int m) {
    const size_t n = size_t(R) * P;
    float* f = static_cast<float*>(words);
    pmax = f;
    psum = f + n;
    plow = reinterpret_cast<int*>(f + 2 * n);
    pv = f + 3 * n;
    pc = reinterpret_cast<int*>(f + 3 * n + n * m);
  }
};

// This thread's share of a row part of n <= PART columns at x (column c0
// first) in registers: a scalar head up to the first 16-byte boundary, NV
// 16-byte vectors (16 values in all) and a scalar tail; every load issued
// before any is used, past the part's end -inf. vals[q] is column col(q).
template <typename T>
struct Share {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int NV = 16 / E;  // 4 fp32 or 2 bf16 vectors
  static constexpr int Q = NV * E + 2;
  float vals[Q];
  int c0, head, tail;

  __device__ __forceinline__ void load(const T* __restrict__ x, int c0_, int n) {
    const int t = threadIdx.x;
    const int mis = int((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
    c0 = c0_;
    head = min(n, mis ? E - mis : 0);
    const int nvec = (n - head) / E;
    tail = head + nvec * E;
    uint4 raw[NV];
    if (nvec > 0) {  // uniform; the loads are clamped, so none branches
      const uint4* xv = reinterpret_cast<const uint4*>(x + head);
#pragma unroll
      for (int u = 0; u < NV; ++u) raw[u] = __ldg(xv + min(t + u * NT, nvec - 1));
    }
    const float hv = rs::to_float(x[min(t, n - 1)]);
    const float tv = rs::to_float(x[min(tail + t, n - 1)]);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      float f[E];
      unpack(raw[u], f, x);
      const bool ok = t + u * NT < nvec;
#pragma unroll
      for (int e = 0; e < E; ++e) vals[u * E + e] = ok ? f[e] : rs::neg_inf();
    }
    vals[NV * E] = t < head ? hv : rs::neg_inf();
    vals[NV * E + 1] = tail + t < n ? tv : rs::neg_inf();
  }

  // the column of vals[q]
  __device__ __forceinline__ int col(int q) const {
    const int t = threadIdx.x;
    if (q < NV * E) return c0 + head + (t + q / E * NT) * E + q % E;
    return c0 + (q == NV * E ? t : tail + t);
  }
};

// M: the warps' lists in shared memory hold M_MAX picks (m <= M_MAX), or 0:
// the rounds path (m > M_MAX)
template <typename T, int M>
__global__ void __launch_bounds__(NT)
topm_kernel(const T* __restrict__ logits, int V, int m, int blank, int cols,
            float* __restrict__ lp_blank, float* __restrict__ top_lp, int* __restrict__ top_tok,
            void* scratch, unsigned* __restrict__ tickets) {
  extern __shared__ float s_row[];  // M == 0: the part's columns as fp32
  constexpr int LM = M > 0 ? M : 1;
  __shared__ float s_mx[NW], s_s[NW], s_v[NW * LM];
  __shared__ int s_low[NW], s_n[NW], s_c[NW * LM], s_flag;
  const int row = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c0 = part * cols, n = min(cols, V - c0);
  const T* x_row = logits + size_t(row) * V;
  const Partials pt(scratch, gridDim.x, parts, m);
  const size_t slot = size_t(row) * parts + part;
  // the results of this part: the final ones (one part) or its partials
  float* out_v = parts == 1 ? top_lp + size_t(row) * m : pt.pv + slot * m;
  int* out_c = parts == 1 ? top_tok + size_t(row) * m : pt.pc + slot * m;
  float* const lv = s_v;  // lambdas capture these pointers, not the shared arrays
  int* const lc = s_c;
  float* const cache = s_row;
  float mx = rs::neg_inf(), s = 0.0f;
  int low = NONE, k;

  if constexpr (M > 0) {
    using S = Share<T>;
    S sh;
    sh.load(x_row + c0, c0, n);
    const float x_blank = parts == 1 && threadIdx.x == 0 ? rs::to_float(x_row[blank]) : 0.0f;
    // (max, Σexp): independent exponentials, then the warp's
#pragma unroll
    for (int q = 0; q < S::Q; ++q) mx = fmaxf(mx, sh.vals[q]);
    if (mx != rs::neg_inf()) {
#pragma unroll
      for (int q = 0; q < S::Q; ++q) s += expf(sh.vals[q] - mx);
    }
    const float wmx = warp_max_f(mx);
    s = rs::warp_sum(mx == rs::neg_inf() ? 0.0f : s * expf(mx - wmx));
    mx = wmx;
    // the lowest column >= EXCLUDED, and the share's candidates as keys
    unsigned long long key[S::Q];
#pragma unroll
    for (int q = 0; q < S::Q; ++q) {
      const int c = sh.col(q);
      if (sh.vals[q] >= EXCLUDED) low = min(low, c);
      key[q] = cand_key(sh.vals[q], c, blank);
    }
    low = __reduce_min_sync(0xffffffffu, low);
    const int kw = warp_select_keys(key, m, [&](int i, float v, int c) {
      lv[warp * M + i] = v;
      lc[warp * M + i] = c;
    });
    if (lane == 0) {
      s_mx[warp] = mx;
      s_s[warp] = s;
      s_low[warp] = low;
      s_n[warp] = kw;
    }
    __syncthreads();
    if (warp == 0) {  // the block's (max, Σexp), lane w reading warp w's, then its best m
      const bool has = lane < nw;
      const float wm = has ? s_mx[lane] : rs::neg_inf();
      mx = warp_max_f(wm);
      s = rs::warp_sum(has && wm != rs::neg_inf() ? s_s[lane] * expf(wm - mx) : 0.0f);
      low = __reduce_min_sync(0xffffffffu, has ? s_low[lane] : NONE);
      const float sub = parts == 1 ? mx + logf(s) : 0.0f;  // a partial keeps the logit
      k = list_merge(lv, lc, s_n, nw, M, m, [&](int i, float v, int c) {
        out_v[i] = v - sub;
        out_c[i] = c;
      });
      if (parts == 1) {
        finish_row(lp_blank, top_lp, top_tok, row, m, k, sub, x_blank, low, blank, lane, 32);
        return;
      }
    } else if (parts == 1) {
      return;
    }
  } else {
    scan_part(x_row + c0, c0, n, mx, s, [&](float v, int c) {
      if (v >= EXCLUDED) low = min(low, c);
      cache[c - c0] = v;
    });
    warp_lse(mx, s);
    low = rs::warp_min(low);
    if (lane == 0) {
      s_mx[warp] = mx;
      s_s[warp] = s;
      s_low[warp] = low;
    }
    __syncthreads();  // also publishes s_row
    mx = s_mx[0];
    s = s_s[0];
    low = s_low[0];
    for (int w = 1; w < nw; ++w) {
      lse_fold(mx, s, s_mx[w], s_s[w]);
      low = min(low, s_low[w]);
    }
    const float sub = parts == 1 ? mx + logf(s) : 0.0f;
    float pv = first_v();
    int pc = FIRST_C;
    for (k = 0; k < m; ++k) {
      float bv = rs::neg_inf();
      int bc = NONE;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = s_row[i];
        const int c = c0 + i;
        if (candidate(v, c, blank) && after(v, c, pv, pc) && rs::better(v, c, bv, bc)) {
          bv = v;
          bc = c;
        }
      }
      rs::block_argmax<NT>(bv, bc, s_v, s_c);  // not s_mx: other threads may still read it
      if (bc == NONE) break;  // the part's candidates ran out
      if (threadIdx.x == 0) {
        out_v[k] = bv - sub;
        out_c[k] = bc;
      }
      pv = bv;
      pc = bc;
    }
  }

  if (parts == 1) {
    const float lse = mx + logf(s);
    finish_row(lp_blank, top_lp, top_tok, row, m, k, lse, rs::to_float(x_row[blank]), low, blank,
               threadIdx.x, blockDim.x);
    return;
  }
  if (warp == 0) {  // the part's partials (warp 0 holds them on both paths)
    for (int j = k + lane; j < m; j += 32) {  // empty slots
      out_v[j] = rs::neg_inf();
      out_c[j] = NONE;
    }
    if (lane == 0) {
      pt.pmax[slot] = mx;
      pt.psum[slot] = s;
      pt.plow[slot] = low;
    }
  }
  if (!last_to_arrive(tickets + row, parts, &s_flag)) return;

  // the last block of the row merges the parts: every warp (m <= M_MAX) or
  // warp 0 (the rounds path, whose lists are not kept)
  const size_t first = size_t(row) * parts;
  const float x_blank = rs::to_float(x_row[blank]);
  float lse;
  auto emit = [&](int i, float v, int c) {
    top_lp[size_t(row) * m + i] = v - lse;
    top_tok[size_t(row) * m + i] = c;
  };
  if constexpr (M > 0) {
    k = block_merge<NT, M>(pt.pmax + first, pt.psum + first, pt.plow + first, parts,
                           pt.pv + first * m, pt.pc + first * m, parts * m, m, lv, lc, s_n, s_mx,
                           s_low, lse, low, emit);
    finish_row(lp_blank, top_lp, top_tok, row, m, k, lse, x_blank, low, blank, threadIdx.x, NT);
  } else if (warp == 0) {
    k = merge_parts(pt.pmax + first, pt.psum + first, pt.plow + first, parts, pt.pv + first * m,
                    pt.pc + first * m, parts * m, m, lse, low, emit);
    finish_row(lp_blank, top_lp, top_tok, row, m, k, lse, x_blank, low, blank, lane, 32);
  }
}

template <typename T>
int launch(const void* logits, void* lp_blank, void* top_lp, void* top_tok, void* scratch,
           void* tickets, int R, int V, int m, int blank, cudaStream_t stream) {
  const int cols = part_cols(m), parts = (V + cols - 1) / cols;
  if (parts > MAX_PARTS || (parts > 1 && (scratch == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(R, parts);
  const size_t smem = m <= M_MAX ? 0 : size_t(min(V, cols)) * sizeof(float);
  const T* x = static_cast<const T*>(logits);
  float* lpb = static_cast<float*>(lp_blank);
  float* tlp = static_cast<float*>(top_lp);
  int* tok = static_cast<int*>(top_tok);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (m <= M_MAX)
    topm_kernel<T, M_MAX><<<grid, NT, smem, stream>>>(x, V, m, blank, cols, lpb, tlp, tok,
                                                      scratch, tk);
  else
    topm_kernel<T, 0><<<grid, NT, smem, stream>>>(x, V, m, blank, cols, lpb, tlp, tok, scratch,
                                                  tk);
  RS_RETURN_LAST_ERROR();
}

}  // namespace

// The workspace a call needs: returns the 32-bit words of scratch and sets
// *tickets to the counters, both 0 where each row is one part (V <= 4,096
// for m <= 40, V <= 8,192 above: pass null for both). The counters must be
// zero before the first call; the kernel leaves them zero.
extern "C" long long rs_topm_workspace(int R, int V, int m, int* tickets) {
  const int cols = part_cols(m > 0 ? m : 1), parts = V > 0 ? (V + cols - 1) / cols : 1;
  const bool split = R > 0 && m > 0 && parts > 1;
  *tickets = split ? R : 0;
  return split ? static_cast<long long>(scratch_words(R, parts, m)) : 0;
}

extern "C" int rs_topm_logsoftmax(const void* logits, void* lp_blank, void* top_lp,
                                  void* top_tok, void* scratch, void* tickets, int R, int V, int m,
                                  int blank, int is_bf16, void* stream) {
  if (R <= 0 || V <= 0 || m < 1 || blank < 0 || blank >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(logits, lp_blank, top_lp, top_tok, scratch, tickets, R, V, m,
                                 blank, s);
  return launch<float>(logits, lp_blank, top_lp, top_tok, scratch, tickets, R, V, m, blank, s);
}

extern "C" const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
