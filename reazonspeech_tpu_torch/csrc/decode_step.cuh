// The product of a few decode rows with a slice of weight columns, under the
// fused joint's tile kernel (joint_topm.cu).
//
// A block of NT = 512 threads computes out[r][c] = Σ_k A[r, k] · W[k, col(c)]
// for RT = 16 rows of A and the NC = 32 columns col(0..31) of W that its
// caller assigns, in fp32 with plain FMA (no TF32: the beam decoders compare
// log-probs whose near-ties TF32's 10-bit mantissa would flip).
//
// - A's tile is staged in shared memory as [K][RT], so the RT values of one
//   k are four float4 reads that every lane of a warp shares (a broadcast);
//   the staging reads A as float4, four loads in flight a thread.
// - Lane c of every warp owns column c; warp w takes k = w, w + 16, ... .
//   For a given k the 32 lanes read 32 columns of one W row: coalesced
//   where the columns are consecutive. Each lane issues its next 16 W loads
//   before it uses them: at a few rows the call is bound by the latency of
//   these loads, and 16 in flight a warp hide 16 times more of it.
// - Each thread sums its k's into RT registers; the 16 warps' partial sums
//   meet in shared memory and are added in warp order (a fixed order).
//
// A is the concatenation along k of two row-major matrices A0 [R, K0] and
// A1 [R, K1] (x and h for the LSTM gates; K1 = 0 for one), and W likewise of
// W0 [K0, ldw] and W1 [K1, ldw]. The depth is staged in chunks of KC, so
// any depth fits: at most RT x KC floats of shared memory, and the products
// accumulate in the same registers across chunks (a depth of at most KC,
// as every model of the repo has, is one chunk). The staging reads float4
// where K0 and K1 are multiples of 4 (A0 and A1 are 16-byte aligned: the
// wrappers check it), single floats otherwise.
#pragma once

#include "common.cuh"

namespace rs {
namespace step {

constexpr int NT = 512;       // threads per block
constexpr int NC = 32;        // columns per block: one per lane
constexpr int NKS = NT / NC;  // warps, each a slice of k
constexpr int RT = 16;        // rows per tile
constexpr int KC = 2048;      // depth per staged chunk: 128 KB of shared memory
constexpr int LOADS = 16;     // W loads a lane keeps in flight
constexpr int STAGE = 4;      // float4 loads a thread keeps in flight while staging

// bytes of dynamic shared memory for a depth of K
inline size_t stage_bytes(int K) { return size_t(RT) * (K < KC ? K : KC) * sizeof(float); }

// Rows [r0, r0 + RT) and depth [k0, k1) of [A0 | A1] into
// a_s[(k - k0) * RT + r]; rows at or past R are zero. Ends with a barrier.
__device__ __forceinline__ void stage(float* a_s, const float* __restrict__ A0, int K0,
                                      const float* __restrict__ A1, int K1, int R, int r0,
                                      int k0, int k1) {
  if ((K0 | K1) % 4 != 0) {  // rows not 16-byte aligned: one float at a time
    const int kn = k1 - k0;
    for (int idx = threadIdx.x; idx < RT * kn; idx += NT) {
      const int r = idx / kn, k = k0 + idx % kn, row = r0 + r;
      float v = 0.0f;
      if (row < R) v = k < K0 ? A0[size_t(row) * K0 + k] : A1[size_t(row) * K1 + (k - K0)];
      a_s[(k - k0) * RT + r] = v;
    }
    __syncthreads();
    return;
  }
  const int n = RT * ((k1 - k0) / 4);  // float4 chunks: r fastest, then k / 4
  for (int base = threadIdx.x; base < n; base += NT * STAGE) {
    float4 v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int idx = base + u * NT, r = idx % RT, k = k0 + 4 * (idx / RT), row = r0 + r;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (idx < n && row < R)
        v[u] = k < K0 ? __ldg(reinterpret_cast<const float4*>(A0 + size_t(row) * K0 + k))
                      : __ldg(reinterpret_cast<const float4*>(A1 + size_t(row) * K1 + (k - K0)));
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int idx = base + u * NT, r = idx % RT, k = 4 * (idx / RT);
      if (idx < n) {
        a_s[(k + 0) * RT + r] = v[u].x;
        a_s[(k + 1) * RT + r] = v[u].y;
        a_s[(k + 2) * RT + r] = v[u].z;
        a_s[(k + 3) * RT + r] = v[u].w;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void fma_rows(float (&acc)[RT], const float* a_k, float w) {
  const float4* a4 = reinterpret_cast<const float4*>(a_k);
#pragma unroll
  for (int q = 0; q < RT / 4; ++q) {
    const float4 a = a4[q];
    acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
  }
}

// acc += Σ over this warp's k < K (k = ks, ks + NKS, ...) of
// a_s[(a_at + k) * RT + r] · W[k, col], LOADS W loads issued at a time.
__device__ __forceinline__ void dot_rows(float (&acc)[RT], const float* a_s, int a_at,
                                         const float* __restrict__ W, int K, int ldw, int col,
                                         int ks) {
  const int n = K > ks ? (K - ks + NKS - 1) / NKS : 0;
  int i = 0;
  for (; i + LOADS <= n; i += LOADS) {
    float w[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) w[u] = __ldg(W + size_t(ks + NKS * (i + u)) * ldw + col);
#pragma unroll
    for (int u = 0; u < LOADS; ++u) fma_rows(acc, a_s + (a_at + ks + NKS * (i + u)) * RT, w[u]);
  }
  for (; i < n; ++i)
    fma_rows(acc, a_s + (a_at + ks + NKS * i) * RT, __ldg(W + size_t(ks + NKS * i) * ldw + col));
}

// out_s[r * NC + lane] = Σ_k [A0 | A1][r0 + r, k] · [W0 ; W1][k, col] for
// this thread's lane, the depth staged through a_s chunk by chunk; ``col``
// is the W column of the calling lane, ``valid`` false for a lane past W's
// width (its sums are 0). ``red`` holds NKS * RT * NC floats, ``out_s``
// RT * NC. Ends with a barrier: out_s is ready, a_s free.
__device__ __forceinline__ void dot(float* a_s, const float* __restrict__ A0, int K0,
                                    const float* __restrict__ A1, int K1, int R, int r0,
                                    const float* __restrict__ W0, const float* __restrict__ W1,
                                    int ldw, int col, bool valid, float* red, float* out_s) {
  const int lane = threadIdx.x % NC, ks = threadIdx.x / NC;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < K0 + K1; k0 += KC) {
    const int k1 = min(K0 + K1, k0 + KC);
    stage(a_s, A0, K0, A1, K1, R, r0, k0, k1);
    if (valid) {
      if (k0 < K0)  // W0's rows [k0, min(k1, K0))
        dot_rows(acc, a_s, 0, W0 + size_t(k0) * ldw, min(k1, K0) - k0, ldw, col, ks);
      if (k1 > K0) {  // W1's rows from max(k0, K0)
        const int lo = max(k0, K0);
        dot_rows(acc, a_s, lo - k0, W1 + size_t(lo - K0) * ldw, k1 - lo, ldw, col, ks);
      }
    }
    __syncthreads();  // the next chunk overwrites a_s
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) red[(ks * RT + r) * NC + lane] = acc[r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < RT * NC; idx += NT) {
    float s = red[idx];
#pragma unroll
    for (int w = 1; w < NKS; ++w) s += red[w * RT * NC + idx];
    out_s[idx] = s;
  }
  __syncthreads();
}

// Raise the block's dynamic shared memory limit to ``bytes`` (above 48 KB
// it must be asked for); returns the CUDA error, 0 on success.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

}  // namespace step
}  // namespace rs
