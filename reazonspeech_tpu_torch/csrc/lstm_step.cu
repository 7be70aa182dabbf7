// One LSTM cell step for the transducer prediction network, fused.
//
// Replaces: reazonspeech_tpu/ops/lstm_step.py, lstm_cell_step (a Pallas TPU
// kernel). Contract, for R rows, in fp32 (the only dtype the beam decoders
// pass: compute_dtype="float32") with plain FMA (no TF32: the decoders
// compare log-probs whose near-ties TF32's 10-bit mantissa would flip):
//   gates = x · W_ih + h · W_hh + b          x [R, H_in], h [R, H], b [4H]
//   (i, f, g, o) = the four H-wide column groups of gates
//   c' = σ(f) · c + σ(i) · tanh(g),   h' = σ(o) · tanh(c')
//
// What bounds it on the H100: one call must read W_ih and W_hh once (13.1 MB
// at nemo's predictor, H_in = H = 640; 2.1 MB at espnet's, H = 256: 3.9 and
// 0.6 µs at HBM rate) and does 2·R·(H_in + H)·4H flops. Each weight is used
// 2R times for its 4 bytes, so up to R ≈ 40 the bytes bound the call and
// past it the fp32 FMAs (R = 160 at nemo's width: 1.05 GFLOP, 15.7 µs).
//
// Design:
// - A cluster of `ranks` blocks (1-8) owns U = 32 units: their 4U gate
//   columns u, H + u, 2H + u, 3H + u. The depth is cut into stages of
//   SR = 32 rows of W_ih, then of W_hh (a matrix's last stage short), and
//   block rank p of the cluster takes a contiguous 1/ranks of the stages: at
//   nemo's width 20 clusters of 8 put 160 blocks on the card, each with 5
//   stages (80 KB), two blocks fitting an SM.
// - A stage's W is four TMA boxes (one a gate: SR rows x U columns, 16 KB in
//   all), copied into a slot of a ring in shared memory that completes on
//   the slot's mbarrier; its x|h rows (16 rows x SR, the matrix's columns of
//   the stage) ride on the same barrier by cp.async (16 bytes at a time;
//   4 where H_in or H is not a multiple of 4). Warp 0 copies every stage's
//   x|h at once, and thread 0 keeps AHEAD stages of W in flight: each stage
//   is multiplied as soon as it lands, in order (with every stage in flight
//   at once, the memory returns them all at about the same time).
// - A thread owns one quad (four consecutive units of one gate) and one of
//   D = 8 depth slots: lanes q = lane & 7 take 8 quads, lanes s = lane >> 3
//   four slots, warps w & 3 the four gates' quads and w >> 2 the slots'
//   halves. Slot d takes rows 4d .. 4d + 3 of every stage: one 16-byte
//   read of W a row, and one of x|h a row of R, for 16 FMAs; a thread keeps
//   16 rows x its 4 columns in registers.
// - The slice stays in the ring: every 16-row tile multiplies the same
//   stages, so W leaves memory once a call at any R; the next tile's x|h is
//   copied while the current one is reduced. Where the slice does not fit
//   (in the H100's 227 KB a block holds at most 11 stages, 10 at widths not
//   multiples of 4: with 8 ranks, past a depth H_in + H of ~2,800, or
//   ~2,560), the stages go through the ring in fills of `slots`, each once
//   every warp is done with the last (a block barrier), again for each row
//   tile: W is then read once a tile. split() picks `ranks` and `slots`.
// - Sums in a fixed order, with no atomics: each thread's k in ascending
//   order; the warp's four slots in a reduce-scatter (lane s keeps rows
//   4s..4s+3: (p[s] + p[s^2]) + (p[s^1] + p[s^3])); the block's warps of
//   the same quads in warp order; then the ranks in rank order. The ranks
//   meet by pushing: each block stores its sums of the units that rank p
//   owns (units [p U / ranks, (p + 1) U / ranks) of the cluster, rounded
//   up) into p's shared memory with st.async, which completes on p's
//   mbarrier; p then adds the ranks' sums, the bias (copied into shared
//   memory while the stages stream, as is c) and applies the cell, and
//   writes h' and c'. A
//   cluster barrier, arrived at after a tile's cell and waited on before
//   the next tile's pushes, keeps the pushes out of a buffer still read.
// One launch per layer; the [R, 4H] gates never reach device memory.

#include "gemm_sm90.cuh"  // mbarrier and TMA helpers, the tensor-map encoder

#include <mutex>

namespace {

namespace s9 = rs::sm90;

constexpr int NT = 256;           // threads per block: 8 warps
constexpr int RT = 16;            // rows per tile
constexpr int MAX_RANKS = 8;      // blocks per cluster (the portable limit)
constexpr int AHEAD = 2;          // stages in flight while the ring holds every stage
constexpr int U = 32;             // units a cluster
constexpr int QG = U / 8;         // warps along the quads: a gate each
constexpr int WD = NT / 32 / QG;  // warps along the depth
constexpr int D = 4 * WD;         // depth slots: 4 a warp (lanes s)
constexpr int SR = 4 * D;         // rows a stage
constexpr int PART = RT * 4 * U;  // floats of a [RT][4U] partial

// the most units a rank applies the cell to
__host__ __device__ inline int units_a_rank(int ranks) { return (U + ranks - 1) / ranks; }

// The block's layout: a gate's box is WS columns wide, U, or U + 4 where H
// is not a multiple of 4 (TMA boxes start 16-byte aligned: the box then
// starts up to 3 columns early).
template <bool ALIGNED>
struct Layout {
  static constexpr int WS = ALIGNED ? U : U + 4;
  static constexpr int STAGE = 4 * SR * WS;  // floats of W a stage: 4 gates x SR rows x WS
  // shared memory: 128 bytes of alignment slack; `slots` ring slots of W
  // and x|h; the warps' partials [WD - 1]; the ranks' pushed sums
  // [ranks][RT][4 gates][nu]; the cell's b [4][nu] and c [RT][nu]; a
  // barrier a slot and one for the pushes
  static size_t smem_bytes(int ranks, int slots) {
    const size_t nu = units_a_rank(ranks);
    return 128 + size_t(slots) * (STAGE * 4 + RT * SR * 4) + size_t(WD - 1) * PART * 4 +
           size_t(ranks) * RT * 4 * nu * 4 + (4 + RT) * nu * 4 + size_t(slots + 1) * 8;
  }
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#ifdef RS_LSTM_TRACE
// The phase trace's build (tools/torch_lstm_trace.py): thread 0 of each of
// the first 4,096 blocks stamps %globaltimer at [i], clock64 at [8 + i] and
// its SM at [15]. Otherwise stamp() is nothing.
__device__ unsigned long long g_lstm_stamps[4096][16];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.x < 4096) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_lstm_stamps[blockIdx.x][i] = t;
    g_lstm_stamps[blockIdx.x][8 + i] = clock64();
    g_lstm_stamps[blockIdx.x][15] = sm;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// the shared::cluster address of shared address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// stores into another block's shared memory, completing on its barrier
__device__ __forceinline__ void push4(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push1(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// wait for the phase of parity `parity`, seeing what other blocks stored
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = s9::smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 16 (or 4) bytes global -> shared, zeros where !ok (src then unread)
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s9::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s9::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(s9::smem_u32(bar))
               : "memory");
}

// One level of the warp's reduce-scatter over the lanes that differ in lane
// bit O: the lane with the bit set keeps the upper N values, the other the
// lower, each adding its partner's copy of what it keeps.
template <int N, int O>
__device__ __forceinline__ void halve(float (&v)[RT * 4]) {
  const bool upper = threadIdx.x & O;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(NT, 2)
lstm_cell_kernel(const __grid_constant__ CUtensorMap map_ih,
                 const __grid_constant__ CUtensorMap map_hh, const float* __restrict__ x,
                 const float* __restrict__ h, const float* __restrict__ c,
                 const float* __restrict__ bias, float* __restrict__ h_out,
                 float* __restrict__ c_out, int R, int H_in, int H, int slots) {
  constexpr int WS = Layout<ALIGNED>::WS, STAGE = Layout<ALIGNED>::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const int ranks = static_cast<int>(cluster_size()), rank = static_cast<int>(cluster_rank());
  const int NU = units_a_rank(ranks);
  float* w_s = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));  // [slots][4][SR][U]
  float* x_s = w_s + slots * STAGE;                                      // [slots][RT][SR]
  float* red = x_s + slots * RT * SR;                                    // [WD - 1][RT][4U]
  float* recv = red + (WD - 1) * PART;                                   // [ranks][RT][4][NU]
  float* b_s = recv + ranks * RT * 4 * NU;                               // [4][NU]
  float* c_s = b_s + 4 * NU;                                             // [RT][NU]
  uint64_t* full = reinterpret_cast<uint64_t*>(c_s + RT * NU);
  uint64_t* pushed = full + slots;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane >> 3, wd = warp / QG;
  const int d = s + 4 * wd;                     // this thread's depth slot
  const int quad = warp % QG * 8 + (lane & 7);  // its columns 4 quad .. 4 quad + 3 of the block's
  const int gate = quad / (U / 4), ul = 4 * (quad % (U / 4));  // ... gate and cluster unit
  const int u0 = blockIdx.x / ranks * U;        // the cluster's first unit
  const int ns_ih = (H_in + SR - 1) / SR, ns = ns_ih + (H + SR - 1) / SR;
  const int sb = rank * ns / ranks, nst = (rank + 1) * ns / ranks - sb;  // this rank's stages
  const bool hold = nst <= slots;  // the slice stays in the ring for every tile
  const int passes = (nst + slots - 1) / slots;  // else the ring's fills a tile
  const int tiles = (R + RT - 1) / RT;
  // the units this rank applies the cell to: [ub, ub + nu) of the cluster's
  const int ub = (rank * U + ranks - 1) / ranks, nu = ((rank + 1) * U + ranks - 1) / ranks - ub;
  const int items = RT * nu * 4;  // (row, unit, gate), the gate fastest
  stamp(0);

  if (tid == 0) {
    for (int b = 0; b < slots; ++b)
      s9::mbar_init(full + b, 33);  // lane 0's arrival (and the TMA bytes) + 32 lanes' copies
    s9::mbar_init(pushed, 1);
    s9::mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive();  // the barriers exist before any block pushes (waited on below)

  // (warp 0) the x|h rows of tile t over stage i's depth into slot b by
  // cp.async, arriving on the slot's barrier when they land
  auto stage_x = [&](int t, int i, int b) {
    const int j = sb + i, row0 = (j < ns_ih ? j : j - ns_ih) * SR, r0 = t * RT;
    const int width = j < ns_ih ? H_in : H;
    const float* src = j < ns_ih ? x : h;
    float* xb = x_s + b * RT * SR;
    if constexpr (ALIGNED) {  // rows of x and h are 16-byte aligned
      for (int e = lane; e < RT * SR / 4; e += 32) {
        const int r = e / (SR / 4), k = row0 + 4 * (e % (SR / 4)), row = r0 + r;
        const bool ok = row < R && k < width;
        copy16(xb + r * SR + (k - row0), ok ? src + size_t(row) * width + k : x, ok);
      }
    } else {
      for (int e = lane; e < RT * SR; e += 32) {
        const int r = e / SR, k = row0 + e % SR, row = r0 + r;
        const bool ok = row < R && k < width;
        copy4(xb + r * SR + (k - row0), ok ? src + size_t(row) * width + k : x, ok);
      }
    }
    copies_arrive(full + b);
  };
  // (lane 0 of warp 0) stage i's W into slot b: a TMA box a gate
  auto stage_w = [&](int i, int b) {
    const int j = sb + i;
    s9::mbar_expect_tx(full + b, STAGE * 4);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      s9::tma_load(w_s + b * STAGE + g * SR * WS, j < ns_ih ? &map_ih : &map_hh, full + b,
                   (g * H + u0) & ~3, (j < ns_ih ? j : j - ns_ih) * SR);
  };
  // every stage's x|h at once where the ring holds them all (they are
  // small), W AHEAD stages ahead of the one being multiplied; else the first
  // fill of the ring
  const int first = min(nst, slots), ahead = hold ? min(nst, AHEAD) : first;
  if (warp == 0) {
    for (int i = 0; i < first; ++i) stage_x(0, i, i);
    if (lane == 0)
      for (int i = 0; i < ahead; ++i) stage_w(i, i);
  }

  // the cell's b, once, and c of a tile's rows into shared memory by cp.async
  // (waited on before the block's sums meet), read while the stages stream
  for (int e = tid; e < 4 * nu; e += NT) {
    const int g = e / nu, u = u0 + ub + e % nu;
    copy4(b_s + g * NU + e % nu, u < H ? bias + g * H + u : bias, u < H);
  }
  auto stage_c = [&](int r0) {
    for (int e = tid; e < RT * nu; e += NT) {
      const int r = e / nu, u = u0 + ub + e % nu;
      const bool ok = r0 + r < R && u < H;
      copy4(c_s + r * NU + e % nu, ok ? c + size_t(r0 + r) * H + u : c, ok);
    }
  };
  stage_c(0);

  // the cell's items: (row, unit, gate) from a thread's index, the gate fastest
  auto item = [&](int i, int& g, int& u, int& r) {
    g = i & 3;
    u = u0 + ub + (i >> 2) % nu;
    r = (i >> 2) / nu;
  };

  // this thread's piece of a slot: its quad's columns, rows 4d .. 4d + 3
  const float* wq = w_s + gate * SR * WS + 4 * d * WS + ul + ((gate * H + u0) & 3);
  float acc[RT * 4];  // [row][column of the quad]
  for (int t = 0; t < tiles; ++t) {
    const int r0 = t * RT;
#pragma unroll
    for (int v = 0; v < RT * 4; ++v) acc[v] = 0.0f;
    for (int p = 0; p < passes; ++p) {
      const int i0 = p * slots, n = min(slots, nst - i0);
      if (!hold && t + p > 0) {  // the ring's next fill, once every warp is done with the last
        __syncthreads();
        if (warp == 0) {
          for (int i = 0; i < n; ++i) stage_x(t, i0 + i, i);
          if (lane == 0)
            for (int i = 0; i < n; ++i) stage_w(i0 + i, i);
        }
      }
      for (int i = 0; i < n; ++i) {
        // slot i's fills so far: `passes` a tile, one fewer past the last pass's stages
        s9::mbar_wait(full + i, (t * (passes - (i >= nst - (passes - 1) * slots)) + p) & 1);
        if (t == 0 && i == 0 && p == 0) stamp(1);  // the first stage has landed
        if (hold && t == 0 && tid == 0 && i + ahead < n) stage_w(i + ahead, i + ahead);
        const float* w = wq + i * STAGE;
        float4 w0, w1, w2, w3;
        if constexpr (ALIGNED) {
          w0 = *reinterpret_cast<const float4*>(w);
          w1 = *reinterpret_cast<const float4*>(w + WS);
          w2 = *reinterpret_cast<const float4*>(w + 2 * WS);
          w3 = *reinterpret_cast<const float4*>(w + 3 * WS);
        } else {
          w0 = make_float4(w[0], w[1], w[2], w[3]);
          w1 = make_float4(w[WS], w[WS + 1], w[WS + 2], w[WS + 3]);
          w2 = make_float4(w[2 * WS], w[2 * WS + 1], w[2 * WS + 2], w[2 * WS + 3]);
          w3 = make_float4(w[3 * WS], w[3 * WS + 1], w[3 * WS + 2], w[3 * WS + 3]);
        }
        const float* xk = x_s + i * RT * SR + 4 * d;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(xk + r * SR);
          float* o = acc + 4 * r;
          o[0] = fmaf(a.x, w0.x, o[0]);
          o[1] = fmaf(a.x, w0.y, o[1]);
          o[2] = fmaf(a.x, w0.z, o[2]);
          o[3] = fmaf(a.x, w0.w, o[3]);
          o[0] = fmaf(a.y, w1.x, o[0]);
          o[1] = fmaf(a.y, w1.y, o[1]);
          o[2] = fmaf(a.y, w1.z, o[2]);
          o[3] = fmaf(a.y, w1.w, o[3]);
          o[0] = fmaf(a.z, w2.x, o[0]);
          o[1] = fmaf(a.z, w2.y, o[1]);
          o[2] = fmaf(a.z, w2.z, o[2]);
          o[3] = fmaf(a.z, w2.w, o[3]);
          o[0] = fmaf(a.w, w3.x, o[0]);
          o[1] = fmaf(a.w, w3.y, o[1]);
          o[2] = fmaf(a.w, w3.z, o[2]);
          o[3] = fmaf(a.w, w3.w, o[3]);
        }
      }
    }

    if (t == 0) stamp(2);  // the first tile's last stage is multiplied
    // the warp's four slots: lane s keeps rows 4s .. 4s + 3 (acc[0..15])
    halve<32, 16>(acc);
    halve<16, 8>(acc);
    const int at = 4 * s * 4 * U + 4 * quad;  // [row 4s][column 4 quad] of a partial
    if (wd > 0) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        *reinterpret_cast<float4*>(red + (wd - 1) * PART + at + rr * 4 * U) =
            make_float4(acc[4 * rr], acc[4 * rr + 1], acc[4 * rr + 2], acc[4 * rr + 3]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's b and c
    __syncthreads();  // the warps' sums, b and c are in; x_s is read
    if (t == 0) stamp(3);
    if (hold && t + 1 < tiles && warp == 0) {  // the next tile's x|h (W stays)
      for (int i = 0; i < nst; ++i) stage_x(t + 1, i, i);
      if (lane == 0)
        for (int i = 0; i < nst; ++i) s9::mbar_arrive(full + i);
    }
    cluster_wait();  // every rank is done with its pushed sums of the last tile
    if (t == 0) stamp(4);
    if (wd == 0) {   // the warps of the same quads in warp order, pushed to the units' ranks
      const bool whole = U % (4 * ranks) == 0;  // a quad's four units are one rank's
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float4 v = make_float4(acc[4 * rr], acc[4 * rr + 1], acc[4 * rr + 2], acc[4 * rr + 3]);
#pragma unroll
        for (int w = 1; w < WD; ++w) {
          const float4 o = *reinterpret_cast<const float4*>(red + (w - 1) * PART + at + rr * 4 * U);
          v.x += o.x;
          v.y += o.y;
          v.z += o.z;
          v.w += o.w;
        }
        const int r = 4 * s + rr;
        if (whole) {
          const int p = ul * ranks / U;
          const int off = ((rank * RT + r) * 4 + gate) * NU + ul - p * U / ranks;
          push4(map_rank(s9::smem_u32(recv + off), p), v, map_rank(s9::smem_u32(pushed), p));
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = ul + k, p = u * ranks / U;
            const int off = ((rank * RT + r) * 4 + gate) * NU + u - (p * U + ranks - 1) / ranks;
            push1(map_rank(s9::smem_u32(recv + off), p), e[k], map_rank(s9::smem_u32(pushed), p));
          }
        }
      }
    }
    if (tid == 0) s9::mbar_expect_tx(pushed, ranks * RT * 4 * nu * 4);
    mbar_wait_cluster(pushed, t & 1);
    if (t == 0) stamp(5);  // every rank's sums have landed

    // the cell: four neighbouring lanes hold gates i, f, g, o of one (row, unit)
#pragma unroll
    for (int it = 0; it < RT * U * 4 / NT; ++it) {
      if (it * NT >= items) break;
      const int i = it * NT + tid;
      int g, u, r;
      item(i, g, u, r);
      const bool on = i < items;
      float v = 0.0f;
      if (on) {
        const int off = (r * 4 + g) * NU + (i >> 2) % nu;
        float from[MAX_RANKS];
#pragma unroll
        for (int p = 0; p < MAX_RANKS; ++p)
          if (p < ranks) from[p] = recv[p * RT * 4 * NU + off];
        v = from[0];
#pragma unroll
        for (int p = 1; p < MAX_RANKS; ++p)
          if (p < ranks) v += from[p];
        v += b_s[g * NU + (i >> 2) % nu];
      }
      const float vf = __shfl_down_sync(0xffffffffu, v, 1);
      const float vg = __shfl_down_sync(0xffffffffu, v, 2);
      const float vo = __shfl_down_sync(0xffffffffu, v, 3);
      const int row = r0 + r;
      if (on && g == 0 && row < R && u < H) {
        const size_t o = size_t(row) * H + u;
        const float cn = rs::sigmoid(vf) * c_s[r * NU + (i >> 2) % nu] + rs::sigmoid(v) * tanhf(vg);
        h_out[o] = rs::sigmoid(vo) * tanhf(cn);
        c_out[o] = cn;
      }
    }
    if (t + 1 < tiles) {
      __syncthreads();  // the pushes have read red, the cell c_s
      stage_c(r0 + RT);
      cluster_arrive();  // this block's pushed sums are read
    }
  }
  stamp(6);
}

// The tensor map of a row-major fp32 matrix [rows, cols] (cols a multiple
// of 4: 16-byte rows), in boxes of box_rows x box_cols, unswizzled; past its
// edges TMA reads zeros. The weights of a model stay put, so the maps are
// kept (a few, by address and shape). Returns 0 or a CUDA error.
int weight_map(CUtensorMap* map, const float* base, int rows, int cols, int box_cols,
               int box_rows) {
  struct Entry {
    const float* base;
    int rows, cols, box_cols, box_rows;
    CUtensorMap map;
  };
  static Entry kept[16];
  static int next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : kept)
    if (e.base == base && e.rows == rows && e.cols == cols && e.box_cols == box_cols &&
        e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  const s9::EncodeTiled encode = s9::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  kept[next] = Entry{base, rows, cols, box_cols, box_rows, *map};
  next = (next + 1) % 16;
  return 0;
}

// The current device and the shared memory a block of it may hold (opted in).
cudaError_t block_smem(int* dev, size_t* bytes) {
  static int known[64] = {};  // per device, once asked
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  int v = *dev < 64 ? known[*dev] : 0;
  if (v == 0) {
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e != cudaSuccess) return e;
    if (*dev < 64) known[*dev] = v;
  }
  *bytes = static_cast<size_t>(v);
  return cudaSuccess;
}

// A call's split: clusters of `ranks` blocks, each block 1/ranks of the
// depth's stages, `slots` stages in its ring, `fills` of the ring a row
// tile. Clusters of 8 (of fewer where the depth has fewer stages): at
// nemo's width 20 clusters, 160 blocks of 106 KB, two of which fit an SM,
// so no cluster waits for a second wave (clusters of 8 reach 120 of the
// H100's 132 SMs); narrower clusters (16 or 8 units, tried at nemo's and
// espnet's widths and at a depth of 3,072) were slower. The ring holds all
// of a block's stages where they fit in `smem` bytes (W then stays in
// shared memory for every row tile), else the fewest even fills that fit.
template <bool ALIGNED>
void split(int H_in, int H, size_t smem, int* ranks, int* slots, int* fills) {
  const int ns = (H_in + SR - 1) / SR + (H + SR - 1) / SR;
  *ranks = ns < MAX_RANKS ? ns : MAX_RANKS;
  const int most = (ns + *ranks - 1) / *ranks;
  *fills = 1;
  while (*fills < most && Layout<ALIGNED>::smem_bytes(*ranks, (most + *fills - 1) / *fills) > smem)
    ++*fills;
  *slots = (most + *fills - 1) / *fills;
}

template <bool ALIGNED>
int launch(const float* x, const float* h, const float* c, const float* w_ih, const float* w_hh,
           const float* bias, float* h_out, float* c_out, int R, int H_in, int H,
           cudaStream_t stream) {
  using L = Layout<ALIGNED>;
  int dev = 0, ranks = 0, slots = 0, fills = 0;
  size_t most = 0;
  cudaError_t e = block_smem(&dev, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  split<ALIGNED>(H_in, H, most, &ranks, &slots, &fills);
  CUtensorMap map_ih, map_hh;
  int err = weight_map(&map_ih, w_ih, H_in, 4 * H, L::WS, SR);
  if (err == 0) err = weight_map(&map_hh, w_hh, H, 4 * H, L::WS, SR);
  if (err != 0) return err;
  const size_t smem = L::smem_bytes(ranks, slots);
  auto kernel = lstm_cell_kernel<ALIGNED>;
  static size_t allowed[64] = {};  // the limit set so far, per device
  if (dev >= 64 || smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + U - 1) / U * ranks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_ih, map_hh, x, h, c, bias, h_out, c_out, R, H_in, H,
                         slots);
  if (e != cudaSuccess) return static_cast<int>(e);
  RS_RETURN_LAST_ERROR();
}

}  // namespace

extern "C" int rs_lstm_cell_step(const void* x, const void* h, const void* c, const void* w_ih,
                                 const void* w_hh, const void* bias, void* h_out, void* c_out,
                                 int R, int H_in, int H, void* stream) {
  if (R <= 0 || H_in <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto run = H_in % 4 == 0 && H % 4 == 0 ? launch<true> : launch<false>;
  return run(static_cast<const float*>(x), static_cast<const float*>(h),
             static_cast<const float*>(c), static_cast<const float*>(w_ih),
             static_cast<const float*>(w_hh), static_cast<const float*>(bias),
             static_cast<float*>(h_out), static_cast<float*>(c_out), R, H_in, H,
             static_cast<cudaStream_t>(stream));
}

// The split a call at these widths takes on the current device (see
// split()); 0 or a CUDA error.
extern "C" int rs_lstm_split(int H_in, int H, int* ranks, int* slots, int* fills) {
  if (H_in <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  size_t smem = 0;
  const cudaError_t e = block_smem(&dev, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  (H_in % 4 == 0 && H % 4 == 0 ? split<true> : split<false>)(H_in, H, smem, ranks, slots, fills);
  return 0;
}

#ifdef RS_LSTM_TRACE
extern "C" int rs_lstm_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_lstm_stamps, sizeof(g_lstm_stamps)));
}
#endif
