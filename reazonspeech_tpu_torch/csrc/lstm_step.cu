// One LSTM cell step for the transducer prediction network, fused.
//
// Replaces: reazonspeech_tpu/ops/lstm_step.py, lstm_cell_step (a Pallas TPU
// kernel). Contract, for R rows, in fp32 (the only dtype the beam decoders
// pass: compute_dtype="float32"):
//   gates = x · W_ih + h · W_hh + b          x [R, H_in], h [R, H], b [4H]
//   (i, f, g, o) = the four H-wide column groups of gates
//   c' = σ(f) · c + σ(i) · tanh(g),   h' = σ(o) · tanh(c')
//
// What bounds it on the H100: at the decoders' shapes (nemo ALSD: R = 16,
// H_in = H = 640, 4H = 2,560; espnet Graves: R = 4, H = 256) one call reads
// the two weight matrices once (13.1 MB and 2.1 MB in fp32) and does 2·R·
// (H_in + H)·4H flops (105 and 8 million). The bytes set the bound (3.9 µs
// and 0.6 µs at HBM rate, less from L2, which holds both); at these R the
// call is bound by its launch and its serial k loop, not by either.
//
// Design: each block owns 8 hidden units u and computes their four gate
// columns u, H+u, 2H+u and 3H+u (32 columns: one per lane) for 16 rows at a
// time with decode_step.cuh's product (the depth H_in + H staged in chunks
// of 2,048), reading those columns of W_ih and W_hh once a row tile. The gates stay in shared memory; 128 threads then
// apply the cell to (row, unit) pairs and write h' and c'. One launch per
// layer, and the [R, 4H] gates never reach device memory (the unfused chain
// writes and reads them, and launches ~10 ops).

#include "decode_step.cuh"

namespace {

using namespace rs::step;

constexpr int UNITS = NC / 4;  // hidden units per block

__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w_ih,
                 const float* __restrict__ w_hh, const float* __restrict__ bias,
                 float* __restrict__ h_out, float* __restrict__ c_out, int R, int H_in, int H) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [min(H_in + H, KC)][RT]
  __shared__ float red[NKS * RT * NC];
  __shared__ float g_s[RT * NC];  // the gate sums of the tile: [RT][4 gates x UNITS]
  const int u0 = blockIdx.x * UNITS;
  const int lane = threadIdx.x % NC;
  const int unit = u0 + lane % UNITS;
  const int col = (lane / UNITS) * H + unit;  // gate (lane / UNITS) of this unit
  for (int r0 = 0; r0 < R; r0 += RT) {
    dot(a_s, x, H_in, h, H, R, r0, w_ih, w_hh, 4 * H, col, unit < H, red, g_s);
    if (threadIdx.x < RT * UNITS) {  // one thread per (row, unit)
      const int r = threadIdx.x / UNITS, uo = threadIdx.x % UNITS;
      const int row = r0 + r, u = u0 + uo;
      if (row < R && u < H) {
        const float* g = g_s + r * NC + uo;
        const float gi = g[0 * UNITS] + bias[u];
        const float gf = g[1 * UNITS] + bias[H + u];
        const float gg = g[2 * UNITS] + bias[2 * H + u];
        const float go = g[3 * UNITS] + bias[3 * H + u];
        const size_t at = size_t(row) * H + u;
        const float cn = rs::sigmoid(gf) * c[at] + rs::sigmoid(gi) * tanhf(gg);
        h_out[at] = rs::sigmoid(go) * tanhf(cn);
        c_out[at] = cn;
      }
    }
    __syncthreads();  // g_s and a_s are rewritten by the next row tile
  }
}

}  // namespace

extern "C" int rs_lstm_cell_step(const void* x, const void* h, const void* c, const void* w_ih,
                                 const void* w_hh, const void* bias, void* h_out, void* c_out,
                                 int R, int H_in, int H, void* stream) {
  const size_t smem = stage_bytes(H_in + H);
  if (R <= 0 || H_in <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(lstm_cell_kernel, smem);
  if (err != 0) return err;
  lstm_cell_kernel<<<(H + UNITS - 1) / UNITS, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h), static_cast<const float*>(c),
      static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
      static_cast<const float*>(bias), static_cast<float*>(h_out), static_cast<float*>(c_out), R,
      H_in, H);
  RS_RETURN_LAST_ERROR();
}
