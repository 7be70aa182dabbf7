// Rel-pos attention: the C entries of the fused, packed and streamed
// contracts (the kernel and its design: relpos_attention.cuh).
//
// Replaces: reazonspeech_tpu/ops/relpos_attention.py, Pallas TPU kernels
// relpos_attention_fused (:341), relpos_attention_fused_packed (:402) and
// relpos_attention_blockwise (:199).

#include "relpos_attention.cuh"

namespace {

// The fused contracts: q, k, v rows of stride ld in [B, T, *], biases added
// here, out [B, T, H·dh] bf16.
int launch_fused(const void* q, const void* k, const void* v, const void* pos, const void* bu,
                 const void* bv, const void* lengths, void* out, int B, int T, int H, int dh,
                 int ld, void* stream) {
  Args a{};
  a.qu = a.qv = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = static_cast<const bf16*>(pos);
  a.bias_u = static_cast<const bf16*>(bu);
  a.bias_v = static_cast<const bf16*>(bv);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.in = Strides{size_t(T) * ld, size_t(dh), ld};
  a.o = Strides{size_t(T) * H * dh, size_t(dh), H * dh};
  a.T = T;
  a.H = H;
  a.dh = dh;
  a.out_bf16 = true;
  if (a.bias_u == nullptr || a.bias_v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<false>(a, B, stream);
}

}  // namespace

// q, k, v [B, T, H·dh] bf16 each
extern "C" int rs_relpos_attention_fused(const void* q, const void* k, const void* v,
                                         const void* pos, const void* bias_u,
                                         const void* bias_v, const void* lengths, void* out,
                                         int B, int T, int H, int dh, void* stream) {
  return launch_fused(q, k, v, pos, bias_u, bias_v, lengths, out, B, T, H, dh, H * dh, stream);
}

// qkv [B, T, 3·H·dh] bf16: q, k, v are its column blocks 0, D and 2D
extern "C" int rs_relpos_attention_fused_packed(const void* qkv, const void* pos,
                                                const void* bias_u, const void* bias_v,
                                                const void* lengths, void* out, int B, int T,
                                                int H, int dh, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int d = H * dh;
  return launch_fused(q, q + d, q + 2 * d, pos, bias_u, bias_v, lengths, out, B, T, H, dh,
                      3 * d, stream);
}

// streamed contract: the same inputs, online softmax over 64-key tiles
extern "C" int rs_relpos_attention_blockwise(const void* qu, const void* qv, const void* k,
                                             const void* v, const void* pos, const void* lengths,
                                             void* out, int B, int T, int H, int dh,
                                             void* stream) {
  return launch_bhtd<false>(qu, qv, k, v, pos, lengths, out, B, T, H, dh, stream);
}
