// Rel-pos attention: the C entry of the single-pass contract (the kernel
// and its design: relpos_attention.cuh), compiled apart from the other
// three entries so that nvcc builds the two halves of the templates side by
// side.
//
// Replaces: reazonspeech_tpu/ops/relpos_attention.py, Pallas TPU kernel
// relpos_attention (:76).

#include "relpos_attention.cuh"

// single-pass contract: qu, qv, k, v [B, H, T, dh] bf16, out fp32;
// probabilities normalised before the bf16 cast (two key sweeps)
extern "C" int rs_relpos_attention(const void* qu, const void* qv, const void* k, const void* v,
                                   const void* pos, const void* lengths, void* out, int B, int T,
                                   int H, int dh, void* stream) {
  return launch_bhtd<true>(qu, qv, k, v, pos, lengths, out, B, T, H, dh, stream);
}
