// Warp-level tensor-core and copy helpers shared by the register-resident
// attention kernels (relpos_attention.cu, zipformer_attention.cu):
// mma.sync.m16n8k16 on bf16, ldmatrix, cp.async, a 4-D TMA box load, and
// the quad reductions of an m16n8 accumulator's rows.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: nothing links libcuda)

#include "common.cuh"

namespace rs {

template <int N>  // a compile-time int as a type (a sweep's phase, a copy width, a half)
struct Tag {
  static constexpr int value = N;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) from global to shared memory, asynchronously; the
// bytes past ``src_bytes`` are zero (0: all zero, nothing read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_u32(dst)), "l"(src),
               "n"(BYTES), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory, completing on the mbarrier ``bar``
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ldmatrix at a shared-window address (smem_u32 of a pointer, plus bytes)
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_at(r, smem_u32(p));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_trans_at(r, smem_u32(p));
}

// d += a (16 x 16, row) · b (16 x 8, col): bf16 in, fp32 accumulators. The
// fragments (thread = 4·gid + tig): a {row gid, gid + 8} x {cols 2tig, 2tig+1,
// then +8}; b {k 2tig, 2tig+1, then +8} x {col gid}; d rows gid (d0, d1) and
// gid + 8 (d2, d3), cols 2tig and 2tig + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max and sum over the 4 threads of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the max of a thread's 2·NJ scores of accumulator row h (h = 0: row gid,
// 1: gid + 8) over NJ n8 tiles, as a tree
template <int NJ>
__device__ __forceinline__ float row_max(const float (&s)[NJ][4], int h) {
  float m[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) m[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
  for (int w = NJ / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
  return m[0];
}

}  // namespace rs
