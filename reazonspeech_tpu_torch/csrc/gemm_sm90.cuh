// A GEMM mainloop for Hopper (sm_90a): TMA loads into a ring of shared-memory
// stages, wgmma in two consumer warpgroups, one persistent block per SM
// (plain C interface, no PyTorch headers).
//
// C[m, n] = Σ_k A[m, k] · B[k, n] with A [M, K] bf16 row-major (K-major) and
// B [K, N] bf16 row-major (N contiguous: read as wgmma's MN-major operand
// through its transpose bit, so no weight is transposed or copied), fp32
// accumulators in registers. A block has three warpgroups:
//
// - warpgroup 0, the producer: one thread issues the TMA copies of a
//   BM x BK tile of A and a BK x BN tile of B into the next free stage and
//   arms the stage's "full" mbarrier with their bytes; it runs ahead of the
//   consumers across k-steps and output tiles, as far as the ring allows.
// - warpgroups 1 and 2, the consumers: each owns 64 rows of the BM = 128-row
//   output tile, waits on a stage's "full" barrier, issues BK / 16
//   wgmma.m64nBNk16 on it, keeps one k-step's products in flight and frees
//   the stage before (all 256 consumer threads arrive on its "empty"
//   barrier) once their products are done. After the last k-step the
//   caller's epilogue turns the accumulators into output values with a
//   per-column fp32 value (the bias: read from global memory when the tile
//   starts, staged in shared memory for the epilogue) and, in the paired
//   form, a per-row value (a length mask), and the warpgroup writes them in
//   the epilogue's output type (bf16 or fp32) into its own 64-row staging
//   tile in shared memory; one thread then hands that tile to TMA stores
//   (asynchronous: the warpgroup goes on to the next tile's products while
//   they drain) and, before the tile after, waits until the stores have read
//   it. At the nemo FFN-in shape, stores from the registers straight to
//   global memory (4 bytes a thread, scattered over 8 rows a warp) took
//   longer than the products, and so did the bias read from global memory in
//   the epilogue.
//
// The paired form (the GLU of the conv module): the B tile holds BN / 2
// columns of one operand and the same BN / 2 columns of a second one (two
// tensor maps, e.g. the value and gate halves of one [D, 2D] weight), so
// that a consumer thread holds accumulator column c and its partner c + BN / 2
// (wgmma fragment groups j and j + BN / 16) and the epilogue combines them in
// registers into BN / 2 output columns.
//
// Shared memory: both operands arrive with the 128-byte swizzle, in boxes
// 64 bf16 (128 bytes) wide: A as [BM][64] (K-major: the k-th 16-column slice
// is the descriptor's start + 32·k bytes), B as BN / 64 boxes of [BK][64]
// (MN-major: the descriptor's leading byte offset steps from one 64-column
// box to the next, its stride byte offset from one group of 8 k-rows to the
// next). The staging tiles use the same swizzle (conflict-free writes from
// wgmma's fragment), in boxes of 128-byte rows: [64][64] bf16 or [64][32]
// fp32; a consumer's 64 x BN bf16 tile and its 64 x BN / 2 fp32 paired tile
// take the same bytes. Ragged edges cost nothing here: each tensor map
// carries its true extent, TMA loads fill the rows and columns past it
// with zeros and TMA stores leave them out.
//
// The register budget: 384 threads at one block per SM leave 168 registers a
// thread; the producer gives back all but 40 (setmaxnreg) so that each
// consumer thread may hold 232, a BN = 256 tile's 128 fp32 accumulators
// among them.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only: nothing links libcuda)

#include "common.cuh"

namespace rs {
namespace sm90 {

constexpr int BM = 128;         // output rows a block computes at a time: two warpgroups x 64
constexpr int BK = 64;          // k-step: one 128-byte swizzle row of bf16
constexpr int BOX = 64;         // bf16 columns of one TMA box (128 bytes)
constexpr int NT = 384;         // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;  // threads that arrive on an "empty" barrier

template <int BN>
struct Config {
  static_assert(BN == 128 || BN == 256, "wgmma tiles of 128 or 256 columns");
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = 160 * 1024 / STAGE_BYTES;  // 5 at BN = 128, 3 at 256
  static constexpr int OUT_BYTES = 64 * BN * 2;  // a consumer's staging tile (64 x BN bf16)
  // 1024 bytes of slack to align the ring (the swizzle repeats every 1024
  // bytes), the ring, two staging tiles and two tiles' column values, a
  // "full" and an "empty" barrier a stage
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + 2 * OUT_BYTES + 2 * BN * 4 + 2 * STAGES * 8;
  static constexpr int ACC = BN / 2;  // fp32 accumulators of a consumer thread
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive and add ``bytes`` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bar.sync on a named barrier (id >= 1) of ``threads`` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// make this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one box of shared memory to a 2-D tensor map at (column c0, row c1)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the committed stores have read their shared memory (it may be rewritten)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// the committed stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// one box of a 2-D tensor map at (column c0, row c1) into shared memory,
// completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at ``p``:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) · B (16 x BN, MN-major), both in shared memory
// behind their descriptors; bf16 in, fp32 accumulators
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// one output tile: rows from m0, columns from n0 of B operand b (an index
// into the caller's tensor maps of B and of the output)
struct Tile {
  int m0, b, n0;
};

// output columns c and c + 1 (c even) of row r into a staging tile of
// 128-byte swizzled boxes [64][128 / sizeof(Out)]
template <typename Out>
__device__ __forceinline__ void stage_pair(unsigned char* tile, int r, int c, float v0, float v1) {
  constexpr int BOXC = 128 / sizeof(Out);
  const int byte = (c % BOXC) * static_cast<int>(sizeof(Out));
  unsigned char* p =
      tile + (c / BOXC) * (64 * 128) + r * 128 + (((byte >> 4) ^ (r % 8)) << 4) + (byte & 15);
  if constexpr (sizeof(Out) == 4)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The persistent GEMM. ``sched.tiles()`` output tiles, tile t at
// ``sched(t)``; block i takes tiles i, i + gridDim.x, ... . ``a`` maps A
// ([M, K], boxes of [BM][BOX]), ``out[tile.b]`` the output ([M, N] of
// Epilogue::Out, boxes of [64][128 / sizeof(Out)]), all 128-byte swizzled;
// ``k_tiles`` = ceil(K / BK), ``M`` the rows. B ([K, N], boxes of [BK][BOX]):
// ``b[tile.b]`` holds the tile's BN columns from tile.n0, or, with
// Epilogue::PAIRED, ``b[2·tile.b]`` its first BN / 2 columns and
// ``b[2·tile.b + 1]`` its last BN / 2, both from tile.n0. The epilogue:
// ``column(tile, i)`` the fp32 value of the tile's B column i (0 <= i < BN;
// 0 past the operand's width), ``cols(tile)`` the output's width; unpaired,
// ``epilogue(v, c)`` the output of accumulator v in a column of value c, an
// output tile of BN columns; paired, ``row(m)`` a value of output row m and
// ``epilogue(a, ca, g, cg, r)`` the output from accumulator a of B column i
// < BN / 2 and g of column i + BN / 2 (values ca, cg) on a row of value r,
// an output tile of BN / 2 columns. Launch with NT threads and
// Config<BN>::SMEM_BYTES of dynamic shared memory.
template <int BN, class Sched, class Epilogue>
__device__ __forceinline__ void gemm_persistent(const CUtensorMap* a, const CUtensorMap* b,
                                                const CUtensorMap* out, int k_tiles, int M,
                                                const Sched& sched, const Epilogue& epilogue) {
  using C = Config<BN>;
  using Out = typename Epilogue::Out;
  constexpr bool PAIRED = Epilogue::PAIRED;
  constexpr int OUT_COLS = PAIRED ? BN / 2 : BN;  // output columns of a tile
  constexpr int BOXC = 128 / sizeof(Out);         // output columns of a 128-byte box
  static_assert(64 * OUT_COLS * sizeof(Out) == C::OUT_BYTES, "staging tile size");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = ring + C::STAGES * C::STAGE_BYTES;  // two 64-row tiles
  float* columns = reinterpret_cast<float*>(staging + 2 * C::OUT_BYTES);  // two [BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(columns + 2 * BN);
  uint64_t* empty = full + C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < sched.tiles(); t += gridDim.x) {
        const Tile tile = sched(t);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * C::STAGE_BYTES;
          mbar_expect_tx(&full[stage], C::STAGE_BYTES);
          tma_load(st, a, &full[stage], kt * BK, tile.m0);
#pragma unroll
          for (int h = 0; h < BN / BOX; ++h) {
            constexpr int HALF = BN / (2 * BOX);  // boxes of one operand in the paired form
            const CUtensorMap* map = PAIRED ? b + 2 * tile.b + h / HALF : b + tile.b;
            const int col = tile.n0 + (PAIRED ? h % HALF : h) * BOX;
            tma_load(st + C::A_BYTES + h * BK * BOX * 2, map, &full[stage], col, kt * BK);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // the consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = wg - 1, t128 = threadIdx.x % 128, lane = t128 % 32;
    unsigned char* my_out = staging + cw * C::OUT_BYTES;
    float* my_columns = columns + cw * BN;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < sched.tiles(); t += gridDim.x) {
      const Tile tile = sched(t);
      float column[BN / 128];  // read now, used after the products
#pragma unroll
      for (int i = 0; i < BN / 128; ++i) column[i] = epilogue.column(tile, t128 + 128 * i);
      float acc[C::ACC];
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0.0f;
      int held = -1;  // the stage whose products may still be in flight
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * C::STAGE_BYTES;
        const uint64_t da = desc_sw128(st + cw * 64 * BK * 2, 16, 8 * BK * 2);
        const uint64_t db = desc_sw128(st + C::A_BYTES, BK * BOX * 2, 8 * BOX * 2);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 columns of A (32 bytes), 16 rows of B
          mma<BN>(acc, da + ((kk * 32) >> 4), db + ((kk * 16 * BOX * 2) >> 4));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous k-step's products are done: free its stage
        if (held >= 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0) mbar_arrive(&empty[held]);

      // the column values are free once every thread has passed the previous
      // tile's second barrier below; the staging tile once the previous
      // tile's stores have read it
#pragma unroll
      for (int i = 0; i < BN / 128; ++i) my_columns[t128 + 128 * i] = column[i];
      if (t128 == 0) tma_store_wait_read();
      named_sync(1 + cw, 128);
      // accumulator i holds row 16·warp + lane / 4 + 8·((i / 2) % 2) and
      // column 8·(i / 4) + 2·(lane % 4) + i % 2 of the warpgroup's 64 x BN
      // (wgmma's f32 fragment): fragment group j = i / 4 covers columns
      // 8j .. 8j + 7, and in the paired form group j + BN / 16 holds the
      // partners of group j's columns
      const int r0 = 16 * (t128 / 32) + lane / 4, q = lane % 4;
      if constexpr (PAIRED) {
        const int m = tile.m0 + 64 * cw + r0;
        const float rv[2] = {epilogue.row(m), epilogue.row(m + 8)};
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          const int c = 8 * j + 2 * q, p = 4 * (j + BN / 16);
          const float2 ca = *reinterpret_cast<const float2*>(my_columns + c);
          const float2 cg = *reinterpret_cast<const float2*>(my_columns + BN / 2 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            stage_pair<Out>(my_out, r0 + 8 * h, c,
                            epilogue(acc[4 * j + 2 * h], ca.x, acc[p + 2 * h], cg.x, rv[h]),
                            epilogue(acc[4 * j + 2 * h + 1], ca.y, acc[p + 2 * h + 1], cg.y, rv[h]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 cv = *reinterpret_cast<const float2*>(my_columns + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            stage_pair<Out>(my_out, r0 + 8 * h, c, epilogue(acc[4 * j + 2 * h], cv.x),
                            epilogue(acc[4 * j + 2 * h + 1], cv.y));
        }
      }
      fence_async_smem();
      named_sync(1 + cw, 128);
      const int row = tile.m0 + 64 * cw, cols = epilogue.cols(tile);
      if (t128 == 0 && row < M) {
#pragma unroll
        for (int h = 0; h < OUT_COLS / BOXC; ++h)
          if (tile.n0 + h * BOXC < cols)
            tma_store(out + tile.b, my_out + h * (64 * 128), tile.n0 + h * BOXC, row);
        tma_store_commit();
      }
    }
    if (t128 == 0) tma_store_wait();
  }
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API symbol, taken through the runtime so
// that the library links without libcuda; null where the driver lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [rows, cols] matrix of bf16 (``f32``
// false) or fp32 elements with a row stride of ``ld`` elements (ld and the
// base 16-byte aligned: TMA needs 16-byte strides), in boxes of
// [box_rows][128 bytes], 128-byte swizzled; past its edges TMA reads zeros
// and stores nothing. Returns 0 or a CUDA error.
inline int encode_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                      int box_rows, bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// tile-columns of work in whole waves over ``sms`` SMs: ceil(tiles / sms)
// x bn, the rule that picks a GEMM's column tile (the wider one on a tie)
inline int wave_cost(int tiles, int bn, int sms) { return (tiles + sms - 1) / sms * bn; }

// The column tile every GEMM of the library launches with when forced (128
// or 256; 0: chosen per shape), set by rs_gemm_force_tile_n for tests and
// timing. Inline: one variable for all the sources that include this.
inline int g_force_tile_n = 0;

// the forced column tile, else 256 unless 128 costs fewer whole waves
inline int pick_tile_n(int cost256, int cost128) {
  return g_force_tile_n ? g_force_tile_n : (cost256 <= cost128 ? 256 : 128);
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace sm90
}  // namespace rs
