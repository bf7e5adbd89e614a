// Hopper (sm_90a) building blocks of the bf16 kernels, all on `wgmma` (the
// SSD chunk's forward and backward, ssd::ssd_chunk_wg_kernel and
// ssd::ssd_chunk_bwd_wg_kernel, and the flash forward and backward,
// fa::flash_fwd_wg_kernel, fa::flash_dq_wg_kernel, fa::flash_dkv_wg_kernel): warpgroup
// products (`wgmma`), tile copies by the Tensor Memory Accelerator (TMA), the
// `mbarrier`s that report them, and on the host the TMA maps of the inputs
// (make_map, make_tile_map, through encode_tiled: the one lookup of
// libcuda's encoder).
//
// Shared tiles, for every operand, are in wgmma's swizzled canonical layout,
// as TMA writes it with CU_TENSOR_MAP_SWIZZLE_{32,64,128}B: a tile of R rows x
// D bf16 columns is ceil(D / 64) sub-tiles of R rows x C = min(D, 64)
// columns, row after row (2 C bytes: the swizzle width), the 16-byte chunks of
// row r permuted by XOR with r's bits (Sw::off); sub-tiles start on 1024
// bytes.  One TMA box of C columns x 64 rows fills 64 rows of a sub-tile.  The
// same tile is read two ways (the descriptor's byte offsets in the terms of
// the PTX ISA):
//   * K-major, the product contracting over the tile's columns (x·dyᵀ): rows
//     2 C bytes apart, 8-row groups at SBO = 16 C; the k-th 16-deep step
//     starts 32 (k mod C / 16) bytes into its sub-tile's rows;
//   * MN-major, contracting over the tile's rows (Pᵀ·dy, transpose bit set):
//     the same SBO, sub-tiles at LBO = R x 2 C bytes; the k-th step starts 16
//     rows further.
// Accumulators (m64nN, fp32): warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4); d[4 b + e] is column 8 b + 2 (lane % 4) + (e & 1)
// of row g + 8 (e >> 1): the C fragments of mma.m16n8k16 side by side, so a
// score tile packed to bf16 is the register A operand of the next product
// (fa::c_to_a), as in FlashAttention-3's backward.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace hop {

using fa::bf16;
using fa::smem_u32;

// ---- mbarrier ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts 2^31 clocks (over a second: a copy or an arrival that never comes)
// traps, so that a fault in the protocol ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// One arrival (no transaction bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// ---- TMA -------------------------------------------------------------------------

// One box of a 5-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) into
// shared memory, completing on `bar`: no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows of a box of a tensor map (make_map, make_tile_map).
constexpr int TMA_ROWS = 64;

// Writes of this thread to shared memory made visible to the async proxy
// (wgmma's operand reads); a barrier among the readers follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over `count` threads (ids 1..15; 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------------

// A D-wide bf16 tile of `rows` rows in the swizzled canonical layout (see
// the top of the file).
template <int D>
struct Sw {
  static constexpr int C = D < 64 ? D : 64;  // columns of a sub-tile
  static constexpr int RB = 2 * C;           // bytes of its row: the swizzle width
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // descriptor's layout
  // byte offset of element (r, c)
  __device__ __forceinline__ static int off(int r, int c, int rows) {
    const int o = r * RB + (c % C) * 2;
    return (c / C) * rows * RB + (o ^ ((o >> 3) & ((RB / 16 - 1) << 4)));
  }
  __device__ __forceinline__ static uint64_t desc(const bf16* p, uint32_t lbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(8 * RB >> 4) << 32) | (MODE << 62);
  }
  // the 16-deep step k of a product contracting over the tile's columns
  // (K-major)
  __device__ __forceinline__ static uint64_t desc_k(const bf16* tile, int k, int rows) {
    return desc(tile + (16 * k / C) * rows * C + 16 * k % C, 16);
  }
  // ... and over its rows (MN-major, transpose bit set): rows 16 k .. 16 k + 15
  __device__ __forceinline__ static uint64_t desc_mn(const bf16* tile, int k, int rows) {
    return desc(tile + 16 * k * C, rows * RB);
  }
};

// The register A operands of every 16-deep step of a product over a D-wide
// 64-row canonical tile's columns: the warp's 16 rows, as wgmma_rs takes them.
template <int D>
__device__ __forceinline__ void tile_a_regs(uint32_t (&a)[D / 16][4], const bf16* tile, int warp,
                                            int lane) {
  const uint8_t* t = reinterpret_cast<const uint8_t*>(tile);
  const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    a[k][0] = *reinterpret_cast<const uint32_t*>(t + Sw<D>::off(r, 16 * k + c, 64));
    a[k][1] = *reinterpret_cast<const uint32_t*>(t + Sw<D>::off(r + 8, 16 * k + c, 64));
    a[k][2] = *reinterpret_cast<const uint32_t*>(t + Sw<D>::off(r, 16 * k + 8 + c, 64));
    a[k][3] = *reinterpret_cast<const uint32_t*>(t + Sw<D>::off(r + 8, 16 * k + 8 + c, 64));
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (after wg_wait, before the next wg_fence).
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) += A · B, one 16-deep step, bf16 operands: `wgmma_ss` with
// A and B by descriptor, `wgmma_rs` with A in registers (four bf16 pairs a
// thread, the mma.m16n8k16 A fragment of the warp's 16 rows).  TB = 1 reads B
// MN-major (transposed).  scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// ---- TMA maps, on the host ---------------------------------------------------------

// cuTensorMapEncodeTiled of libcuda, reached through the runtime's entry-point
// query (the libraries link nothing new).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The TMA map of a bf16 input of D contiguous columns and four more logical
// dims (row, head, chunk, batch; any of extent 1) of extents `ext` and
// strides `str` (elements): dim 0 the D columns, then the other four by
// stride, a dim of extent 1 last; boxes of min(D, 64) columns x TMA_ROWS rows,
// swizzled (64 rows of one sub-tile of a canonical tile; rows past ext[0]
// read as zeros).  `ord[k]` gets which logical dim dim k + 1 is.
static inline int make_map(CUtensorMap* map, int* ord, const void* base, int D,
                           const int64_t (&ext)[4], const int64_t (&str)[4]) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  int64_t key[4], big = 16;
  for (int i = 0; i < 4; ++i) {
    key[i] = ext[i] == 1 ? INT64_MAX : str[i];
    if (ext[i] > 1 && 2 * str[i] > big) big = 2 * str[i];
  }
  int idx[4] = {0, 1, 2, 3};
  for (int i = 1; i < 4; ++i)
    for (int k = i; k > 0 && key[idx[k]] < key[idx[k - 1]]; --k) {
      const int tmp = idx[k];
      idx[k] = idx[k - 1];
      idx[k - 1] = tmp;
    }
  cuuint64_t gdim[5] = {(cuuint64_t)D, 1, 1, 1, 1}, gstr[4];
  const int C = D < 64 ? D : 64;
  cuuint32_t box[5] = {(cuuint32_t)C, 1, 1, 1, 1}, es[5] = {1, 1, 1, 1, 1};
  for (int k = 0; k < 4; ++k) {
    const int i = idx[k];
    gdim[k + 1] = (cuuint64_t)ext[i];
    gstr[k] = (cuuint64_t)(ext[i] == 1 ? big : 2 * str[i]);
    box[k + 1] = i == 0 ? TMA_ROWS : 1;
    ord[k] = i;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), gdim,
                         gstr, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         C == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous bf16 input (batch, rows, heads, D) as a TMA map whose one box
// is a whole 64-row canonical tile of one head: dims (C = min(D, 64)
// columns, row, sub-tile, head, batch), box (C, TMA_ROWS, D / C, 1, 1), so
// that the box's sub-tiles land TMA_ROWS x C apart, as Sw lays them out.
static inline int make_tile_map(CUtensorMap* map, const void* base, int D, int64_t rows,
                                int64_t heads, int64_t batch) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int C = D < 64 ? D : 64;
  cuuint64_t gdim[5] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)(D / C), (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t gstr[4] = {(cuuint64_t)(2 * heads * D), (cuuint64_t)(2 * C), (cuuint64_t)(2 * D),
                        (cuuint64_t)(2 * rows * heads * D)};
  cuuint32_t box[5] = {(cuuint32_t)C, TMA_ROWS, (cuuint32_t)(D / C), 1, 1};
  cuuint32_t es[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), gdim,
                         gstr, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         C == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hop
