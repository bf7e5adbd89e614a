// Tensor-core building blocks of the bf16 kernels on mma.sync
// (flash_fwd_tc_kernel, ssd_chunk_tc_kernel), and the bf16 packing (pack_bf16,
// c_to_a) that the wgmma kernels share (hopper.cuh).
//
// Products are `mma.sync.aligned.m16n8k16` with bf16 operands and fp32
// accumulators; operands reach registers from shared memory by `ldmatrix`,
// and tiles reach shared memory from device memory by 16-byte `cp.async`.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 registers of two bf16:
//     a0 = (row g,   k 2t..2t+1)   a1 = (row g+8, k 2t..2t+1)
//     a2 = (row g,   k 2t+8..+9)   a3 = (row g+8, k 2t+8..+9)
//   B (16 x 8), 2 registers:  b0 = (k 2t..2t+1, col g)   b1 = (k 2t+8..+9, col g)
//   C (16 x 8, fp32), 4 floats:  c0, c1 = (row g, col 2t, 2t+1)
//                                c2, c3 = (row g+8, col 2t, 2t+1)
// So the C fragments of two neighbouring 8-column tiles are, packed to bf16,
// exactly the A fragment of the 16-deep step over those 16 columns: a score
// tile turns into the left operand of the next product without leaving the
// registers.
//
// Shared tiles are row major with a row stride of D + 8 bf16 (16 bytes of
// padding): the 8 row addresses of one ldmatrix then fall into 8 different
// 16-byte bank groups for every D the kernels take.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16 bytes from device memory to shared memory -----------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy ROWS rows of D bf16 (row stride `stride` elements in device memory)
// into a shared tile with row stride LD, NTH threads taking 16 bytes each.
template <int D, int LD, int ROWS, int NTH>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int64_t stride) {
  constexpr int V = D / 8, N = ROWS * V;
#pragma unroll
  for (int i = 0; i < (N + NTH - 1) / NTH; ++i) {
    const int idx = threadIdx.x + i * NTH;
    if (N % NTH == 0 || idx < N) {
      const int r = idx / V, c = (idx % V) * 8;
      cp_async16(dst + r * LD + c, src + r * stride + c);
    }
  }
}

// ---- ldmatrix ------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The lane's address for the A fragment of rows [0, 16), k [k0, k0 + 16) of
// a row-major tile (rows = M, columns = K).
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld, int k0, int lane) {
  return tile + (lane & 15) * ld + k0 + (lane >> 4) * 8;
}
// The same A fragment from a tile stored with one row per k (rows = K,
// columns = M; the Bᵀ·x style of a product over the tile's rows), read by
// ldsm_x4_t: matrices (m, k) = (0, 0), (8, 0), (0, 8), (8, 8) of the step.
__device__ __forceinline__ const bf16* at_addr(const bf16* tile, int ld, int m0, int k0,
                                               int lane) {
  return tile + (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 + ((lane >> 3) & 1) * 8;
}
// B fragments of two 8-column tiles [n0, n0 + 16), k [k0, k0 + 16), from a
// tile stored with one row per output column (rows = N, columns = K; k·qᵀ
// style), read by ldsm_x4: {b0, b1} of columns n0.., {b0, b1} of n0 + 8...
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld, int n0, int k0,
                                               int lane) {
  return tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// The same from a tile stored with one row per k (rows = K, columns = N;
// p·v style), read by ldsm_x4_t (or ldsm_x2_t for one 8-column tile).
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int ld, int n0, int k0,
                                              int lane) {
  return tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8;
}

// ---- the product -----------------------------------------------------------------

// c += a · b, one 16 x 8 x 16 step, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16-deep step over columns [16 j, 16 j + 16) of a
// 16-row fp32 C tile held as 8-column fragments c[2 j], c[2 j + 1] (4 floats
// each; wgmma's accumulators are such fragments side by side).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Max / sum over the 4 lanes of a quad (the lanes that share a row g).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16-byte alignment of every pointer the tensor-core kernels copy with cp.async.
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace fa
