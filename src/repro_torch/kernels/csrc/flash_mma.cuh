// Register-level building blocks of the bf16 kernels on `wgmma` (hopper.cuh):
// bf16 packing, the repacking of a score tile into an A operand (c_to_a),
// ldmatrix.trans, and sums and maxima over the 4 lanes of a quad.
//
// wgmma's fp32 accumulators and its register A operand use the fragment
// layouts of `mma.m16n8k16` (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4, for each warp's 16 rows:
//   A (16 x 16, row major), 4 registers of two bf16:
//     a0 = (row g,   k 2t..2t+1)   a1 = (row g+8, k 2t..2t+1)
//     a2 = (row g,   k 2t+8..+9)   a3 = (row g+8, k 2t+8..+9)
//   C (16 x 8, fp32), 4 floats:  c0, c1 = (row g, col 2t, 2t+1)
//                                c2, c3 = (row g+8, col 2t, 2t+1)
// So the C fragments of two neighbouring 8-column tiles are, packed to bf16,
// exactly the A fragment of the 16-deep step over those 16 columns: a score
// tile turns into the left operand of the next product without leaving the
// registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 contiguous bytes).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// 16-byte alignment of every pointer a TMA map or a 16-byte access starts from.
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace fa
