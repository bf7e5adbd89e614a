// What the three bf16 flash kernels on `wgmma` (flash_fwd_wg_kernel,
// flash_dq_wg_kernel, flash_dkv_wg_kernel) share: the TMA maps of q, k, v
// and do, the shared memory base they align, the one-time setting of their
// shared memory limit.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace fa {

// q and do (B, S, H, hd) and k and v (B, T, Kv, hd), contiguous, as TMA maps
// whose one box is a 64-row canonical tile of one head (hop::make_tile_map).
// The forward has no do: dout == nullptr leaves its map unencoded.
struct FlashMaps {
  CUtensorMap q, k, v, dout;
};

inline int flash_maps(FlashMaps* m, const void* q, const void* k, const void* v,
                      const void* dout, int B, int S, int T, int H, int Kv, int D) {
  int err;
  if ((err = hop::make_tile_map(&m->q, q, D, S, H, B)) ||
      (dout != nullptr && (err = hop::make_tile_map(&m->dout, dout, D, S, H, B))) ||
      (err = hop::make_tile_map(&m->k, k, D, T, Kv, B)) ||
      (err = hop::make_tile_map(&m->v, v, D, T, Kv, B)))
    return err;
  return 0;
}

// The dynamic shared memory limit of `kernel`, set on the current device the
// first time a launcher asks for it (`done`: the launcher's own flags, one a
// device), so that a call's host work is its tensor maps and the launch.
template <typename K>
inline cudaError_t smem_limit_once(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// 64 rows of one head into a canonical tile, one box.
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, int row, int head,
                                         int batch, uint64_t* bar) {
  hop::tma_load(dst, map, bar, 0, row, 0, head, batch);
}

// The dynamic shared memory's first 1024-byte boundary (the 128-byte
// swizzle's period, where every canonical tile starts); a kernel asks for
// 1024 bytes more than it lays out.  An offset from `raw`, so that the
// compiler still knows every pointer derived from it is a shared one (and
// reads them by LDS, not by generic loads).
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// 2^x on the special-function unit, one instruction (results below 2^-126
// flush to 0): exp2f adds a branch and two products a call for them, and the
// elementwise passes run while a product is in flight.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace fa
