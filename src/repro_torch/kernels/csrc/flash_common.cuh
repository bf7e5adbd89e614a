// Shared building blocks of the three flash-attention kernels (forward, dq,
// dk/dv).
//
// All three have the same shape.  A block of 256 threads (16 x 16) owns a
// tile of rows that stays in shared memory for its whole life (Q for forward
// and dq, K/V for dk/dv) and streams the tiles of the other side through
// shared memory one after the other.  For every pair of tiles it
//   1. forms a score tile  A·Bᵀ  (tile_dot: each thread a small register
//      micro-tile, both operands read from shared memory as float4 along hd),
//   2. turns it into probabilities / score gradients in registers and writes
//      them to a small shared tile,
//   3. multiplies that tile into a streamed tile (tile_accum) and adds the
//      product to accumulators that live in registers until the end.
// Thread (ty, tx) owns rows ty, ty+16, ... of the block's tile in steps 1-3,
// so the 16 threads with one ty — half a warp — hold a whole score row
// between them: row maxima and sums are shuffles, and the shared score tile
// is written and read by the same warp (a __syncwarp, no block barrier).
//
// Inputs, shared tiles, products and sums are all fp32: IEEE fp32 FMAs, for
// the fp32 parity of the plain versions.  The three flash kernels (and the
// SSD chunk's) take this path for fp32 inputs only; their bf16 inputs go to
// kernels on wgmma fed by TMA (flash_wg.cuh, hopper.cuh).
// Rows are padded by 4 floats so that float4 reads of 8 neighbouring rows fall
// into 8 different 16-byte bank groups.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int NT = 256;  // threads per block: 16 (ty) x 16 (tx)
// Finite on purpose (as in the TPU kernels): a row whose keys are all masked
// in the tiles seen so far keeps m = NEG_INF, and exp(NEG_INF - m_new) wipes
// it to 0 once a real key arrives; with -inf the same spot would be NaN.
constexpr float NEG_INF = -0.7f * 3.402823466e+38f;

// ---- 4-wide loads and stores -------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }

template <int E>
__device__ __forceinline__ float elem(const float4& v) {
  return E == 0 ? v.x : (E == 1 ? v.y : (E == 2 ? v.z : v.w));
}

// ---- global -> shared ------------------------------------------------------

// Copy ROWS rows of D elements (row stride `stride` elements) into an fp32
// shared tile with row stride D + 4.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += NT) {
    const int r = idx / V;
    const int c = (idx % V) * 4;
    st4(dst + r * (D + 4) + c, ld4(src + (int64_t)r * stride + c));
  }
}

// ---- score tile: acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] -------

template <int D, int NR, int NC>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float (&acc)[NR][NC]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[NR], b[NC];
#pragma unroll
    for (int i = 0; i < NR; ++i) a[i] = ld4(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = ld4(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// ---- output columns of a thread --------------------------------------------
// A thread owns D/16 columns of each of its rows.  For D >= 64 they are D/64
// groups of 4 neighbouring columns, group g at (tx + 16 g) * 4, so that shared
// reads and global writes are 16 bytes a thread on neighbouring addresses; for
// D < 64 they are single columns tx + 16 j.

// One key row of tile_accum: o[i][j] += p[i].<NN> * vrow[column j of the thread].
template <int D, int NR, int NN>
__device__ __forceinline__ void accum_step(const float4 (&p)[NR], const float* vrow, int tx,
                                           float (&o)[NR][D / 16]) {
  constexpr int CPT = D / 16;
  if constexpr (CPT >= 4) {
#pragma unroll
    for (int g = 0; g < CPT / 4; ++g) {
      const float4 vv = ld4(vrow + (tx + 16 * g) * 4);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float pv = elem<NN>(p[i]);
        o[i][4 * g + 0] = fmaf(pv, vv.x, o[i][4 * g + 0]);
        o[i][4 * g + 1] = fmaf(pv, vv.y, o[i][4 * g + 1]);
        o[i][4 * g + 2] = fmaf(pv, vv.z, o[i][4 * g + 2]);
        o[i][4 * g + 3] = fmaf(pv, vv.w, o[i][4 * g + 3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float vv = vrow[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NR; ++i) o[i][j] = fmaf(elem<NN>(p[i]), vv, o[i][j]);
    }
  }
}

// o[i][j] += sum_n P[ty + 16 i][n] * V[n][column j of the thread], n < BC.
// P has row stride LDP (a multiple of 4), V has row stride D + 4.
template <int D, int NR, int BC, int LDP>
__device__ __forceinline__ void tile_accum(const float* P, const float* V, int ty, int tx,
                                           float (&o)[NR][D / 16]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int n = 0; n < BC; n += 4) {
    float4 p[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) p[i] = ld4(P + (ty + 16 * i) * LDP + n);
    const float* v0 = V + n * LD;
    accum_step<D, NR, 0>(p, v0, tx, o);
    accum_step<D, NR, 1>(p, v0 + LD, tx, o);
    accum_step<D, NR, 2>(p, v0 + 2 * LD, tx, o);
    accum_step<D, NR, 3>(p, v0 + 3 * LD, tx, o);
  }
}

// Write a thread's rows: dst points at row 0 of the block's tile, column 0.
// Row i of the thread is multiplied by mul[i] on the way out.
template <int D, int NR>
__device__ __forceinline__ void store_rows(float* dst, int64_t stride, int ty, int tx,
                                           const float (&o)[NR][D / 16],
                                           const float (&mul)[NR]) {
  constexpr int CPT = D / 16;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float* row = dst + (int64_t)(ty + 16 * i) * stride;
    if constexpr (CPT >= 4) {
#pragma unroll
      for (int g = 0; g < CPT / 4; ++g) {
        st4(row + (tx + 16 * g) * 4,
            make_float4(o[i][4 * g] * mul[i], o[i][4 * g + 1] * mul[i],
                        o[i][4 * g + 2] * mul[i], o[i][4 * g + 3] * mul[i]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) st1(row + tx + 16 * j, o[i][j] * mul[i]);
    }
  }
}

// ---- masking ---------------------------------------------------------------

// Key k is visible from the query at absolute position qpos.
__device__ __forceinline__ bool visible(int qpos, int k, int causal, int window) {
  return (!causal || k <= qpos) && (window <= 0 || qpos - k < window);
}

// Sum / max over the 16 lanes that share one ty (half a warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int s = 8; s >= 1; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int s = 8; s >= 1; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Range of streamed key tiles [lo, hi) that a block of query rows
// [q0, q0 + BM) can see (absolute positions q + off), in tiles of BN keys.
__device__ __forceinline__ void key_tile_range(int q0, int BM, int BN, int off, int T,
                                               int causal, int window, int* lo, int* hi) {
  int first = 0;
  if (window > 0) first = max(0, q0 + off - window + 1);
  int last = T;  // exclusive
  if (causal) last = min(T, q0 + BM + off);
  *lo = first / BN;
  *hi = (last + BN - 1) / BN;
}

// Range of streamed query tiles [lo, hi) that can see a block of keys
// [k0, k0 + BN), in tiles of BM query rows.
__device__ __forceinline__ void query_tile_range(int k0, int BN, int BM, int off, int S,
                                                 int causal, int window, int* lo, int* hi) {
  int first = 0;
  if (causal) first = max(0, k0 - off);
  int last = S;  // exclusive
  if (window > 0) last = min(S, k0 + BN - 1 + window - off);
  *lo = first / BM;
  *hi = last <= first ? *lo : (last + BM - 1) / BM;
}

}  // namespace fa

// Dispatch on the head dim to a launcher template LAUNCH<D>(args...); any
// other head dim returns cudaErrorInvalidValue.  The one list of the head
// dims the kernels are instantiated for (HEAD_DIMS in flash_attention.py).
#define FA_SWITCH_HD(LAUNCH, hd, ...)            \
  do {                                           \
    switch (hd) {                                \
      case 16: return LAUNCH<16>(__VA_ARGS__);   \
      case 32: return LAUNCH<32>(__VA_ARGS__);   \
      case 64: return LAUNCH<64>(__VA_ARGS__);   \
      case 128: return LAUNCH<128>(__VA_ARGS__); \
      case 256: return LAUNCH<256>(__VA_ARGS__); \
    }                                            \
    return (int)cudaErrorInvalidValue;           \
  } while (0)
