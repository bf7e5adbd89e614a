// RMSNorm for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm.py (called from `rmsnorm`): per row of x (rows, d)
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// with the statistics, the rsqrt and both products in fp32 and one cast on
// store (the kernel's rounding order, not the model's `layers.rmsnorm`).  The
// TPU kernel has no backward (JAX differentiates the reference); this file
// adds the gradient of the same function, with r = rsqrt(mean(x^2) + eps),
// w = 1 + scale and g = dy in fp32:
//   dx     = r w g - x r^3 mean(w g x)      cast once to x's dtype
//   dscale = sum over rows of g x r         fp32
//
// What bounds it on this card: bytes.  The forward reads x and writes y, the
// backward reads x and dy and writes dx, each once, at about 4 and 10 fp32
// operations an element, some 100 times below the card's balance point; at
// 16384 rows of d = 4096 in bf16 the bounds are 0.080 and 0.120 ms.
// What the design does about it: one pass over device memory, kept busy.
// * Persistent blocks walk rows (grid: SMs x resident blocks), so w = 1 + scale
//   is read once a block into registers, not once a row from L2.
// * A row is held in registers between its sums and its store, x (and dy)
//   read once.  A row group of TPR threads owns a row; TPR (32 to 256) is the
//   smallest that leaves each thread at most FWD_VMAX (2) vectors of 8
//   elements (16 bytes of bf16) in the forward, BWD_VMAX (4) in the backward
//   (forward d = 1152, 2048, 4096: 128, 128, 256 threads; backward: 64, 64,
//   128); a row wider than 256 threads' worth takes 8 vectors a thread.  A
//   thread keeps the same columns from row to row, the columns of its w.
// * Rows go through a ring of registers: each row group has the next rows'
//   loads in flight while it reduces and stores the current one (3 rows in
//   the forward, 2 in the backward, which holds x and dy).
// * Loads and stores are 16 bytes a thread on neighbouring addresses, with
//   the streaming (evict-first) hint (vec16.cuh).
// * The backward recomputes r from the row it holds (the forward saves
//   nothing).  Each thread sums g x r of its columns over its rows in
//   registers; a block adds its row groups in shared memory and writes one
//   partial row; a second small launch adds the partials in a fixed order, so
//   dscale is the same from run to run (no atomics).
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace rn {

using vec16::Raw;
using vec16::VEC;
using vec16::ld;
using vec16::st;
using vec16::widen;
using vec16::zero;

constexpr int NT = 256;  // threads per block
constexpr int MAX_D = NT * VEC * 8;
// Vectors a thread holds of a row at most, rows a row group keeps in
// registers (the current one and those in flight), and the resident blocks a
// bf16 kernel asks of the register allocator.  Chosen on the H100 among 2-5
// vectors, 1-4 rows and 1-4 blocks at d = 1152, 2048 and 4096 (PERF.md).
constexpr int FWD_VMAX = 2, FWD_DEPTH = 3, FWD_MINB = 3;
constexpr int BWD_VMAX = 4, BWD_DEPTH = 2, BWD_MINB = 1;

// vector k of thread t of a row group is column vector t + k * TPR
template <typename T, int TPR, int MAXV>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int64_t row, int64_t rows,
                                         int d, int t, Raw<T> (&r)[MAXV]) {
  const int nv = d / VEC;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int c = t + k * TPR;
    if (row < rows && c < nv)
      ld(src + row * d + (int64_t)c * VEC, r[k]);
    else
      zero(r[k]);
  }
}

// w = 1 + scale on the thread's columns (0 past the row's end)
template <int TPR, int MAXV>
__device__ __forceinline__ void load_weight(const float* __restrict__ scale, int d, int t,
                                            float (&w)[MAXV][VEC]) {
  const int nv = d / VEC;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int c = t + k * TPR;
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[k][e] = c < nv ? 1.f + __ldg(scale + c * VEC + e) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The row group's sum of v, the same in every thread of the group.  red: one
// slot a warp, alternated between calls by the caller so that one barrier a
// row suffices.  Every thread of the block calls it the same number of times.
template <int TPR>
__device__ __forceinline__ float2 row_sum(float2 v, float2* red) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if constexpr (TPR > 32) {
    constexpr int WPR = TPR / 32;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    const float2* mine = red + (threadIdx.x / TPR) * WPR;
    v = mine[0];
#pragma unroll
    for (int i = 1; i < WPR; ++i) {
      v.x += mine[i].x;
      v.y += mine[i].y;
    }
  }
  return v;
}

// launch bounds: bf16 asks FWD_MINB / BWD_MINB blocks an SM of the register
// allocator; fp32 holds twice the bytes in its registers and asks 1
template <typename T, int TPR, int MAXV>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? FWD_MINB : 1)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               int64_t rows, int d, float eps) {
  constexpr int G = NT / TPR;  // rows a block holds at once
  constexpr int DEPTH = FWD_DEPTH;
  __shared__ float2 red[2][NT / 32];
  const int t = threadIdx.x % TPR;
  const int grp = threadIdx.x / TPR;
  const int nv = d / VEC;
  float w[MAXV][VEC];
  load_weight<TPR, MAXV>(scale, d, t, w);

  // a ring of DEPTH rows in registers: row i of the group's walk sits in
  // buf[i % DEPTH] from DEPTH - 1 rows before it is used
  const int64_t step = (int64_t)gridDim.x * G;
  const int64_t first = (int64_t)blockIdx.x * G + grp;
  Raw<T> buf[DEPTH][MAXV];
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) load_row<T, TPR, MAXV>(x, first + s * step, rows, d, t, buf[s]);
  int it = 0;
  // base: the block's first row of the round, the same in every thread
  for (int64_t base = (int64_t)blockIdx.x * G; base < rows; base += DEPTH * step) {
#pragma unroll
    for (int s = 0; s < DEPTH; ++s, ++it) {
      if (base + s * step >= rows) break;
      const int64_t row = base + s * step + grp;
      // the row DEPTH - 1 ahead goes into the slot freed by the last round
      load_row<T, TPR, MAXV>(x, row + (DEPTH - 1) * step, rows, d, t,
                             buf[(s + DEPTH - 1) % DEPTH]);
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < MAXV; ++k) {
        float v[VEC];
        widen(buf[s][k], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
      }
      ss = row_sum<TPR>(make_float2(ss, 0.f), red[it & 1]).x;
      if (row < rows) {
        const float r = rsqrtf(ss / (float)d + eps);
        T* yr = y + row * d;
#pragma unroll
        for (int k = 0; k < MAXV; ++k) {
          const int c = t + k * TPR;
          if (c < nv) {
            float v[VEC];
            widen(buf[s][k], v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = v[e] * r * w[k][e];
            st(yr + (int64_t)c * VEC, v);
          }
        }
      }
    }
  }
}

// partial: (gridDim.x, d) fp32, the block's sum over its rows of g x r
template <typename T, int TPR, int MAXV>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? BWD_MINB : 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ partial, int64_t rows, int d, float eps) {
  constexpr int G = NT / TPR;
  constexpr int WIDTH = TPR * MAXV * VEC;  // the widest row of this instantiation
  constexpr int DEPTH = BWD_DEPTH;
  __shared__ float2 red[2][NT / 32];
  __shared__ float groups[G > 1 ? G * WIDTH : 1];
  const int t = threadIdx.x % TPR;
  const int grp = threadIdx.x / TPR;
  const int nv = d / VEC;
  float w[MAXV][VEC];
  load_weight<TPR, MAXV>(scale, d, t, w);
  float acc[MAXV][VEC];
#pragma unroll
  for (int k = 0; k < MAXV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;

  const int64_t step = (int64_t)gridDim.x * G;
  const int64_t first = (int64_t)blockIdx.x * G + grp;
  Raw<T> xb[DEPTH][MAXV], gb[DEPTH][MAXV];
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {
    load_row<T, TPR, MAXV>(x, first + s * step, rows, d, t, xb[s]);
    load_row<T, TPR, MAXV>(dy, first + s * step, rows, d, t, gb[s]);
  }
  int it = 0;
  for (int64_t base = (int64_t)blockIdx.x * G; base < rows; base += DEPTH * step) {
#pragma unroll
    for (int s = 0; s < DEPTH; ++s, ++it) {
      if (base + s * step >= rows) break;
      const int64_t row = base + s * step + grp;
      const int ahead = (s + DEPTH - 1) % DEPTH;
      load_row<T, TPR, MAXV>(x, row + (DEPTH - 1) * step, rows, d, t, xb[ahead]);
      load_row<T, TPR, MAXV>(dy, row + (DEPTH - 1) * step, rows, d, t, gb[ahead]);
      float ss = 0.f, wgx = 0.f;
#pragma unroll
      for (int k = 0; k < MAXV; ++k) {
        float xv[VEC], gv[VEC];
        widen(xb[s][k], xv);
        widen(gb[s][k], gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          wgx = fmaf(gv[e] * w[k][e], xv[e], wgx);
        }
      }
      const float2 sum = row_sum<TPR>(make_float2(ss, wgx), red[it & 1]);
      if (row < rows) {
        const float r = rsqrtf(sum.x / (float)d + eps);
        const float c3 = sum.y / (float)d * (r * r * r);
        T* dxr = dx + row * d;
#pragma unroll
        for (int k = 0; k < MAXV; ++k) {
          const int c = t + k * TPR;
          if (c < nv) {
            float xv[VEC], gv[VEC], out[VEC];
            widen(xb[s][k], xv);
            widen(gb[s][k], gv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              out[e] = gv[e] * w[k][e] * r - xv[e] * c3;
              acc[k][e] += gv[e] * (xv[e] * r);
            }
            st(dxr + (int64_t)c * VEC, out);
          }
        }
      }
    }
  }

  // the block's partial: its row groups added in order
  float* out = partial + (int64_t)blockIdx.x * d;
  if constexpr (G > 1) {
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int c = t + k * TPR;
      if (c < nv)
#pragma unroll
        for (int e = 0; e < VEC; ++e) groups[grp * WIDTH + c * VEC + e] = acc[k][e];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += NT) {
      float s = groups[col];
#pragma unroll
      for (int i = 1; i < G; ++i) s += groups[i * WIDTH + col];
      out[col] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int c = t + k * TPR;
      if (c < nv)
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[c * VEC + e] = acc[k][e];
    }
  }
}

// dscale[col] = sum over the parts of partial[part][col], in a fixed order:
// 32 slices of parts a column, each summed in order, then the slices in order.
// block: 32 columns x 32 slices
__global__ void __launch_bounds__(1024)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, int parts, int d,
                          float* __restrict__ dscale) {
  __shared__ float slice[32][33];
  const int lane = threadIdx.x & 31, sl = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d)
    for (int b = sl; b < parts; b += 32) s += partial[(int64_t)b * d + col];
  slice[sl][lane] = s;
  __syncthreads();
  if (sl == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) total += slice[i][lane];
    dscale[col] = total;
  }
}

struct Grid {
  int blocks, per_sm, rows_at_once, tpr, maxv;
};

template <typename T, int TPR, int MAXV, bool BWD>
Grid grid(int64_t rows) {
  static const int per_sm = [] {
    int n = 0;
    if constexpr (BWD)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmsnorm_bwd_kernel<T, TPR, MAXV>, NT, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmsnorm_kernel<T, TPR, MAXV>, NT, 0);
    return n > 0 ? n : 1;
  }();
  constexpr int G = NT / TPR;
  const int64_t want = (rows + G - 1) / G;
  const int64_t cap = (int64_t)vec16::sm_count() * per_sm;
  return {(int)(want < cap ? want : cap), per_sm, G, TPR, MAXV};
}

template <int V>
using ic = std::integral_constant<int, V>;

// Calls f(ic<TPR>, ic<MAXV>) for width d: the smallest row group (32 to 256
// threads) that leaves each thread at most VMAX vectors; 8 vectors of 256
// threads above that (d > 256 * VMAX * 8).
template <int VMAX, typename F>
int with_shape(int d, F&& f) {
  const int nv = d / VEC;
  if (nv <= 32 * VMAX) return f(ic<32>{}, ic<VMAX>{});
  if (nv <= 64 * VMAX) return f(ic<64>{}, ic<VMAX>{});
  if (nv <= 128 * VMAX) return f(ic<128>{}, ic<VMAX>{});
  if (nv <= 256 * VMAX) return f(ic<256>{}, ic<VMAX>{});
  return f(ic<256>{}, ic<8>{});
}

template <typename T>
int forward(const void* x, const float* scale, void* y, int64_t rows, int d, float eps,
            cudaStream_t stream) {
  return with_shape<FWD_VMAX>(d, [&](auto tpr, auto maxv) {
    constexpr int TPR = decltype(tpr)::value, MAXV = decltype(maxv)::value;
    const Grid g = grid<T, TPR, MAXV, false>(rows);
    rmsnorm_kernel<T, TPR, MAXV><<<g.blocks, NT, 0, stream>>>((const T*)x, scale, (T*)y, rows,
                                                             d, eps);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int backward(const void* x, const void* dy, const float* scale, void* dx, float* dscale,
             float* partial, int parts, int64_t rows, int d, float eps, cudaStream_t stream) {
  return with_shape<BWD_VMAX>(d, [&](auto tpr, auto maxv) {
    constexpr int TPR = decltype(tpr)::value, MAXV = decltype(maxv)::value;
    const Grid g = grid<T, TPR, MAXV, true>(rows);
    if (g.blocks > parts) return (int)cudaErrorInvalidValue;
    if (g.blocks > 0) {
      rmsnorm_bwd_kernel<T, TPR, MAXV><<<g.blocks, NT, 0, stream>>>(
          (const T*)x, (const T*)dy, scale, (T*)dx, partial, rows, d, eps);
      const int err = (int)cudaGetLastError();
      if (err) return err;
    }
    rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, 1024, 0, stream>>>(partial, g.blocks, d, dscale);
    return (int)cudaGetLastError();
  });
}

inline bool bad_width(int d) { return d <= 0 || d % VEC || d > MAX_D; }

}  // namespace rn

// x, y: (rows, d) contiguous, bf16 or fp32; scale: (d,) fp32.  d must be a
// positive multiple of 8 and at most 256 * 8 * 8 = 16384; every pointer on a
// 16-byte boundary.  Returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                       float eps, int is_bf16, void* stream) {
  if (rn::bad_width(d) || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (is_bf16)
    return rn::forward<__nv_bfloat16>(x, (const float*)scale, y, rows, d, eps,
                                      (cudaStream_t)stream);
  return rn::forward<float>(x, (const float*)scale, y, rows, d, eps, (cudaStream_t)stream);
}

// The backward: x, dy, dx as x above (one dtype), scale and dscale (d,) fp32,
// partial a (parts, d) fp32 scratch with parts at least the grid's blocks
// (rmsnorm_grid with bwd = 1).  Two launches: the rows, then the fixed-order
// sum of the partials into dscale.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd(const void* x, const void* dy, const void* scale, void* dx,
                           void* dscale, void* partial, int parts, long long rows, int d,
                           float eps, int is_bf16, void* stream) {
  if (rn::bad_width(d) || rows < 0 || parts < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return rn::backward<__nv_bfloat16>(x, dy, (const float*)scale, dx, (float*)dscale,
                                       (float*)partial, parts, rows, d, eps, s);
  return rn::backward<float>(x, dy, (const float*)scale, dx, (float*)dscale, (float*)partial,
                             parts, rows, d, eps, s);
}

// The launch geometry of the forward (bwd = 0) or the backward (bwd = 1) for
// `rows` rows of width d: out = {blocks, resident blocks an SM, threads a
// block, rows a block holds at once, threads a row, 16-byte vectors a thread
// holds at most (the instantiation's MAXV)}.  Block b takes rows
// b * out[3] + i + k * out[0] * out[3] (i < out[3], k >= 0).  Launches nothing.
extern "C" int rmsnorm_grid(int d, long long rows, int is_bf16, int bwd, int* out) {
  if (rn::bad_width(d) || rows < 0) return (int)cudaErrorInvalidValue;
  rn::Grid g;
  auto fwd = [&](auto tpr, auto maxv) {
    constexpr int TPR = decltype(tpr)::value, MAXV = decltype(maxv)::value;
    g = is_bf16 ? rn::grid<__nv_bfloat16, TPR, MAXV, false>(rows)
                : rn::grid<float, TPR, MAXV, false>(rows);
    return 0;
  };
  auto back = [&](auto tpr, auto maxv) {
    constexpr int TPR = decltype(tpr)::value, MAXV = decltype(maxv)::value;
    g = is_bf16 ? rn::grid<__nv_bfloat16, TPR, MAXV, true>(rows)
                : rn::grid<float, TPR, MAXV, true>(rows);
    return 0;
  };
  if (bwd)
    rn::with_shape<rn::BWD_VMAX>(d, back);
  else
    rn::with_shape<rn::FWD_VMAX>(d, fwd);
  out[0] = g.blocks;
  out[1] = g.per_sm;
  out[2] = rn::NT;
  out[3] = g.rows_at_once;
  out[4] = g.tpr;
  out[5] = g.maxv;
  return (int)cudaGetLastError();
}
