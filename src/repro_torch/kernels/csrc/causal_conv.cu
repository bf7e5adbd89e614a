// Causal depthwise convolution fused with its SiLU, for Hopper (sm_90a):
// forward and backward.
//
// Replaces no Pallas TPU kernel: the reference's `_causal_conv`
// (src/repro/models/ssm.py, called from `ssd_apply`) is plain jnp, which XLA
// fuses on the TPU.  The port's plain version of it
// (kernels/causal_conv.py::causal_conv_plain) runs on the H100 as PyTorch's
// elementwise kernels: u cast to fp32, a padded copy, a product and a sum a
// tap, the silu and a cast, and autograd's backward again a tap, twice a
// mamba layer (x and B/C), in the forward, the recompute and the backward.
// For u (B, S, C) and w (cw, C) fp32, in fp32:
//   pre[s]     = u[s] w[cw-1] + u[s-1] w[cw-2] + ... + u[s-cw+1] w[0]   (u = 0 before s = 0)
//   y[s]       = silu(pre[s]) = pre / (1 + exp(-pre))       cast once to u's dtype
// pre summed in the plain version's order with separate roundings (no FMA
// contraction), so that it equals the plain version's bit for bit.  The
// backward recomputes pre from u (nothing but u and w is saved) and, with
// sg = 1 / (1 + exp(-pre)) and dy in fp32, follows autograd of the plain
// version (aten's silu_backward; the taps' terms added as autograd adds them):
//   g[s]       = dy[s] sg (1 + pre (1 - sg))
//   du[s]      = g[s+cw-1] w[0] + g[s+cw-2] w[1] + ... + g[s] w[cw-1]   cast once to u's dtype
//   dw[cw-1-i] = sum over b and s of g[s] u[s-i]                        fp32
//
// What bounds it on this card: bytes.  The forward reads u and writes y, the
// backward reads u and dy and writes du, each once: at mamba2-1.3b's x
// (4 x 4096 x 4096 bf16) 268.4 and 402.7 MB, 0.080 and 0.120 ms at 3.35 TB/s.
// The arithmetic, some 25 and 45 fp32 operations an element (expf and an
// IEEE division in both), is not far below that: the backward's would take
// about 0.1 ms at the card's fp32 issue rate.
// What the design does about it: one pass over device memory, nothing
// intermediate written, and enough warps to overlap loads with arithmetic.
// * A block is 8 warps x 32 lanes: a warp walks a run of R positions of one
//   sequence, a lane holds 4 channels (8 bytes of bf16: a warp's access is 256
//   contiguous bytes).  At 8 channels the cw = 4 instantiations needed 182
//   registers (fp32 forward) and spilled at the 128 that two blocks an SM
//   leave; at 4 the bf16 forward fits three blocks an SM (80 registers at
//   cw = 4) and the backward two (126).  Two channels a thread, with more
//   blocks an SM, made the backward slower: it is bound by its arithmetic
//   as much as by its bytes.
//   A thread keeps its channels' cw taps in registers and walks its run: the
//   forward upwards, with the last cw - 1 inputs in registers; the backward
//   downwards, with the next cw - 1 gradients of pre and the last cw inputs.
//   A run reads cw - 1 positions besides its own (its neighbour's, from L2).
// * Positions go through a ring of registers: the next ones' loads are in
//   flight while the current one is computed.  Loads and stores are 8 bytes
//   a thread in bf16 (16 in fp32) on neighbouring addresses, with the
//   streaming (evict-first) hint.
// * R (64 down to 8) is the largest that still gives 4 blocks an SM
//   (kernels/causal_conv.py::geometry); the wrapper passes it in.
// * dw: each thread sums its run in registers, a block its 8 runs through
//   shared memory in order and writes one partial; a second short launch
//   adds the partials in a fixed order, so the gradients repeat bit for bit
//   from run to run (no atomics).
#include <stdint.h>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cc {

constexpr int WARPS = 8;   // runs of positions a block
constexpr int LANES = 32;  // channel vectors a block
constexpr int NT = WARPS * LANES;
constexpr int CH = 4;                        // channels a thread
// positions in the ring of loads; chosen on the H100 among 2-8 (backward) and
// 4-8 (forward), with 2-4 blocks an SM and 2 or 4 channels a thread (PERF.md)
constexpr int FWD_DEPTH = 6, BWD_DEPTH = 4;
constexpr int MAX_CW = 4;

// N consecutive elements of T as loaded: 8 or 16 bytes
template <typename T, int N>
struct Raw {
  static constexpr int WORDS = N * (int)sizeof(T) / 4;
  uint32_t w[WORDS];
};

template <typename T, int N>
__device__ __forceinline__ void ld(const T* p, Raw<T, N>& r) {
  constexpr int W = Raw<T, N>::WORDS;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + q);
      r.w[4 * q] = v.x;
      r.w[4 * q + 1] = v.y;
      r.w[4 * q + 2] = v.z;
      r.w[4 * q + 3] = v.w;
    }
  } else {
    static_assert(W == 2, "a thread's channels are 8 or 16 bytes");
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void zero(Raw<T, N>& r) {
#pragma unroll
  for (int q = 0; q < Raw<T, N>::WORDS; ++q) r.w[q] = 0u;
}

// exact: a bf16 is the upper half of an fp32, element 2k the lower half of word k
template <typename T, int N>
__device__ __forceinline__ void widen(const Raw<T, N>& r, float (&v)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = __uint_as_float(r.w[e]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      v[2 * k] = __uint_as_float(r.w[k] << 16);
      v[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
    }
  }
}

// one rounding to T (round to nearest even), one store of 8 or 16 bytes
template <typename T, int N>
__device__ __forceinline__ void st(T* p, const float (&v)[N]) {
  Raw<T, N> r;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; ++e) r.w[e] = __float_as_uint(v[e]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      r.w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  constexpr int W = Raw<T, N>::WORDS;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      __stcs(reinterpret_cast<uint4*>(p) + q,
             make_uint4(r.w[4 * q], r.w[4 * q + 1], r.w[4 * q + 2], r.w[4 * q + 3]));
  } else {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(r.w[0], r.w[1]));
  }
}

// the thread's channels c .. c + N - 1 of every tap (C % 8 == 0: 16-byte aligned)
template <int CW, int N>
__device__ __forceinline__ void load_taps(const float* __restrict__ w, int C, int c,
                                          float (&wk)[CW][N]) {
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + (int64_t)k * C + c) + q);
      wk[k][4 * q] = v.x;
      wk[k][4 * q + 1] = v.y;
      wk[k][4 * q + 2] = v.z;
      wk[k][4 * q + 3] = v.w;
    }
}

// pre of channel e, x[i] = u[s - i]: u[s] w[cw-1] first, then + u[s-i] w[cw-1-i]
template <int CW, int N>
__device__ __forceinline__ float pre_act(const float (&wk)[CW][N], const float (&x)[CW][N],
                                         int e) {
  float p = __fmul_rn(x[0][e], wk[CW - 1][e]);
#pragma unroll
  for (int i = 1; i < CW; ++i) p = __fadd_rn(p, __fmul_rn(x[i][e], wk[CW - 1 - i][e]));
  return p;
}

template <typename T, int N>
__device__ __forceinline__ void load_or_zero(const T* p, bool in, Raw<T, N>& r) {
  if (in)
    ld(p, r);
  else
    zero(r);
}

// y = silu(conv(u, w)).  Block (x, y, z): channels x * 128 .., runs y * 8 ..
// of sequence z.  u's rows (b, s) sb and ss elements apart; y contiguous.
// Positions are ints (S < 2^31), addresses 64-bit.
template <typename T, int CW>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 3 : 2)
conv_silu_fwd_kernel(const T* __restrict__ u, const float* __restrict__ w, T* __restrict__ y,
                     int S, int C, int64_t sb, int64_t ss, int run) {
  constexpr int N = CH, D = FWD_DEPTH;
  const int c = (blockIdx.x * LANES + threadIdx.x % LANES) * N;
  const int s0 = (blockIdx.y * WARPS + threadIdx.x / LANES) * run;
  if (c >= C || s0 >= S) return;
  const int s1 = s0 + run < S ? s0 + run : S;
  const T* ub = u + blockIdx.z * sb + c;
  T* yb = y + (int64_t)blockIdx.z * S * C + c;
  float wk[CW][N];
  load_taps<CW, N>(w, C, c, wk);
  // x[i]: u[s - i] of the position s in hand; before the first, x[i - 1] = u[s0 - i]
  float x[CW][N];
#pragma unroll
  for (int i = 1; i < CW; ++i) {
    Raw<T, N> r;
    load_or_zero(ub + (int64_t)(s0 - i) * ss, s0 - i >= 0, r);
    widen(r, x[i - 1]);
  }
  // position base + j sits in ring[j] from D - 1 positions before it is used
  Raw<T, N> ring[D];
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    load_or_zero(ub + (int64_t)(s0 + j) * ss, s0 + j < s1, ring[j]);
  for (int base = s0; base < s1; base += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int s = base + j;
      if (s >= s1) break;
      if (s + D - 1 < s1) ld(ub + (int64_t)(s + D - 1) * ss, ring[(j + D - 1) % D]);
#pragma unroll
      for (int i = CW - 1; i > 0; --i)
#pragma unroll
        for (int e = 0; e < N; ++e) x[i][e] = x[i - 1][e];
      widen(ring[j], x[0]);
      float out[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float p = pre_act<CW, N>(wk, x, e);
        out[e] = __fdiv_rn(p, __fadd_rn(1.f, expf(-p)));
      }
      st(yb + (int64_t)s * C, out);
    }
  }
}

// du and the block's partial of dw.  Block (x, y, z): channels x * 128 ..,
// runs y * 8 .. of sequence z.  u's rows sb and ss elements apart; dy and du
// contiguous; partial (gridDim.z * gridDim.y, cw, C) fp32, one a block.
template <typename T, int CW>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
conv_silu_bwd_kernel(const T* __restrict__ u, const float* __restrict__ w,
                     const T* __restrict__ dy, T* __restrict__ du, float* __restrict__ partial,
                     int S, int C, int64_t sb, int64_t ss, int run) {
  constexpr int N = CH, D = BWD_DEPTH, WIDTH = LANES * N;
  __shared__ float runs[WARPS][CW][WIDTH];
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int c = (blockIdx.x * LANES + lane) * N;
  const int s0 = (blockIdx.y * WARPS + warp) * run;
  float dw[CW][N];
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int e = 0; e < N; ++e) dw[k][e] = 0.f;

  if (c < C && s0 < S) {
    const int s1 = s0 + run < S ? s0 + run : S;
    // the highest position whose g the run reads, and the steps down to s0
    const int top = (s1 + CW - 1 < S ? s1 + CW - 1 : S) - 1;
    const int n = top - s0 + 1;
    const T* ub = u + blockIdx.z * sb + c;
    const int64_t row0 = (int64_t)blockIdx.z * S * C + c;
    const T* gb = dy + row0;
    T* db = du + row0;
    float wk[CW][N];
    load_taps<CW, N>(w, C, c, wk);
    // x[i]: u[s - i] and g[i]: g[s + i] of the position s in hand; before
    // the first (top), x[i] = u[top + 1 - i] for i >= 1 and g past top is 0
    float x[CW][N], g[CW][N];
#pragma unroll
    for (int i = 0; i < CW; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) g[i][e] = 0.f;
#pragma unroll
    for (int i = 1; i < CW; ++i) {
      Raw<T, N> r;
      load_or_zero(ub + (int64_t)(top + 1 - i) * ss, top + 1 - i >= 0, r);
      widen(r, x[i]);
    }
    // step k (position top - k) needs u[top - k - cw + 1] and dy[top - k],
    // in the ring from D - 1 steps before
    Raw<T, N> ur[D], gr[D];
#pragma unroll
    for (int j = 0; j < D - 1; ++j) {
      const int s = top - j;
      load_or_zero(ub + (int64_t)(s - CW + 1) * ss, j < n && s - CW + 1 >= 0, ur[j]);
      load_or_zero(gb + (int64_t)s * C, j < n, gr[j]);
    }
    for (int base = 0; base < n; base += D) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int k = base + j;
        if (k >= n) break;
        const int s = top - k;
        if (k + D - 1 < n) {
          const int a = s - (D - 1);
          load_or_zero(ub + (int64_t)(a - CW + 1) * ss, a - CW + 1 >= 0, ur[(j + D - 1) % D]);
          ld(gb + (int64_t)a * C, gr[(j + D - 1) % D]);
        }
#pragma unroll
        for (int i = 0; i < CW - 1; ++i)
#pragma unroll
          for (int e = 0; e < N; ++e) x[i][e] = x[i + 1][e];
        widen(ur[j], x[CW - 1]);
#pragma unroll
        for (int i = CW - 1; i > 0; --i)
#pragma unroll
          for (int e = 0; e < N; ++e) g[i][e] = g[i - 1][e];
        float gd[N];
        widen(gr[j], gd);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float p = pre_act<CW, N>(wk, x, e);
          const float sg = __frcp_rn(__fadd_rn(1.f, expf(-p)));   // = 1 / (1 + e), rounded once
          g[0][e] = __fmul_rn(__fmul_rn(gd[e], sg),
                              __fadd_rn(1.f, __fmul_rn(p, __fsub_rn(1.f, sg))));
        }
        if (s < s1) {
          float out[N];
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float d = __fmul_rn(g[CW - 1][e], wk[0][e]);
#pragma unroll
            for (int i = CW - 2; i >= 0; --i) d = __fadd_rn(d, __fmul_rn(g[i][e], wk[CW - 1 - i][e]));
            out[e] = d;
          }
          st(db + (int64_t)s * C, out);
#pragma unroll
          for (int i = 0; i < CW; ++i)
#pragma unroll
            for (int e = 0; e < N; ++e) dw[CW - 1 - i][e] = fmaf(g[0][e], x[i][e], dw[CW - 1 - i][e]);
        }
      }
    }
  }

  // the block's partial: its runs added in order (zeros from threads past C or S)
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int e = 0; e < N; ++e) runs[warp][k][lane * N + e] = dw[k][e];
  __syncthreads();
  const int c0 = blockIdx.x * WIDTH;
  float* out = partial + ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * CW * C + c0;
  for (int idx = threadIdx.x; idx < CW * WIDTH; idx += NT) {
    const int k = idx / WIDTH, j = idx % WIDTH;
    if (c0 + j < C) {
      float acc = runs[0][k][j];
#pragma unroll
      for (int r = 1; r < WARPS; ++r) acc += runs[r][k][j];
      out[(int64_t)k * C + j] = acc;
    }
  }
}

// dw[i] = sum over the parts of partial[part][i] (i < n = cw * C), in a fixed
// order: 32 slices of parts a column, each summed in order, then the slices
// in order.  Block: 32 columns x 32 slices.
__global__ void __launch_bounds__(1024)
conv_dw_sum_kernel(const float* __restrict__ partial, int parts, int n, float* __restrict__ dw) {
  __shared__ float slice[32][33];
  const int lane = threadIdx.x & 31, sl = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
    for (int p = sl; p < parts; p += 32) s += partial[(int64_t)p * n + i];
  slice[sl][lane] = s;
  __syncthreads();
  if (sl == 0 && i < n) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) total += slice[k][lane];
    dw[i] = total;
  }
}

template <int V>
using ic = std::integral_constant<int, V>;

// f(ic<cw>) for cw in 1..MAX_CW
template <typename F>
int with_width(int cw, F&& f) {
  switch (cw) {
    case 1: return f(ic<1>{});
    case 2: return f(ic<2>{});
    case 3: return f(ic<3>{});
    case 4: return f(ic<4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// runs a block's column of the grid: ceil(S / (WARPS * run))
inline int64_t run_blocks(int S, int run) { return cdiv(S, (int64_t)WARPS * run); }

inline bool bad(int B, int S, int C, int cw, long long sb, long long ss, int run) {
  return B < 0 || B > 65535 || S < 0 || C <= 0 || C % 8 || cw < 1 || cw > MAX_CW ||
         run <= 0 || sb % 8 || ss % 8 || run_blocks(S, run) > 65535;
}

}  // namespace cc

// u: (B, S, C) bf16 or fp32, last dim contiguous, rows (b, s) at b * sb + s * ss
// elements (multiples of 8); w: (cw, C) fp32 contiguous, 1 <= cw <= 4; y:
// (B, S, C) contiguous, u's dtype.  C a positive multiple of 8; every pointer on
// a 16-byte boundary; run: positions a warp walks (geometry).  Returns
// cudaGetLastError().
extern "C" int causal_conv(const void* u, const void* w, void* y, int B, int S, int C, int cw,
                           long long sb, long long ss, int run, int is_bf16, void* stream) {
  if (cc::bad(B, S, C, cw, sb, ss, run)) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * S == 0) return 0;
  const dim3 grid((unsigned)cc::cdiv(C, cc::LANES * cc::CH), (unsigned)cc::run_blocks(S, run),
                  (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  return cc::with_width(cw, [&](auto k) {
    constexpr int CW = decltype(k)::value;
    if (is_bf16)
      cc::conv_silu_fwd_kernel<__nv_bfloat16, CW><<<grid, cc::NT, 0, s>>>(
          (const __nv_bfloat16*)u, (const float*)w, (__nv_bfloat16*)y, S, C, sb, ss, run);
    else
      cc::conv_silu_fwd_kernel<float, CW><<<grid, cc::NT, 0, s>>>(
          (const float*)u, (const float*)w, (float*)y, S, C, sb, ss, run);
    return (int)cudaGetLastError();
  });
}

// The backward: u, w, run as above; dy and du (B, S, C) contiguous, u's
// dtype; dw (cw, C) fp32; partial a (parts, cw, C) fp32 scratch with parts
// = B * ceil(S / (8 * run)).  Two launches: the runs (du and a partial of dw
// a block), then the fixed-order sum of the partials into dw.  Returns
// cudaGetLastError().
extern "C" int causal_conv_bwd(const void* u, const void* w, const void* dy, void* du, void* dw,
                               void* partial, int parts, int B, int S, int C, int cw,
                               long long sb, long long ss, int run, int is_bf16, void* stream) {
  if (cc::bad(B, S, C, cw, sb, ss, run) || (int64_t)parts != B * cc::run_blocks(S, run))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (parts > 0) {
    const dim3 grid((unsigned)cc::cdiv(C, cc::LANES * cc::CH),
                    (unsigned)cc::run_blocks(S, run), (unsigned)B);
    const int err = cc::with_width(cw, [&](auto k) {
      constexpr int CW = decltype(k)::value;
      if (is_bf16)
        cc::conv_silu_bwd_kernel<__nv_bfloat16, CW><<<grid, cc::NT, 0, s>>>(
            (const __nv_bfloat16*)u, (const float*)w, (const __nv_bfloat16*)dy,
            (__nv_bfloat16*)du, (float*)partial, S, C, sb, ss, run);
      else
        cc::conv_silu_bwd_kernel<float, CW><<<grid, cc::NT, 0, s>>>(
            (const float*)u, (const float*)w, (const float*)dy, (float*)du, (float*)partial, S,
            C, sb, ss, run);
      return (int)cudaGetLastError();
    });
    if (err) return err;
  }
  const int n = cw * C;
  cc::conv_dw_sum_kernel<<<(n + 31) / 32, 1024, 0, s>>>((const float*)partial, parts, n,
                                                        (float*)dw);
  return (int)cudaGetLastError();
}
