// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dq_kernel` of
// src/repro/kernels/flash_attention.py (first call in `flash_attention_bwd`):
// per query tile, recompute  p = exp(q·kᵀ·scale − lse)  tile by tile, form
// ds = p · (do·vᵀ − delta) · scale  and accumulate  dq = Σ ds·k.
// `delta = Σ_d do ⊙ o` is computed outside, in fp32, as in the reference.
//
// What bounds it on this card: operations — three hd-deep products per score
// entry (s, dp, ds·k), about 6·hd FLOPs, against q, k, v, do read once and dq
// written once; they run as fp32 FMAs from shared memory, not on the
// tensor cores, which is what keeps it far from the bound.
// What the design does about it: the block keeps its 64 rows of Q and dO in
// shared memory for its whole life and streams K and V in 32-row tiles (with
// hd = 256 the four fp32 tiles fill 211 KB of the SM's 227 KB; the TPU kernel
// holds the whole K/V stripe in VMEM instead); s and dp are 4 x 2 register
// micro-tiles, ds goes through a small shared tile that only the writing warp
// reads back, and dq stays in registers until the end.  Tiles fully masked by
// causality or the window are skipped.
#include "flash_common.cuh"

namespace fa {

constexpr int DQ_BM = 64;  // query rows of a block
constexpr int DQ_BN = 32;  // keys of a streamed tile
constexpr int DQ_LDP = DQ_BN + 16;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * DQ_BM + 2 * DQ_BN) * (D + 4) + DQ_BM * DQ_LDP);
}

// grid (B, H, S / BM); q, do, dq: (B,S,H,D); k, v: (B,T,Kv,D); lse, delta: (B,H,S).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S, int Tk, int H,
                int Kv, int causal, int window, float scale) {
  constexpr int BM = DQ_BM, BN = DQ_BN, LD = D + 4, LDP = DQ_LDP;
  constexpr int NR = BM / 16, NC = BN / 16, CPT = D / 16;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sdO = sQ + BM * LD;
  float* sK = sdO + BM * LD;
  float* sV = sK + BN * LD;
  float* sdS = sV + BN * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the last query tiles see the most keys under causality: start them first
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (H / Kv);
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const int64_t q_base = (((int64_t)b * S + q0) * H + h) * D;
  const T* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const T* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  load_tile<T, D, BM>(sQ, q + q_base, q_stride);
  load_tile<T, D, BM>(sdO, dout + q_base, q_stride);

  float lse_r[NR], delta_r[NR], acc[NR][CPT];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int64_t r = ((int64_t)b * H + h) * S + q0 + ty + 16 * i;
    lse_r[i] = lse[r];
    delta_r[i] = delta[r];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tile_range(q0, BM, BN, off, Tk, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // everyone is done with the previous K, V tiles
    load_tile<T, D, BN>(sK, kp + (int64_t)k0 * k_stride, k_stride);
    load_tile<T, D, BN>(sV, vp + (int64_t)k0 * k_stride, k_stride);
    __syncthreads();

    float s[NR][NC], dp[NR][NC];
    tile_dot<D, NR, NC>(sQ, sK, ty, tx, s);
    tile_dot<D, NR, NC>(sdO, sV, ty, tx, dp);

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const bool vis = visible(qpos, k0 + tx + 16 * j, causal, window);
        const float p = vis ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncwarp();  // a warp reads back only the rows of sdS it wrote
    tile_accum<D, NR, BN, LDP>(sdS, sK, ty, tx, acc);
  }

  float one[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) one[i] = 1.f;
  store_rows<T, D, NR>(dq + q_base, q_stride, ty, tx, acc, one);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int S, int Tk, int H, int Kv, int causal,
              int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / DQ_BM);
  kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                                     delta, (T*)dq, S, Tk, H, Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// launchers of the head dim alone, for FA_SWITCH_HD
template <int D, typename... A>
int launch_dq_bf16(A... a) {
  return launch_dq<__nv_bfloat16, D>(a...);
}
template <int D, typename... A>
int launch_dq_f32(A... a) {
  return launch_dq<float, D>(a...);
}

}  // namespace fa

// window <= 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int S, int T,
                        int H, int Kv, int hd, int causal, int window, float scale,
                        int is_bf16, void* stream) {
  if (S % fa::DQ_BM || T % fa::DQ_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_dq_bf16, hd, q, k, v, dout, (const float*)lse, (const float*)delta,
                 dq, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_dq_f32, hd, q, k, v, dout, (const float*)lse, (const float*)delta, dq,
               B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
}
