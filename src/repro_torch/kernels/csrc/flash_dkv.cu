// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dkv_kernel` of
// src/repro/kernels/flash_attention.py (second call in `flash_attention_bwd`)
// together with the sum over the GQA group that follows it there:
// per key tile, recompute  p = exp(q·kᵀ·scale − lse)  for every query tile
// that can see it, and accumulate  dv = Σ pᵀ·do,  dk = Σ dsᵀ·q  with
// ds = p · (do·vᵀ − delta) · scale.
//
// What bounds it on this card: operations — four hd-deep products per score
// entry (s, dp, pᵀ·do, dsᵀ·q), 8·hd FLOPs, against q, k, v, do read once and
// dk, dv written once; run as fp32 FMAs from shared memory, not on the
// tensor cores, which is what keeps it far from the bound.
// What the design does about it: the TPU version writes fp32 dk/dv per q-head,
// (B·H, T, hd), and sums the G heads of a group outside the kernel.  Here one
// block owns one (batch, kv-head, 32-key tile), keeps K and V in shared memory
// and loops over the G query heads of its group and over their query tiles, so
// the group sum happens in the block's registers: no atomics, no fp32
// intermediate in device memory, and a result that is the same from run to run.
// Q and dO stream in 64-row tiles (the TPU kernel holds whole stripes in VMEM);
// the score tile is formed transposed (keys x queries) so that the thread that
// owns a key row of dk/dv also owns that row of pᵀ and dsᵀ.  The key tile
// is the slowest grid dimension, so the first tiles, which every query sees
// under causality, start first.
#include "flash_common.cuh"

namespace fa {

constexpr int DKV_BN = 32;  // keys of a block
constexpr int DKV_BM = 64;  // query rows of a streamed tile
constexpr int DKV_LDP = DKV_BM + 16;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         ((2 * DKV_BN + 2 * DKV_BM) * (D + 4) + 2 * DKV_BN * DKV_LDP + 2 * DKV_BM);
}

// grid (B, Kv, T / BN); q, do: (B,S,H,D); k, v, dk, dv: (B,T,Kv,D);
// lse, delta: (B,H,S).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
                 int Tk, int H, int Kv, int causal, int window, float scale) {
  constexpr int BN = DKV_BN, BM = DKV_BM, LD = D + 4, LDP = DKV_LDP;
  constexpr int NR = BN / 16, NC = BM / 16, CPT = D / 16;
  extern __shared__ float4 smem_f4[];
  float* sK = reinterpret_cast<float*>(smem_f4);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sdO = sQ + BM * LD;
  float* sPt = sdO + BM * LD;
  float* sdSt = sPt + BN * LDP;
  float* sLse = sdSt + BN * LDP;
  float* sDelta = sLse + BM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x, kvh = blockIdx.y, k0 = blockIdx.z * BN;
  const int G = H / Kv;
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const int64_t k_base = (((int64_t)b * Tk + k0) * Kv + kvh) * D;

  load_tile<T, D, BN>(sK, k + k_base, k_stride);
  load_tile<T, D, BN>(sV, v + k_base, k_stride);

  float acc_k[NR][CPT], acc_v[NR][CPT];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  int qt_lo, qt_hi;
  query_tile_range(k0, BN, BM, off, S, causal, window, &qt_lo, &qt_hi);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row_base = ((int64_t)b * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BM;
      const int64_t q_base = (((int64_t)b * S + q0) * H + h) * D;
      __syncthreads();  // everyone is done with the previous Q, dO tiles
      load_tile<T, D, BM>(sQ, q + q_base, q_stride);
      load_tile<T, D, BM>(sdO, dout + q_base, q_stride);
      if (threadIdx.x < BM) {
        sLse[threadIdx.x] = lse[row_base + q0 + threadIdx.x];
        sDelta[threadIdx.x] = delta[row_base + q0 + threadIdx.x];
      }
      __syncthreads();

      // transposed score tiles: rows are keys, columns are queries
      float st[NR][NC], dpt[NR][NC];
      tile_dot<D, NR, NC>(sK, sQ, ty, tx, st);
      tile_dot<D, NR, NC>(sV, sdO, ty, tx, dpt);

#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int qr = tx + 16 * j;
          const bool vis = visible(q0 + qr + off, key, causal, window);
          const float p = vis ? expf(st[i][j] * scale - sLse[qr]) : 0.f;
          sPt[(ty + 16 * i) * LDP + qr] = p;
          sdSt[(ty + 16 * i) * LDP + qr] = p * (dpt[i][j] - sDelta[qr]) * scale;
        }
      }
      __syncwarp();  // a warp reads back only the rows of sPt, sdSt it wrote
      tile_accum<D, NR, BM, LDP>(sPt, sdO, ty, tx, acc_v);
      tile_accum<D, NR, BM, LDP>(sdSt, sQ, ty, tx, acc_k);
    }
  }

  float one[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) one[i] = 1.f;
  store_rows<T, D, NR>(dk + k_base, k_stride, ty, tx, acc_k, one);
  store_rows<T, D, NR>(dv + k_base, k_stride, ty, tx, acc_v, one);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int S, int Tk, int H, int Kv,
               int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Kv, Tk / DKV_BN);
  kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                                     delta, (T*)dk, (T*)dv, S, Tk, H, Kv, causal, window,
                                     scale);
  return (int)cudaGetLastError();
}

}  // namespace fa

// window <= 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                         int T, int H, int Kv, int hd, int causal, int window, float scale,
                         int is_bf16, void* stream) {
  if (S % fa::DKV_BM || T % fa::DKV_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  FA_DISPATCH(fa::launch_dkv, is_bf16, hd, q, k, v, dout, (const float*)lse,
              (const float*)delta, dk, dv, B, S, T, H, Kv, causal, window, scale,
              (cudaStream_t)stream);
}
