// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py (called from `flash_attention_fwd`):
// fused  q·kᵀ -> masked online softmax -> p·v, writing `o` and
// `lse = m + log l`; the S x T score matrix never reaches device memory.
//
// What bounds it on this card: operations.  At the training shapes
// (S = T = 4096, hd = 256) the kernel does over 1000 FLOPs for every byte of
// q, k, v and o, far above the card's balance point, and this version runs
// them as fp32 FMAs from shared-memory tiles (67 TFLOP/s peak), not on the
// tensor cores (989 TFLOP/s in bf16) — so it sits well off the tensor-core
// bound, and shared-memory bandwidth caps the FMA pipe below its own peak.
// What the design does about it: the TPU kernel keeps the whole K/V stripe of a
// (batch, kv-head) in VMEM (2 MB each at these shapes), which no SM can hold,
// so K and V stream through shared memory in 64-row tiles while the block's
// 64 query rows stay resident; 4 x 4 register micro-tiles and float4 shared
// reads give 8 FMAs per shared load; tiles that causality or the sliding
// window mask completely are never visited (the TPU forward visits the
// window's); the running max, sum and output accumulators never leave
// registers.  GQA is by index (q-head h reads kv-head h / G), no repeated K/V.
// Moving the two products to wgmma is the next step for this kernel.
#include "flash_common.cuh"

namespace fa {

constexpr int FWD_BM = 64;  // query rows of a block
constexpr int FWD_BN = 64;  // keys of a streamed tile
constexpr int FWD_LDP = FWD_BN + 16;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((FWD_BM + 2 * FWD_BN) * (D + 4) + FWD_BM * FWD_LDP);
}

// grid (B, H, S / BM); q, o: (B,S,H,D); k, v: (B,T,Kv,D); lse: (B,H,S).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H, int Kv,
                 int causal, int window, float scale) {
  constexpr int BM = FWD_BM, BN = FWD_BN, LD = D + 4, LDP = FWD_LDP;
  constexpr int NR = BM / 16, NC = BN / 16, CPT = D / 16;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the last query tiles see the most keys under causality: start them first
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (H / Kv);
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const T* qp = q + (((int64_t)b * S + q0) * H + h) * D;
  const T* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const T* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  load_tile<T, D, BM>(sQ, qp, q_stride);

  float m[NR], l[NR], acc[NR][CPT];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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

    float s[NR][NC];
    tile_dot<D, NR, NC>(sQ, sK, ty, tx, s);

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const bool vis = visible(qpos, k0 + tx + 16 * j, causal, window);
        s[i][j] = vis ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float corr = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        // a masked entry contributes nothing, also while mx is still NEG_INF
        const float p = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - mx) : 0.f;
        rs += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a warp reads back only the rows of sP it wrote
    tile_accum<D, NR, BN, LDP>(sP, sV, ty, tx, acc);
  }

  float inv[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
    if (tx == 0) lse[((int64_t)b * H + h) * S + q0 + ty + 16 * i] = m[i] + logf(l[i]);
  }
  store_rows<T, D, NR>(o + (((int64_t)b * S + q0) * H + h) * D, q_stride, ty, tx, acc, inv);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               int Tk, int H, int Kv, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / FWD_BM);
  kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, Tk,
                                     H, Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa

// window <= 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int T, int H, int Kv, int hd, int causal, int window,
                         float scale, int is_bf16, void* stream) {
  if (S % fa::FWD_BM || T % fa::FWD_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  FA_DISPATCH(fa::launch_fwd, is_bf16, hd, q, k, v, o, (float*)lse, B, S, T, H, Kv, causal,
              window, scale, (cudaStream_t)stream);
}
