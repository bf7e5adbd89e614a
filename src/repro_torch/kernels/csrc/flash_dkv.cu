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
// dk, dv written once.
//
// Both kernels below share the design of the group sum: the TPU version
// writes fp32 dk/dv per q-head, (B·H, T, hd), and sums the G heads of a group
// outside the kernel.  Here one block owns one (batch, kv-head, key tile),
// keeps K and V in shared memory and loops over the G query heads of its
// group and over their query tiles, so the group sum happens in the block's
// registers: no atomics, no fp32 intermediate in device memory, and a result
// that is the same from run to run.  Q and dO stream in 64-row tiles (the TPU
// kernel holds whole stripes in VMEM); the score tiles are formed transposed
// (keys x queries).  The key tile is the slowest grid dimension, so the first
// tiles, which every query sees under causality, start first.  Query tiles
// that causality or the window hide wholly are never visited.
//
// * bf16 -> flash_dkv_tc_kernel, on the tensor cores.  A block of 8 warps
//   owns 64 keys.  Q, dO, lse and delta stream through a two-stage ring
//   filled by cp.async (the next tile loads while this one is multiplied).
//   All four products are `mma.sync.m16n8k16` (bf16 operands by ldmatrix,
//   fp32 accumulators).  Per query tile:
//     1. sᵀ = k·qᵀ and dpᵀ = v·doᵀ (64 keys x 64 queries); warp w forms the
//        16 x 32 pieces at keys 16 (w % 4), queries 32 (w / 4);
//     2. pᵀ = exp2(sᵀ·scale·log2 e − lse·log2 e) and dsᵀ = pᵀ·(dpᵀ − delta)·scale
//        in fp32 registers, then rounded to bf16 — the one rounding the fp32
//        path does not have — into two 64 x 64 shared tiles;
//     3. dv += pᵀ·do and dk += dsᵀ·q; warp w owns keys 16 (w % 4) and head-dim
//        columns (hd / 2)·(w / 4) of both accumulators.
//   Registers at hd = 256: dk and dv, 16 x 128 fp32 each / 32 lanes = 128,
//   sᵀ and dpᵀ 2 x 16, fragments 16 (ptxas: 246 registers, no spills).  A
//   warp that owned 16 keys x all 256 columns would need 256 accumulator
//   registers; splitting the columns over two warps is why pᵀ and dsᵀ go
//   through shared memory (both warps of a key row need all 64 query columns
//   of it).  Why mma.sync and not wgmma: the 64-row wgmma tile would hold
//   64 keys x 256 columns of dk and dv in one warpgroup's registers (256 a
//   thread), which does not fit; wgmma with the accumulators split over
//   warpgroups is the next step.
//   Shared memory at hd = 256: K, V, and two stages of Q and dO at 264 bf16 a
//   row, plus pᵀ, dsᵀ, lse, delta: 222,208 bytes, one block (8 warps) an SM.
//   Distance from the bound (B 4, S = T 4096, H 4, Kv 1, hd 256, causal,
//   chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit):
//   1.255 ms against 0.278 ms, 22 %, on a global layer; 0.388 ms against
//   0.0651 ms, 17 %, with a 512-key window.  What is left, inferred rather
//   than measured: shared memory bandwidth (each warp reads its operands for
//   16 rows; pᵀ and dsᵀ make a round trip) and 256 blocks on 132 SMs, one
//   block an SM.
// * fp32 -> flash_dkv_kernel, IEEE fp32 FMAs from fp32 shared tiles, 32 keys
//   a block (below), so fp32 inputs keep their 5e-5 parity with the plain
//   version.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace fa {

// ---- fp32: IEEE FMAs ----------------------------------------------------------
// 32 keys a block; K and V stay in fp32 shared memory, Q and dO stream in; the
// thread that owns a key row of dk/dv also owns that row of pᵀ and dsᵀ.

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

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int S,
                   int Tk, int H, int Kv, int causal, int window, float scale,
                   cudaStream_t stream) {
  using T = float;
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

// ---- bf16 on the tensor cores -------------------------------------------------

template <int D>
struct DkvTc {
  static constexpr int BN = 64;    // keys of a block, 16 a warp row
  static constexpr int BM = 64;    // query rows of a streamed tile
  static constexpr int NTH = 256;  // 8 warps
  static constexpr int LD = D + 8, LDP = BM + 8;  // shared row strides, bf16
  static constexpr size_t SMEM =
      sizeof(bf16) * ((2 * BN + 2 * 2 * BM) * LD + 2 * BN * LDP) + sizeof(float) * 2 * 2 * BM;
};

// grid (B, Kv, T / BN); q, do: (B,S,H,D); k, v, dk, dv: (B,T,Kv,D);
// lse, delta: (B,H,S).
template <int D>
__global__ void __launch_bounds__(DkvTc<D>::NTH, 1)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Tk, int H, int Kv,
                    int causal, int window, float scale) {
  using C = DkvTc<D>;
  constexpr int BN = C::BN, BM = C::BM, LD = C::LD, LDP = C::LDP, NTH = C::NTH;
  constexpr int DW = D / 2;     // head-dim columns of dk / dv a warp owns
  constexpr int NDW = DW / 8;   // their 8-wide column tiles (1 at hd = 16)
  extern __shared__ float4 smem_f4[];
  bf16* sK = reinterpret_cast<bf16*>(smem_f4);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;        // [2 stages][BM][LD]
  bf16* sdO = sQ + 2 * BM * LD;   // [2 stages][BM][LD]
  bf16* sPt = sdO + 2 * BM * LD;  // [BN][LDP]
  bf16* sdSt = sPt + BN * LDP;    // [BN][LDP]
  float* sLse = reinterpret_cast<float*>(sdSt + BN * LDP);  // [2 stages][BM]
  float* sDelta = sLse + 2 * BM;                            // [2 stages][BM]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;  // the warp's 16 keys
  const int wq = (warp >> 2) * 32; // step 1: its 32 queries of the tile
  const int wd = (warp >> 2) * DW; // step 3: its head-dim columns
  const int b = blockIdx.x, kvh = blockIdx.y, k0 = blockIdx.z * BN;
  const int G = H / Kv;
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const int64_t k_base = (((int64_t)b * Tk + k0) * Kv + kvh) * D;

  int qt_lo, qt_hi;
  query_tile_range(k0, BN, BM, off, S, causal, window, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_it = G * nq;  // (head of the group, query tile) pairs
  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / nq, q0 = (qt_lo + it % nq) * BM;
    const int64_t base = (((int64_t)b * S + q0) * H + h) * D;
    cp_tile<D, LD, BM, NTH>(sQ + stage * BM * LD, q + base, q_stride);
    cp_tile<D, LD, BM, NTH>(sdO + stage * BM * LD, dout + base, q_stride);
    const int64_t row = ((int64_t)b * H + h) * S + q0;
    if (threadIdx.x < BM / 4)
      cp_async16(sLse + stage * BM + threadIdx.x * 4, lse + row + threadIdx.x * 4);
    else if (threadIdx.x < BM / 2)
      cp_async16(sDelta + stage * BM + (threadIdx.x - BM / 4) * 4,
                 delta + row + (threadIdx.x - BM / 4) * 4);
  };
  if (n_it > 0) {
    cp_tile<D, LD, BN, NTH>(sK, k + k_base, k_stride);
    cp_tile<D, LD, BN, NTH>(sV, v + k_base, k_stride);
    load_q(0, 0);
  }
  cp_async_commit();

  float acc_k[NDW][4], acc_v[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }

  const float sl2 = scale * LOG2E;
  const bf16* sKw = sK + wr * LD;
  const bf16* sVw = sV + wr * LD;
  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: K, V and tile it are in
    __syncthreads();
    const bf16* sQs = sQ + stage * BM * LD;
    const bf16* sdOs = sdO + stage * BM * LD;
    const float* sL = sLse + stage * BM;
    const float* sDl = sDelta + stage * BM;
    const int q0 = (qt_lo + it % nq) * BM;

    // 1. sᵀ = k·qᵀ and dpᵀ = v·doᵀ, 16 keys x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.f;
        dpt[n][e] = 0.f;
      }
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_addr(sKw, LD, d0, lane));
      ldsm_x4(av, a_addr(sVw, LD, d0, lane));
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, bt_addr(sQs, LD, wq + n * 8, d0, lane));
        mma_bf16(st[n], ak, bq[0], bq[1]);
        mma_bf16(st[n + 1], ak, bq[2], bq[3]);
        ldsm_x4(bo, bt_addr(sdOs, LD, wq + n * 8, d0, lane));
        mma_bf16(dpt[n], av, bo[0], bo[1]);
        mma_bf16(dpt[n + 1], av, bo[2], bo[3]);
      }
    }

    // 2. pᵀ and dsᵀ in fp32, stored to shared memory as bf16
    const bool full = (!causal || k0 + BN - 1 <= q0 + off) &&
                      (window <= 0 || q0 + BM - 1 + off - k0 < window);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int qc = wq + 8 * n + 2 * t;  // query column of c0 / c2
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // key row g, then g + 8
        const int kr = wr + g + 8 * i;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = qc + e;
          const bool vis = full || visible(q0 + qr + off, k0 + kr, causal, window);
          p[e] = vis ? exp2f(st[n][2 * i + e] * sl2 - sL[qr] * LOG2E) : 0.f;
          ds[e] = p[e] * (dpt[n][2 * i + e] - sDl[qr]) * scale;
        }
        *reinterpret_cast<uint32_t*>(sPt + kr * LDP + qc) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sdSt + kr * LDP + qc) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // 3. dv += pᵀ·do, dk += dsᵀ·q: 16 keys x hd/2 columns a warp
#pragma unroll
    for (int j = 0; j < BM; j += 16) {
      uint32_t ap[4], ads[4];
      ldsm_x4(ap, a_addr(sPt + wr * LDP, LDP, j, lane));
      ldsm_x4(ads, a_addr(sdSt + wr * LDP, LDP, j, lane));
#pragma unroll
      for (int n = 0; n + 1 < NDW; n += 2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, b_addr(sdOs, LD, wd + n * 8, j, lane));
        mma_bf16(acc_v[n], ap, bo[0], bo[1]);
        mma_bf16(acc_v[n + 1], ap, bo[2], bo[3]);
        ldsm_x4_t(bq, b_addr(sQs, LD, wd + n * 8, j, lane));
        mma_bf16(acc_k[n], ads, bq[0], bq[1]);
        mma_bf16(acc_k[n + 1], ads, bq[2], bq[3]);
      }
      if constexpr (NDW % 2) {  // hd = 16: one 8-wide column tile a warp
        uint32_t bo[2], bq[2];
        ldsm_x2_t(bo, b_addr(sdOs, LD, wd + (NDW - 1) * 8, j, lane));
        mma_bf16(acc_v[NDW - 1], ap, bo[0], bo[1]);
        ldsm_x2_t(bq, b_addr(sQs, LD, wd + (NDW - 1) * 8, j, lane));
        mma_bf16(acc_k[NDW - 1], ads, bq[0], bq[1]);
      }
    }
    __syncthreads();  // everyone is done with this stage and with pᵀ, dsᵀ
  }
  cp_async_wait<0>();  // nothing in flight at exit (an empty range issues loads too)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = k_base + (int64_t)(wr + g + 8 * i) * k_stride + wd + 2 * t;
#pragma unroll
    for (int n = 0; n < NDW; ++n) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * n) =
          pack_bf16(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * n) =
          pack_bf16(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int S, int Tk,
                  int H, int Kv, int causal, int window, float scale, cudaStream_t stream) {
  using C = DkvTc<D>;
  if (Tk % C::BN || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(lse) || !aligned16(delta) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Kv, Tk / C::BN);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            (const bf16*)dout, lse, delta, (bf16*)dk,
                                            (bf16*)dv, S, Tk, H, Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_dkv_tc(int B, int T, int Kv, int* out) {
  using C = DkvTc<D>;
  auto kernel = flash_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, C::NTH, C::SMEM);
  out[0] = B * Kv * (T / C::BN);
  out[2] = C::NTH;
  out[3] = (int)C::SMEM;
  return (int)err;
}

}  // namespace fa

// window <= 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                         int T, int H, int Kv, int hd, int causal, int window, float scale,
                         int is_bf16, void* stream) {
  if (S % fa::DKV_BM || T % fa::DKV_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  // by type, not a fallback: bf16 only ever reaches the tensor-core kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_dkv_tc, hd, q, k, v, dout, (const float*)lse, (const float*)delta,
                 dk, dv, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_dkv_fma, hd, q, k, v, dout, (const float*)lse, (const float*)delta, dk,
               dv, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_dkv_tc).
extern "C" int flash_dkv_grid(int B, int T, int Kv, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_dkv_tc, hd, B, T, Kv, out);
}
