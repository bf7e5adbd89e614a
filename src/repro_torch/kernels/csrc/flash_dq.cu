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
// written once; at the training shapes that is far above the card's balance
// point, and the card has 989 TFLOP/s of them only inside the tensor cores.
//
// Two kernels behind one C entry point, chosen by the input type:
//
// * bf16 -> flash_dq_tc_kernel, on the tensor cores.  A block of 8 warps owns
//   64 query rows and keeps their Q and dO in shared memory as bf16; K and V
//   stream in 64-row bf16 tiles through a two-stage ring filled by cp.async
//   (tile j + 1 loads while tile j is multiplied).  All three products are
//   `mma.sync.m16n8k16` (bf16 operands by ldmatrix, fp32 accumulators).  Per
//   key tile:
//     1. s = q·kᵀ and dp = do·vᵀ; warp w forms the 16 x 32 pieces at query
//        rows 16 (w % 4), keys 32 (w / 4);
//     2. p = exp2(s·scale·log2 e − lse·log2 e) and ds = p·(dp − delta)·scale
//        in fp32 registers from the fp32 s and dp, then ds rounded to bf16 —
//        the one rounding the fp32 path does not have — into a 64 x 64 shared
//        tile;
//     3. dq += ds·k; warp w owns query rows 16 (w % 4) and head-dim columns
//        (hd / 2)·(w / 4) of dq, which stays in fp32 registers until the end.
//   Registers at hd = 256: dq 16 x 128 fp32 / 32 lanes = 64, s and dp 2 x 16.
//   Why the columns are split over two warps: the forward's tiling (one warp
//   owns 16 rows x all 256 columns, 128 accumulator registers, BN = 32)
//   already needs 252 registers, and dq adds a second score tile (dp) beside
//   lse and delta, so copying it would spill; BN = 16 would fit, but reloads
//   each Q and dO fragment for every 2 key columns.  Split, each Q / dO
//   fragment serves 4 key columns, a key tile is 64 wide, and ds crosses
//   shared memory once, as pᵀ and dsᵀ do in flash_dkv_tc_kernel.
//   Shared memory at hd = 256: Q, dO, and two stages of K and V at 264 bf16 a
//   row, plus ds at 72: 211,968 bytes, one block (8 warps) an SM.
//   Distance from the bound (B 4, S = T 4096, H 4, Kv 1, hd 256, causal,
//   chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit):
//   0.967 ms against 0.2085 ms, 22 %, on a global layer; 0.318 ms against
//   0.0489 ms, 15 %, with a 512-key window (the fp32-FMA path for bf16 took
//   7.43 and 2.03 ms).
//   Kept from the fp32 kernel: tiles that causality or the window mask wholly
//   are never visited (and fully visible tiles skip the per-entry mask), GQA
//   by index (q-head h reads kv-head h / G), the last query tiles, which see
//   the most keys, first.
// * fp32 -> flash_dq_kernel, IEEE fp32 FMAs from fp32 shared tiles (below),
//   so fp32 inputs keep their 5e-5 parity with the plain version.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace fa {

// ---- fp32: IEEE FMAs ----------------------------------------------------------
// The block keeps its 64 rows of Q and dO in fp32 shared memory for its whole
// life and streams K and V in 32-row tiles (with hd = 256 the four fp32 tiles
// fill 211 KB); s and dp are 4 x 2 register micro-tiles, ds goes through a
// small shared tile that only the writing warp reads back.

constexpr int DQ_BM = 64;  // query rows of a block
constexpr int DQ_BN = 32;  // keys of a streamed tile
constexpr int DQ_LDP = DQ_BN + 16;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * DQ_BM + 2 * DQ_BN) * (D + 4) + DQ_BM * DQ_LDP);
}

// grid (B, H, S / BM); q, do, dq: (B,S,H,D); k, v: (B,T,Kv,D); lse, delta: (B,H,S).
template <int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int S, int Tk, int H,
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
  const float* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const float* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  load_tile<D, BM>(sQ, q + q_base, q_stride);
  load_tile<D, BM>(sdO, dout + q_base, q_stride);

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
    load_tile<D, BN>(sK, kp + (int64_t)k0 * k_stride, k_stride);
    load_tile<D, BN>(sV, vp + (int64_t)k0 * k_stride, k_stride);
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
  store_rows<D, NR>(dq + q_base, q_stride, ty, tx, acc, one);
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B, int S, int Tk, int H,
                  int Kv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / DQ_BM);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                                     delta, (float*)dq, S, Tk, H, Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores -------------------------------------------------

template <int D>
struct DqTc {
  static constexpr int BM = 64;    // query rows of a block, 16 a warp row
  static constexpr int BN = 64;    // keys of a streamed tile
  static constexpr int NTH = 256;  // 8 warps
  static constexpr int LD = D + 8, LDP = BN + 8;  // shared row strides, bf16
  static constexpr size_t SMEM = sizeof(bf16) * ((2 * BM + 2 * 2 * BN) * LD + BM * LDP);
};

// grid (B, H, S / BM); q, do, dq: (B,S,H,D); k, v: (B,T,Kv,D); lse, delta: (B,H,S).
template <int D>
__global__ void __launch_bounds__(DqTc<D>::NTH, 1)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int S, int Tk, int H, int Kv, int causal, int window,
                   float scale) {
  using C = DqTc<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, LDP = C::LDP, NTH = C::NTH;
  constexpr int DW = D / 2;    // head-dim columns of dq a warp owns
  constexpr int NDW = DW / 8;  // their 8-wide column tiles (1 at hd = 16)
  extern __shared__ float4 smem_f4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_f4);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;       // [2 stages][BN][LD]
  bf16* sV = sK + 2 * BN * LD;    // [2 stages][BN][LD]
  bf16* sdS = sV + 2 * BN * LD;   // [BM][LDP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;   // the warp's 16 query rows
  const int wk = (warp >> 2) * 32;  // step 1: its 32 keys of the tile
  const int wd = (warp >> 2) * DW;  // step 3: its head-dim columns
  // the last query tiles see the most keys under causality: start them first
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (H / Kv);
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const int64_t q_base = (((int64_t)b * S + q0) * H + h) * D;
  const bf16* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const bf16* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  int kt_lo, kt_hi;
  key_tile_range(q0, BM, BN, off, Tk, causal, window, &kt_lo, &kt_hi);
  auto load_kv = [&](int kt, int stage) {
    const int64_t base = (int64_t)kt * BN * k_stride;
    cp_tile<D, LD, BN, NTH>(sK + stage * BN * LD, kp + base, k_stride);
    cp_tile<D, LD, BN, NTH>(sV + stage * BN * LD, vp + base, k_stride);
  };
  cp_tile<D, LD, BM, NTH>(sQ, q + q_base, q_stride);
  cp_tile<D, LD, BM, NTH>(sdO, dout + q_base, q_stride);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // this thread's two rows, wr + g and wr + g + 8: lse in log2 units, delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = ((int64_t)b * H + h) * S + q0 + wr + g + 8 * i;
    lse2[i] = lse[r] * LOG2E;
    dl[i] = delta[r];
  }
  float acc[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float sl2 = scale * LOG2E;
  const bf16* sQw = sQ + wr * LD;
  const bf16* sdOw = sdO + wr * LD;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q, dO and tile kt are in
    __syncthreads();
    const bf16* sKs = sK + stage * BN * LD;
    const bf16* sVs = sV + stage * BN * LD;

    // 1. s = q·kᵀ and dp = do·vᵀ, 16 query rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, a_addr(sQw, LD, d0, lane));
      ldsm_x4(ao, a_addr(sdOw, LD, d0, lane));
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bt_addr(sKs, LD, wk + n * 8, d0, lane));
        mma_bf16(s[n], aq, bk[0], bk[1]);
        mma_bf16(s[n + 1], aq, bk[2], bk[3]);
        ldsm_x4(bv, bt_addr(sVs, LD, wk + n * 8, d0, lane));
        mma_bf16(dp[n], ao, bv[0], bv[1]);
        mma_bf16(dp[n + 1], ao, bv[2], bv[3]);
      }
    }

    // 2. p and ds in fp32, ds stored to shared memory as bf16
    const int k0 = kt * BN;
    const bool full = (!causal || k0 + BN - 1 <= q0 + off) &&
                      (window <= 0 || q0 + BM - 1 + off - k0 < window);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int kc = wk + 8 * n + 2 * t;  // key column of c0 / c2
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // query row g, then g + 8
        const int qr = wr + g + 8 * i;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = full || visible(q0 + qr + off, k0 + kc + e, causal, window);
          const float p = vis ? exp2f(s[n][2 * i + e] * sl2 - lse2[i]) : 0.f;
          ds[e] = p * (dp[n][2 * i + e] - dl[i]) * scale;
        }
        *reinterpret_cast<uint32_t*>(sdS + qr * LDP + kc) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // 3. dq += ds·k: 16 query rows x hd/2 columns a warp
#pragma unroll
    for (int j = 0; j < BN; j += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(sdS + wr * LDP, LDP, j, lane));
#pragma unroll
      for (int n = 0; n + 1 < NDW; n += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, b_addr(sKs, LD, wd + n * 8, j, lane));
        mma_bf16(acc[n], a, bk[0], bk[1]);
        mma_bf16(acc[n + 1], a, bk[2], bk[3]);
      }
      if constexpr (NDW % 2) {  // hd = 16: one 8-wide column tile a warp
        uint32_t bk[2];
        ldsm_x2_t(bk, b_addr(sKs, LD, wd + (NDW - 1) * 8, j, lane));
        mma_bf16(acc[NDW - 1], a, bk[0], bk[1]);
      }
    }
    __syncthreads();  // everyone is done with this stage and with ds
  }
  cp_async_wait<0>();  // nothing in flight at exit (an empty range issues loads too)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = dq + q_base + (int64_t)(wr + g + 8 * i) * q_stride + wd + 2 * t;
#pragma unroll
    for (int n = 0; n < NDW; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) = pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int B, int S, int Tk, int H,
                 int Kv, int causal, int window, float scale, cudaStream_t stream) {
  using C = DqTc<D>;
  if (Tk % C::BN || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / C::BM);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            (const bf16*)dout, lse, delta, (bf16*)dq, S, Tk, H,
                                            Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_dq_tc(int B, int S, int H, int* out) {
  using C = DqTc<D>;
  auto kernel = flash_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, C::NTH, C::SMEM);
  out[0] = B * H * (S / C::BM);
  out[2] = C::NTH;
  out[3] = (int)C::SMEM;
  return (int)err;
}

}  // namespace fa

// window <= 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int S, int T,
                        int H, int Kv, int hd, int causal, int window, float scale,
                        int is_bf16, void* stream) {
  if (S % fa::DQ_BM || T % fa::DQ_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  // by type, not a fallback: bf16 only ever reaches the tensor-core kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_dq_tc, hd, q, k, v, dout, (const float*)lse, (const float*)delta,
                 dq, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_dq_fma, hd, q, k, v, dout, (const float*)lse, (const float*)delta, dq,
               B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_dq_tc).
extern "C" int flash_dq_grid(int B, int S, int H, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_dq_tc, hd, B, S, H, out);
}
