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
// Each visible entry also takes one exponent on the special-function units
// (16 a clock an SM): at olmoe-1b-7b's shape (hd 128) 0.145 ms against the
// products' 0.417 ms.
//
// Two kernels behind one C entry point, chosen by the input type:
//
// * bf16 -> flash_dq_wg_kernel, on `wgmma` (hopper.cuh, flash_wg.cuh).  A
//   block of two warpgroups keeps its query rows' Q and dO in shared memory
//   and their lse and delta in registers; K and V stream in 64-row tiles
//   through a ring of mbarrier stages, one TMA box a tile (hop::make_tile_map),
//   issued by thread 0 (no producer warp: see ssd_chunk.cu's note).  Per key
//   tile, s = q·kᵀ and dp = do·vᵀ with both operands from shared memory, p =
//   exp2(s·scale·log2 e − lse·log2 e) and ds = p·(dp − delta)·scale in fp32
//   registers, ds rounded to bf16 — the one rounding the fp32 path does not
//   have — and dq += ds·k with k read MN-major; dq stays in fp32 registers
//   and sums the key tiles in key order.  Two layouts by head dim:
//     - hd <= 64 ("rows"): 128 query rows a block, 64 a warpgroup with all hd
//       columns of dq; each warpgroup runs on its own (m64n64 score products,
//       ds as the register A operand of dq's m64nhd product, `fa::c_to_a`),
//       and a stage is refilled once both have released it (an mbarrier of
//       two arrivals that thread 0 waits on).
//     - hd 128, 256 ("split"): 64 query rows a block; warpgroup w forms s and
//       dp for keys 32 w .. 32 w + 31 of the tile (m64n32), writes its ds
//       into a 64 x 64 swizzled bf16 tile, and after a block barrier adds the
//       whole ds times its hd / 2 columns of k into its half of dq (both
//       operands from shared memory).  At hd 256 Q is held in registers as
//       the A operand of s (64 a thread): s's operands then cost a third of
//       the shared-memory reads.  At hd 128 the block takes 92 registers a
//       thread and 107,560 bytes, so two blocks share an SM, which beat the
//       rows layout (PERF.md §6).
//   Masked entries get p = 0 before the exponent is taken; a tile the mask
//   leaves whole takes a branch without the per-entry test, and the
//   exponent is one ex2.approx.ftz (flash_wg.cuh: exp2f's branches cost more
//   than the products they ran beside).  Registers (ptxas) at hd 16 / 32 /
//   64 / 128 / 256: 103 / 110 / 126 / 92 / 189, no spill; shared memory
//   21,536 / 42,040 / 83,000 / 107,560 / 205,864 bytes.
//   Kept from the mma.sync kernel it replaced: key tiles the
//   mask hides wholly are never visited (the block's range), GQA by index
//   (q-head h reads kv-head h / G), the last query tiles, which see the most
//   keys, first; and its roundings.
//   Distance from the bound (B 4, S = T 4096, causal; chip_smoke.py on an
//   NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md row 2): gemma3-1b's
//   global layer (H 4, Kv 1, hd 256) 0.420 ms against 0.2085 ms, 50 %; its
//   512-key window 0.163 ms against 0.0489 ms, 30 %; olmoe-1b-7b's layer
//   (H = Kv = 16, hd 128) 0.918 ms against 0.417 ms, 45 % (the mma.sync
//   kernel: 0.956, 0.301, 2.19 ms).  What is left, from a clock64 count of
//   the phases (scripts/flash_bwd_phases.py): at hd 256 the m64n32 score
//   products, both operands but Q read from shared memory by both
//   warpgroups; each block's start (Q, dO and the first K, V tiles), which
//   a 512-key window's 9 key tiles do not amortize.
// * fp32 -> flash_dq_kernel, IEEE fp32 FMAs from fp32 shared tiles (below),
//   so fp32 inputs keep their 5e-5 parity with the plain version.
#include "flash_common.cuh"
#include "flash_wg.cuh"

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

// ---- bf16 on wgmma --------------------------------------------------------------

template <int D>
struct DqWg {
  // hd 256: the head-dim columns of dq split over the two warpgroups
  static constexpr bool SPLIT = D >= 128;
  static constexpr int BM = SPLIT ? 64 : 128;   // query rows of a block (64 a warpgroup unless SPLIT)
  static constexpr int BN = 64;                 // keys of a streamed tile
  static constexpr int NTH = 256;               // two warpgroups
  static constexpr int STAGES = SPLIT ? 2 : 3;  // the K, V ring
  static constexpr int DN = SPLIT ? D / 2 : D;  // columns of dq a warpgroup owns
  static constexpr int TILE = 64 * D * 2;       // bytes of a 64-row bf16 tile
  // Q, dO; the ring's K, V; ds (SPLIT); the barriers; and 1024 bytes to
  // align the base
  static constexpr size_t SMEM = 1024 + (size_t)(2 * BM / 64 + 2 * STAGES) * TILE +
                                 (SPLIT ? BM * BN * 2 : 0) + (1 + 2 * STAGES) * 8;
};

// grid (B, H, ceil(S / BM)); q, do, k, v by TMA (maps); dq: (B,S,H,D); lse,
// delta: (B,H,S).  See the note at the top.
template <int D>
__global__ void __launch_bounds__(DqWg<D>::NTH, 1)
flash_dq_wg_kernel(const __grid_constant__ FlashMaps maps, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int S, int Tk, int H,
                   int Kv, int causal, int window, float scale) {
  using C = DqWg<D>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, DN = C::DN;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int SC = hop::Sw<D>::C;  // columns of a sub-tile
  extern __shared__ uint8_t smem_raw[];
  // the last query tiles see the most keys under causality: start them first
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (H / Kv), off = Tk - S;
  const int qb = min(BM, S - q0);  // the block's queries: BM, or 64 in a ragged last block
  int kt_lo, kt_hi;
  key_tile_range(q0, qb, BN, off, Tk, causal, window, &kt_lo, &kt_hi);
  const int n_it = kt_hi - kt_lo;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it (and what
  // follows from it) as uniform over the warp: a product under a branch it
  // cannot prove uniform is serialized
  const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const int wq = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the warpgroup's 64 queries (SPLIT: the block's, and columns DN w .. of dq)
  const int qw0 = SPLIT ? q0 : q0 + 64 * w;
  const bool active = qw0 < S;
  const int col0 = SPLIT ? DN * w : 0;
  const int qr = qw0 + 16 * wq + g;  // the thread's query rows qr, qr + 8

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

  if (n_it > 0) {
    uint8_t* base = smem_base(smem_raw);
    bf16* sQ = reinterpret_cast<bf16*>(base);  // 64-row tiles, one a warpgroup unless SPLIT
    bf16* sdO = sQ + BM * D;
    bf16* sK = sdO + BM * D;                   // [ST][BN][D]
    bf16* sV = sK + ST * BN * D;               // [ST][BN][D]
    bf16* sdS = sV + ST * BN * D;              // SPLIT: ds [BM][BN]
    uint64_t* qo_full = reinterpret_cast<uint64_t*>(sdS + (SPLIT ? BM * BN : 0));
    uint64_t* full = qo_full + 1;  // [ST]: a stage's copies are in
    uint64_t* empty = full + ST;   // [ST]: both warpgroups are done with it
    if (threadIdx.x == 0) {
      hop::mbar_init(qo_full, 1);
      for (int s = 0; s < ST; ++s) {
        hop::mbar_init(&full[s], 1);
        hop::mbar_init(&empty[s], 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // key tile kt_lo + n into stage n % ST, issued by thread 0
    auto issue = [&](int n) {
      const int s = n % ST, k0 = (kt_lo + n) * BN;
      hop::fence_async_smem();
      hop::mbar_expect_tx(&full[s], 2 * C::TILE);
      tma_rows(sK + s * BN * D, &maps.k, k0, kvh, b, &full[s]);
      tma_rows(sV + s * BN * D, &maps.v, k0, kvh, b, &full[s]);
    };
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(qo_full, 2 * (qb / 64) * C::TILE);
      for (int r = 0; r < qb; r += 64) {
        tma_rows(sQ + r * D, &maps.q, q0 + r, h, b, qo_full);
        tma_rows(sdO + r * D, &maps.dout, q0 + r, h, b, qo_full);
      }
      for (int n = 0; n < ST && n < n_it; ++n) issue(n);
    }
    __syncwarp();

    // lse in log2 units and delta of the thread's two rows
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (qr + 8 * h2 < S) {
        const int64_t r = ((int64_t)b * H + h) * S + qr + 8 * h2;
        lse2[h2] = lse[r] * LOG2E;
        dl[h2] = delta[r];
      }
    }
    const bf16* sQw = sQ + (SPLIT ? 0 : 64 * w * D);
    const bf16* sdOw = sdO + (SPLIT ? 0 : 64 * w * D);
    const float sl2 = scale * LOG2E;
    hop::mbar_wait(qo_full, 0);
    // hd 256: Q, the A operand of every s product, held in registers
    uint32_t qa[SPLIT && D > 128 ? D / 16 : 1][4];
    if constexpr (SPLIT && D > 128) hop::tile_a_regs<D>(qa, sQ, wq, lane);
    if constexpr (!SPLIT) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, k0 = (kt_lo + it) * BN;
        const bf16* sKs = sK + s * BN * D;
        const bf16* sVs = sV + s * BN * D;
        const bool none = !active || (causal && k0 > qw0 + 63 + off) ||
                          (window > 0 && qw0 + off - (k0 + BN - 1) >= window);
        const bool all = (!causal || k0 + BN - 1 <= qw0 + off) &&
                         (window <= 0 || qw0 + 63 + off - k0 < window);
        hop::mbar_wait(&full[s], (it / ST) & 1);
        if (!none) {
          // s = q·kᵀ and dp = do·vᵀ: the warpgroup's 64 queries x 64 keys
          float sc[32], dp[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
          hop::wg_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hop::wgmma_ss<0>(sc, hop::Sw<D>::desc_k(sQw, k, 64), hop::Sw<D>::desc_k(sKs, k, BN),
                             1);
          hop::wg_commit();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hop::wgmma_ss<0>(dp, hop::Sw<D>::desc_k(sdOw, k, 64),
                             hop::Sw<D>::desc_k(sVs, k, BN), 1);
          hop::wg_commit();
          // p = exp2(s·scale·log2 e − lse·log2 e) while dp is formed
          hop::wg_wait<1>();
          hop::fence_regs(sc);
          if (all) {  // every entry visible (a tile of the warpgroup, so uniform)
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = ex2(sc[i] * sl2 - lse2[(i >> 1) & 1]);
          } else {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * nb + e, h2 = e >> 1;
                const float x = sc[i] * sl2 - lse2[h2];
                sc[i] = visible(qr + 8 * h2 + off, k0 + 8 * nb + 2 * t + (e & 1), causal, window)
                            ? ex2(x)
                            : 0.f;
              }
            }
          }
          hop::wg_wait<0>();
          hop::fence_regs(dp);
          // ds = p·(dp − delta)·scale, rounded to bf16 in the A operand of dq += ds·k
#pragma unroll
          for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;
          uint32_t da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) c_to_a(da[kk], dp + 8 * kk, dp + 8 * kk + 4);
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_rs<1>(acc, da[kk], hop::Sw<D>::desc_mn(sKs, kk, BN), 1);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::fence_regs(acc);
        }
        // the stage is free once both warpgroups are done with it
        hop::bar_sync(1 + w, 128);
        if (tid == 0) hop::mbar_arrive(&empty[s]);
        if (threadIdx.x == 0 && it + ST < n_it) {
          hop::mbar_wait(&empty[s], (it / ST) & 1);
          issue(it + ST);
        }
      }
    } else {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, k0 = (kt_lo + it) * BN;
        const bf16* sKs = sK + s * BN * D;
        const bf16* sVs = sV + s * BN * D;
        const bool all = (!causal || k0 + BN - 1 <= qw0 + off) &&
                         (window <= 0 || qw0 + 63 + off - k0 < window);
        hop::mbar_wait(&full[s], (it / ST) & 1);
        // s and dp of the block's 64 queries x this warpgroup's 32 keys
        float sc[16], dp[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
        hop::wg_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          if constexpr (D > 128)
            hop::wgmma_rs<0>(sc, qa[k], hop::Sw<D>::desc_k(sKs + 32 * w * SC, k, BN), 1);
          else
            hop::wgmma_ss<0>(sc, hop::Sw<D>::desc_k(sQ, k, 64),
                             hop::Sw<D>::desc_k(sKs + 32 * w * SC, k, BN), 1);
        }
        hop::wg_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hop::wgmma_ss<0>(dp, hop::Sw<D>::desc_k(sdO, k, 64),
                           hop::Sw<D>::desc_k(sVs + 32 * w * SC, k, BN), 1);
        hop::wg_commit();
        hop::wg_wait<1>();
        hop::fence_regs(sc);
        if (all) {  // every entry visible (a tile of the block, so uniform)
#pragma unroll
          for (int i = 0; i < 16; ++i) sc[i] = ex2(sc[i] * sl2 - lse2[(i >> 1) & 1]);
        } else {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * nb + e, h2 = e >> 1;
              const float x = sc[i] * sl2 - lse2[h2];
              sc[i] = visible(qr + 8 * h2 + off, k0 + 32 * w + 8 * nb + 2 * t + (e & 1), causal,
                              window)
                          ? ex2(x)
                          : 0.f;
            }
          }
        }
        hop::wg_wait<0>();
        hop::fence_regs(dp);
        // ds rounded to bf16 into the 64 x 64 canonical tile, which both
        // warpgroups read whole as the A operand
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int i = 4 * nb + 2 * h2;
            const float ds0 = sc[i] * (dp[i] - dl[h2]) * scale;
            const float ds1 = sc[i + 1] * (dp[i + 1] - dl[h2]) * scale;
            *reinterpret_cast<uint32_t*>(
                reinterpret_cast<uint8_t*>(sdS) +
                hop::Sw<64>::off(16 * wq + g + 8 * h2, 32 * w + 8 * nb + 2 * t, 64)) =
                pack_bf16(ds0, ds1);
          }
        }
        hop::fence_async_smem();
        hop::bar_sync(3, 256);  // ds is whole
        // dq += ds·k over this warpgroup's columns
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<1>(acc, hop::Sw<64>::desc_k(sdS, kk, 64),
                           hop::Sw<D>::desc_mn(sKs + DN * w * BN, kk, BN), 1);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(acc);
        hop::bar_sync(3, 256);  // both are done with ds and the stage
        if (threadIdx.x == 0 && it + ST < n_it) issue(it + ST);
        __syncwarp();
      }
    }
  }

  // dq of the warpgroup's rows and columns, rounded to bf16 once
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (qr + 8 * h2 < S) {
      bf16* row = dq + (((int64_t)b * S + qr + 8 * h2) * H + h) * D + col0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < DN / 8; ++nb)
        *reinterpret_cast<uint32_t*>(row + 8 * nb) =
            pack_bf16(acc[4 * nb + 2 * h2], acc[4 * nb + 2 * h2 + 1]);
    }
  }
}

template <int D>
int launch_dq_wg(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int B, int S, int Tk, int H,
                 int Kv, int causal, int window, float scale, cudaStream_t stream) {
  using C = DqWg<D>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  FlashMaps maps;
  int e = flash_maps(&maps, q, k, v, dout, B, S, Tk, H, Kv, D);
  if (e != 0) return e;
  auto kernel = flash_dq_wg_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, (S + C::BM - 1) / C::BM);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>(maps, lse, delta, (bf16*)dq, S, Tk, H, Kv, causal,
                                            window, scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_dq_wg(int B, int S, int H, int* out) {
  using C = DqWg<D>;
  auto kernel = flash_dq_wg_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, C::NTH, C::SMEM);
  out[0] = B * H * ((S + C::BM - 1) / C::BM);
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
  // by type, not a fallback: bf16 only ever reaches the wgmma kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_dq_wg, hd, q, k, v, dout, (const float*)lse, (const float*)delta,
                 dq, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_dq_fma, hd, q, k, v, dout, (const float*)lse, (const float*)delta, dq,
               B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_dq_wg).
extern "C" int flash_dq_grid(int B, int S, int H, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_dq_wg, hd, B, S, H, out);
}
