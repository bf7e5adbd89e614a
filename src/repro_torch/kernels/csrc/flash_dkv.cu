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
// dk, dv written once.  Beside them each visible entry takes one exponent on
// the special-function units (16 a clock an SM): at olmoe-1b-7b's shape
// (hd 128) 0.145 ms against the products' 0.556 ms, so the elementwise
// passes have to run while products are in flight.
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
// * bf16 -> flash_dkv_wg_kernel, on `wgmma` (hopper.cuh, flash_wg.cuh).  A
//   block of two warpgroups keeps its keys' K and V in shared memory; Q, dO,
//   lse and delta of each (head of the group, query tile) pair stream
//   through a ring of mbarrier stages (Q and dO one TMA box a 64-row tile,
//   hop::make_tile_map; lse and delta a bulk copy each), issued by thread 0
//   (no producer warp: see ssd_chunk.cu's note).  The score tiles are formed
//   transposed (keys x queries).  Per pair: sᵀ = k·qᵀ and dpᵀ = v·doᵀ, pᵀ =
//   exp2(sᵀ·scale·log2 e − lse·log2 e) and dsᵀ = pᵀ·(dpᵀ − delta)·scale in
//   fp32 registers, both rounded to bf16 — the one rounding the fp32 path
//   does not have — then dv += pᵀ·do and dk += dsᵀ·q with do and q read
//   MN-major.  Two layouts by head dim:
//     - hd <= 128 ("rows"): 128 keys a block, 64 a warpgroup with all hd
//       columns of dk and dv in its registers (hd 128: 128 accumulators a
//       thread, 234 registers in all); m64n64 score products from shared
//       memory, pᵀ and dsᵀ as the register A operands of the m64nhd products
//       (`fa::c_to_a`, as FlashAttention-3's backward); each warpgroup runs
//       on its own, and a stage is refilled once both have released it (an
//       mbarrier of two arrivals that thread 0 waits on).
//     - hd 256 ("split"): 64 keys a block; one warpgroup cannot hold 64 x 256
//       of both dk and dv (256 registers a thread), so warpgroup w owns
//       columns 128 w .. 128 w + 127 of both.  It forms sᵀ and dpᵀ for
//       queries 32 w .. 32 w + 31 of the tile (m64n32; K held in registers
//       as the A operand of sᵀ, 64 a thread), writes its pᵀ and dsᵀ into two
//       64 x 64 swizzled bf16 tiles, and after a block barrier reads them
//       whole as the A operand of its m64n128 products.  Splitting the
//       columns of dk, dv at hd 128 as well ran slower (PERF.md §6).
//   Masked entries get p = 0 before the exponent is taken; a tile the mask
//   leaves whole takes a branch without the per-entry test, and the
//   exponent is one ex2.approx.ftz (flash_wg.cuh).  Registers (ptxas) at hd
//   16 / 32 / 64 / 128 / 256: 122 / 137 / 168 / 234 / 254, no spill; shared
//   memory 23,096 / 43,576 / 84,536 / 166,456 / 215,080 bytes, one block an
//   SM.
//   Distance from the bound (B 4, S = T 4096, causal; chip_smoke.py on an
//   NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md row 3): gemma3-1b's
//   global layer (H 4, Kv 1, hd 256) 0.532 ms against 0.278 ms, 52 %; its
//   512-key window 0.181 ms against 0.0651 ms, 36 %; olmoe-1b-7b's layer
//   (H = Kv = 16, hd 128) 1.135 ms against 0.556 ms, 49 % (the mma.sync
//   kernel: 1.226, 0.388, 3.01 ms).  What is left, from a clock64 count of
//   the phases (scripts/flash_bwd_phases.py): the score products read both
//   operands from shared memory (m64n64 at hd 128, m64n32 at hd 256); thread
//   0's copies and its wait for the other warpgroup to release a stage; at
//   hd 256 the two block barriers of each pair.
// * fp32 -> flash_dkv_kernel, IEEE fp32 FMAs from fp32 shared tiles, 32 keys
//   a block (below), so fp32 inputs keep their 5e-5 parity with the plain
//   version.
#include "flash_common.cuh"
#include "flash_wg.cuh"

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
template <int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
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

  load_tile<D, BN>(sK, k + k_base, k_stride);
  load_tile<D, BN>(sV, v + k_base, k_stride);

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
      load_tile<D, BM>(sQ, q + q_base, q_stride);
      load_tile<D, BM>(sdO, dout + q_base, q_stride);
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
  store_rows<D, NR>(dk + k_base, k_stride, ty, tx, acc_k, one);
  store_rows<D, NR>(dv + k_base, k_stride, ty, tx, acc_v, one);
}

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int S,
                   int Tk, int H, int Kv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Kv, Tk / DKV_BN);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                                     delta, (float*)dk, (float*)dv, S, Tk, H, Kv, causal, window,
                                     scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on wgmma --------------------------------------------------------------

template <int D>
struct DkvWg {
  // hd 256: the head-dim columns of dk and dv split over the two warpgroups
  static constexpr bool SPLIT = D > 128;
  static constexpr int BN = SPLIT ? 64 : 128;   // keys of a block (64 a warpgroup unless SPLIT)
  static constexpr int BM = 64;                 // query rows of a streamed tile
  static constexpr int NTH = 256;               // two warpgroups
  static constexpr int STAGES = SPLIT ? 2 : 3;  // the Q, dO, lse, delta ring
  static constexpr int DN = SPLIT ? D / 2 : D;  // columns of dk, dv a warpgroup owns
  static constexpr int TILE = 64 * D * 2;       // bytes of a 64-row bf16 tile
  // K, V; the ring's Q, dO; pᵀ, dsᵀ (SPLIT); lse, delta; the barriers; and
  // 1024 bytes to align the base
  static constexpr size_t SMEM = 1024 + (size_t)(2 * BN / 64 + 2 * STAGES) * TILE +
                                 (SPLIT ? 2 * BN * BM * 2 : 0) + STAGES * 2 * BM * 4 +
                                 (1 + 2 * STAGES) * 8;
};

// grid (B, Kv, ceil(T / BN)); q, do: (B,S,H,D) and k, v by TMA (maps);
// dk, dv: (B,T,Kv,D); lse, delta: (B,H,S).  See the note at the top.
template <int D>
__global__ void __launch_bounds__(DkvWg<D>::NTH, 1)
flash_dkv_wg_kernel(const __grid_constant__ FlashMaps maps, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int Tk, int H, int Kv, int causal, int window,
                    float scale) {
  using C = DkvWg<D>;
  constexpr int BN = C::BN, BM = C::BM, ST = C::STAGES, DN = C::DN;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int SC = hop::Sw<D>::C;  // columns of a sub-tile
  extern __shared__ uint8_t smem_raw[];
  const int b = blockIdx.x, kvh = blockIdx.y, k0 = blockIdx.z * BN;
  const int G = H / Kv, off = Tk - S;
  const int kb = min(BN, Tk - k0);  // the block's keys: BN, or 64 in a ragged last block
  int qt_lo, qt_hi;
  query_tile_range(k0, kb, BM, off, S, causal, window, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_it = G * nq;  // (head of the group, query tile) pairs
  // the warpgroup, broadcast from lane 0 so that ptxas sees it (and what
  // follows from it) as uniform over the warp: a product under a branch it
  // cannot prove uniform is serialized
  const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const int wq = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the warpgroup's 64 keys (SPLIT: the block's, and columns DN w .. of dk, dv)
  const int kw0 = SPLIT ? k0 : k0 + 64 * w;
  const bool active = kw0 < Tk;
  const int col0 = SPLIT ? DN * w : 0;

  float acc_k[DN / 2], acc_v[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_it > 0) {  // else no query sees these keys: dk = dv = 0
    uint8_t* base = smem_base(smem_raw);
    bf16* sK = reinterpret_cast<bf16*>(base);  // 64-row tiles, one a warpgroup unless SPLIT
    bf16* sV = sK + BN * D;
    bf16* sQ = sV + BN * D;                    // [ST][BM][D]
    bf16* sdO = sQ + ST * BM * D;              // [ST][BM][D]
    bf16* sP = sdO + ST * BM * D;              // SPLIT: pᵀ [BN][BM]
    bf16* sdS = sP + (SPLIT ? BN * BM : 0);    // SPLIT: dsᵀ [BN][BM]
    float* sL = reinterpret_cast<float*>(sdS + (SPLIT ? BN * BM : 0));  // [ST][BM]
    float* sDl = sL + ST * BM;                                           // [ST][BM]
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDl + ST * BM);
    uint64_t* full = kv_full + 1;  // [ST]: a stage's copies are in
    uint64_t* empty = full + ST;   // [ST]: both warpgroups are done with it
    if (threadIdx.x == 0) {
      hop::mbar_init(kv_full, 1);
      for (int s = 0; s < ST; ++s) {
        hop::mbar_init(&full[s], 1);
        hop::mbar_init(&empty[s], 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // pair n (head kvh G + n / nq, query tile qt_lo + n % nq) into stage n % ST,
    // issued by thread 0
    auto issue = [&](int n) {
      const int s = n % ST, h = kvh * G + n / nq, q0 = (qt_lo + n % nq) * BM;
      const int64_t row = ((int64_t)b * H + h) * S + q0;
      hop::fence_async_smem();
      hop::mbar_expect_tx(&full[s], 2 * C::TILE + 2 * BM * 4);
      tma_rows(sQ + s * BM * D, &maps.q, q0, h, b, &full[s]);
      tma_rows(sdO + s * BM * D, &maps.dout, q0, h, b, &full[s]);
      hop::bulk_load(sL + s * BM, lse + row, BM * 4, &full[s]);
      hop::bulk_load(sDl + s * BM, delta + row, BM * 4, &full[s]);
    };
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(kv_full, 2 * (kb / 64) * C::TILE);
      for (int r = 0; r < kb; r += 64) {
        tma_rows(sK + r * D, &maps.k, k0 + r, kvh, b, kv_full);
        tma_rows(sV + r * D, &maps.v, k0 + r, kvh, b, kv_full);
      }
      for (int n = 0; n < ST && n < n_it; ++n) issue(n);
    }
    __syncwarp();

    const bf16* sKw = sK + (SPLIT ? 0 : 64 * w * D);
    const bf16* sVw = sV + (SPLIT ? 0 : 64 * w * D);
    const int kr = kw0 + 16 * wq + g;  // the thread's keys kr, kr + 8
    const float sl2 = scale * LOG2E;
    hop::mbar_wait(kv_full, 0);
    // hd 256: K, the A operand of every sᵀ product, held in registers
    uint32_t ka[SPLIT ? D / 16 : 1][4];
    if constexpr (SPLIT) hop::tile_a_regs<D>(ka, sK, wq, lane);
    if constexpr (!SPLIT) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, q0 = (qt_lo + it % nq) * BM;
        const bf16* sQs = sQ + s * BM * D;
        const bf16* sdOs = sdO + s * BM * D;
        const float* L = sL + s * BM;
        const float* Dl = sDl + s * BM;
        const bool none = !active || (causal && kw0 > q0 + BM - 1 + off) ||
                          (window > 0 && q0 + off - (kw0 + 63) >= window);
        const bool all = (!causal || kw0 + 63 <= q0 + off) &&
                         (window <= 0 || q0 + BM - 1 + off - kw0 < window);
        hop::mbar_wait(&full[s], (it / ST) & 1);
        if (!none) {
          // sᵀ = k·qᵀ and dpᵀ = v·doᵀ: the warpgroup's 64 keys x 64 queries
          float st[32], dpt[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
          hop::wg_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hop::wgmma_ss<0>(st, hop::Sw<D>::desc_k(sKw, k, 64), hop::Sw<D>::desc_k(sQs, k, BM),
                             1);
          hop::wg_commit();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hop::wgmma_ss<0>(dpt, hop::Sw<D>::desc_k(sVw, k, 64),
                             hop::Sw<D>::desc_k(sdOs, k, BM), 1);
          hop::wg_commit();
          // pᵀ = exp2(sᵀ·scale·log2 e − lse·log2 e) while dpᵀ is formed
          hop::wg_wait<1>();
          hop::fence_regs(st);
          if (all) {  // every entry visible (a tile of the warpgroup, so uniform)
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              const int qc = 8 * nb + 2 * t;
              const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                st[4 * nb + e] = ex2(st[4 * nb + e] * sl2 - ((e & 1) ? l2.y : l2.x) * LOG2E);
            }
          } else {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              const int qc = 8 * nb + 2 * t;
              const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * nb + e;
                const float x = st[i] * sl2 - ((e & 1) ? l2.y : l2.x) * LOG2E;
                st[i] = visible(q0 + qc + (e & 1) + off, kr + 8 * (e >> 1), causal, window) ? ex2(x)
                                                                                          : 0.f;
              }
            }
          }
          hop::wg_wait<0>();
          hop::fence_regs(dpt);
          // dsᵀ = pᵀ·(dpᵀ − delta)·scale
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * nb + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * nb + e;
              dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * scale;
            }
          }
          // dv += pᵀ·do and dk += dsᵀ·q: pᵀ and dsᵀ rounded to bf16 in the A operand
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            c_to_a(pa[kk], st + 8 * kk, st + 8 * kk + 4);
            c_to_a(da[kk], dpt + 8 * kk, dpt + 8 * kk + 4);
          }
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_rs<1>(acc_v, pa[kk], hop::Sw<D>::desc_mn(sdOs, kk, BM), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_rs<1>(acc_k, da[kk], hop::Sw<D>::desc_mn(sQs, kk, BM), 1);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::fence_regs(acc_v);
          hop::fence_regs(acc_k);
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
        const int s = it % ST, q0 = (qt_lo + it % nq) * BM;
        const bf16* sQs = sQ + s * BM * D;
        const bf16* sdOs = sdO + s * BM * D;
        const float* L = sL + s * BM;
        const float* Dl = sDl + s * BM;
        const bool all = (!causal || kw0 + 63 <= q0 + off) &&
                         (window <= 0 || q0 + BM - 1 + off - kw0 < window);
        hop::mbar_wait(&full[s], (it / ST) & 1);
        // sᵀ and dpᵀ of the block's 64 keys x this warpgroup's 32 queries
        float st[16], dpt[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
        hop::wg_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hop::wgmma_rs<0>(st, ka[k], hop::Sw<D>::desc_k(sQs + 32 * w * SC, k, BM), 1);
        hop::wg_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hop::wgmma_ss<0>(dpt, hop::Sw<D>::desc_k(sV, k, 64),
                           hop::Sw<D>::desc_k(sdOs + 32 * w * SC, k, BM), 1);
        hop::wg_commit();
        hop::wg_wait<1>();
        hop::fence_regs(st);
        if (all) {  // every entry visible (a tile of the block, so uniform)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int qc = 32 * w + 8 * nb + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * nb + e] = ex2(st[4 * nb + e] * sl2 - ((e & 1) ? l2.y : l2.x) * LOG2E);
          }
        } else {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int qc = 32 * w + 8 * nb + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * nb + e;
              const float x = st[i] * sl2 - ((e & 1) ? l2.y : l2.x) * LOG2E;
              st[i] = visible(q0 + qc + (e & 1) + off, kr + 8 * (e >> 1), causal, window) ? ex2(x)
                                                                                        : 0.f;
            }
          }
        }
        hop::wg_wait<0>();
        hop::fence_regs(dpt);
        // pᵀ and dsᵀ rounded to bf16 into the 64 x 64 canonical tiles, which
        // both warpgroups read whole as the A operand
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int qc = 32 * w + 8 * nb + 2 * t;
          const float2 d2 = *reinterpret_cast<const float2*>(Dl + qc);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int i = 4 * nb + 2 * h2;
            const float ds0 = st[i] * (dpt[i] - d2.x) * scale;
            const float ds1 = st[i + 1] * (dpt[i + 1] - d2.y) * scale;
            const int o = hop::Sw<64>::off(16 * wq + g + 8 * h2, qc, 64);
            *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(sP) + o) =
                pack_bf16(st[i], st[i + 1]);
            *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(sdS) + o) =
                pack_bf16(ds0, ds1);
          }
        }
        hop::fence_async_smem();
        hop::bar_sync(3, 256);  // pᵀ and dsᵀ are whole
        // dv += pᵀ·do and dk += dsᵀ·q over this warpgroup's columns
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<1>(acc_v, hop::Sw<64>::desc_k(sP, kk, 64),
                           hop::Sw<D>::desc_mn(sdOs + DN * w * BM, kk, BM), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<1>(acc_k, hop::Sw<64>::desc_k(sdS, kk, 64),
                           hop::Sw<D>::desc_mn(sQs + DN * w * BM, kk, BM), 1);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(acc_v);
        hop::fence_regs(acc_k);
        hop::bar_sync(3, 256);  // both are done with pᵀ, dsᵀ and the stage
        if (threadIdx.x == 0 && it + ST < n_it) issue(it + ST);
        __syncwarp();
      }
    }
  }

  // dk and dv of the warpgroup's keys and columns, rounded to bf16 once
  if (active) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int64_t row =
          (((int64_t)b * Tk + kw0 + 16 * wq + g + 8 * h2) * Kv + kvh) * D + col0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < DN / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * nb) =
            pack_bf16(acc_k[4 * nb + 2 * h2], acc_k[4 * nb + 2 * h2 + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * nb) =
            pack_bf16(acc_v[4 * nb + 2 * h2], acc_v[4 * nb + 2 * h2 + 1]);
      }
    }
  }
}

template <int D>
int launch_dkv_wg(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int S, int Tk,
                  int H, int Kv, int causal, int window, float scale, cudaStream_t stream) {
  using C = DkvWg<D>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(lse) || !aligned16(delta) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  FlashMaps maps;
  int e = flash_maps(&maps, q, k, v, dout, B, S, Tk, H, Kv, D);
  if (e != 0) return e;
  auto kernel = flash_dkv_wg_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Kv, (Tk + C::BN - 1) / C::BN);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>(maps, lse, delta, (bf16*)dk, (bf16*)dv, S, Tk, H, Kv,
                                            causal, window, scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_dkv_wg(int B, int T, int Kv, int* out) {
  using C = DkvWg<D>;
  auto kernel = flash_dkv_wg_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, C::NTH, C::SMEM);
  out[0] = B * Kv * ((T + C::BN - 1) / C::BN);
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
  // by type, not a fallback: bf16 only ever reaches the wgmma kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_dkv_wg, hd, q, k, v, dout, (const float*)lse, (const float*)delta,
                 dk, dv, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_dkv_fma, hd, q, k, v, dout, (const float*)lse, (const float*)delta, dk,
               dv, B, S, T, H, Kv, causal, window, scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_dkv_wg).
extern "C" int flash_dkv_grid(int B, int T, int Kv, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_dkv_wg, hd, B, T, Kv, out);
}
