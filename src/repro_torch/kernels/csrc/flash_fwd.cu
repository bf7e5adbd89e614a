// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py (called from `flash_attention_fwd`):
// fused  q·kᵀ -> masked online softmax -> p·v, writing `o` and
// `lse = m + log l`; the S x T score matrix never reaches device memory.
//
// What bounds it on this card: operations — at the training shapes
// (S = T = 4096, hd = 256) it does over 1000 FLOPs for every byte of q, k, v
// and o, far above the card's balance point, and the card has 989 TFLOP/s of
// them only inside the tensor cores.
//
// Two kernels behind one C entry point, chosen by the input type:
//
// * bf16 -> flash_fwd_wg_kernel, on `wgmma` fed by TMA (hopper.cuh,
//   flash_wg.cuh).  A block of warpgroups owns 64 query rows each: three up to
//   hd 128, two at hd 256, where o takes 128 registers a thread (a ragged last
//   block runs those with rows).  Their Q tiles stay in shared memory; K and V
//   stream in 64-key tiles through two mbarrier rings (K three tiles deep, V
//   two), one TMA box a tile.  Per key tile j a warpgroup forms s = q·kᵀ
//   (m64n64, both operands from shared memory), the online softmax in fp32
//   registers (the row max over the 4 lanes of a quad, p = 2^(s·scale·log2 e
//   − m·scale·log2 e)), and o += p·v with p rounded to bf16 straight from
//   the score accumulators into the register A operand (`fa::c_to_a`) and v
//   read MN-major; o stays in fp32 registers (hd 256: two m64n128 halves).
//   The products overlap the softmax: s of tile j + 1 and p·v of tile j are
//   issued together, the softmax of j + 1 runs while p·v of j is in flight,
//   and o is rescaled once it lands (FlashAttention-3's "intra-warpgroup"
//   overlap), where a row's max grew (a warp-uniform test); the other
//   warpgroups fill the tensor cores meanwhile.  K is needed a tile earlier
//   than V, hence its deeper ring.  No producer warp (see ssd_chunk.cu's
//   note): thread 0 issues the first copies, and the last warpgroup to be
//   done with a stage (a count in shared memory) refills it, so that none
//   waits for another: a thread waiting for the others took 18–22 % of its
//   warpgroup's cycles, and the others' waits for the late K and V 17–28 %
//   (PERF.md).
//   The rounding is the mma.sync kernel's it replaced: s in fp32 from bf16
//   operands, p rounded to bf16 only where it meets v, the row sum l from the
//   fp32 p, lse = m + log l in fp32, o rounded to bf16 once; the exponent is
//   one ex2.approx.ftz (flash_wg.cuh), and 64-key tiles at every head dim
//   (32 at hd 256 before) move where the running max rescales.
//   Masked entries get s = NEG_INF by a select, on tiles the mask cuts only
//   (a warpgroup-uniform test, out of the per-entry loop); tiles the mask
//   hides wholly from the block are never visited (`key_tile_range`); the
//   last query tiles, which see the most keys, start first (a head's query
//   tiles side by side, for K and V in L2, leave its long tiles to the tail:
//   slower at gemma3-1b's global layer, no faster at olmoe-1b-7b's); GQA by
//   index (q-head h reads kv-head h / G).
//   Registers (ptxas) at hd 16 / 32 / 64 / 128 / 256: 82 / 90 / 106 / 138 /
//   215, no spill, no serialized product; shared memory 17,464 / 33,848 /
//   66,616 / 132,152 / 230,456 bytes, one block an SM at hd 128 and 256.
//   Distance from the bound (B 4, S = T 4096, causal; chip_smoke.py on an
//   NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md row 1): gemma3-1b's
//   global layer (H 4, Kv 1, hd 256) 0.24 ms of kernel against 0.139 ms,
//   58 %, faster than SDPA's forward; its 512-key window 0.10 ms against
//   0.033 ms, 32 %; olmoe-1b-7b's layer (H = Kv = 16, hd 128) 0.59 ms against
//   0.278 ms, 47 %, behind SDPA's 0.50 (the mma.sync kernel: 0.62, 0.20,
//   1.25 ms).  What is left, from a clock64 count of the phases
//   (scripts/flash_phases.py): the softmax, 23–36 % of a warpgroup's cycles
//   (the exponents on the special-function units), product issue waiting on
//   the other warpgroups' products, 23–37 %, waits for K and V, 7–13 %, and
//   each block's start (Q in), 18 % of a 512-key window's short blocks.
// * fp32 -> flash_fwd_kernel, IEEE fp32 FMAs from fp32 shared tiles (below),
//   so fp32 inputs keep their 2e-5 parity with the plain version.
#include "flash_common.cuh"
#include "flash_wg.cuh"

namespace fa {

// ---- fp32: IEEE FMAs ----------------------------------------------------------
// K and V stream through fp32 shared memory in 64-row tiles while the block's
// 64 query rows stay resident; 4 x 4 register micro-tiles and float4 shared
// reads give 8 FMAs per shared load; the running max, sum and output
// accumulators never leave registers (flash_common.cuh).

constexpr int FWD_BM = 64;  // query rows of a block
constexpr int FWD_BN = 64;  // keys of a streamed tile
constexpr int FWD_LDP = FWD_BN + 16;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((FWD_BM + 2 * FWD_BN) * (D + 4) + FWD_BM * FWD_LDP);
}

// grid (B, H, S / BM); q, o: (B,S,H,D); k, v: (B,T,Kv,D); lse: (B,H,S).
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H, int Kv,
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
  const float* qp = q + (((int64_t)b * S + q0) * H + h) * D;
  const float* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const float* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  load_tile<D, BM>(sQ, qp, q_stride);

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
    load_tile<D, BN>(sK, kp + (int64_t)k0 * k_stride, k_stride);
    load_tile<D, BN>(sV, vp + (int64_t)k0 * k_stride, k_stride);
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
  store_rows<D, NR>(o + (((int64_t)b * S + q0) * H + h) * D, q_stride, ty, tx, acc, inv);
}

template <int D>
int launch_fwd_fma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int Kv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / FWD_BM);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (float*)o, lse, S, Tk,
                                     H, Kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on wgmma --------------------------------------------------------------

template <int D>
struct FwdWg {
  // warpgroups of a block, 64 query rows each: three share a K, V tile up
  // to hd 128; at hd 256 two, since o takes 128 registers a thread
  static constexpr int NWG = D > 128 ? 2 : 3;
  static constexpr int BM = 64 * NWG;         // query rows of a block
  static constexpr int BN = 64;               // keys of a streamed tile
  static constexpr int NTH = 128 * NWG;
  static constexpr int KST = 3, VST = 2;      // the K and V rings
  static constexpr int TILE = 64 * D * 2;     // bytes of a 64-row bf16 tile
  static constexpr int NH = D > 128 ? 2 : 1;  // m64n128 halves of o (hd 256)
  static constexpr int NO = D / 2 / NH;       // o's accumulators a thread, a half
  // Q; the rings; the barriers and the V slots' release counts; and 1024
  // bytes to align the base
  static constexpr size_t SMEM =
      1024 + (size_t)(BM / 64 + KST + VST) * TILE + (1 + KST + VST) * 8 + VST * 4;
};

// grid (B, H, ceil(S / BM)); q, k, v by TMA (maps); o: (B,S,H,D); lse:
// (B,H,S).  See the note at the top.
template <int D>
__global__ void __launch_bounds__(FwdWg<D>::NTH, 1)
flash_fwd_wg_kernel(const __grid_constant__ FlashMaps maps, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int Tk, int H, int Kv, int causal,
                    int window, float scale) {
  using C = FwdWg<D>;
  constexpr int BN = C::BN, KST = C::KST, VST = C::VST, NH = C::NH, NO = C::NO;
  extern __shared__ uint8_t smem_raw[];
  // the last query tiles see the most keys under causality: start them first
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;
  const int kvh = h / (H / Kv), off = Tk - S;
  const int qb = min(C::BM, S - q0);  // the block's queries: BM, or fewer in a ragged last block
  int kt_lo, kt_hi;
  key_tile_range(q0, qb, BN, off, Tk, causal, window, &kt_lo, &kt_hi);
  const int n_it = kt_hi - kt_lo;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it (and what
  // follows from it) as uniform over the warp: a product under a branch it
  // cannot prove uniform is serialized
  const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const int wq = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * w;       // the warpgroup's 64 queries
  const int qr = qw0 + 16 * wq + g;  // the thread's query rows qr, qr + 8

  uint8_t* base = smem_base(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(base);  // [NWG][64][D], a tile a warpgroup
  bf16* sK = sQ + C::BM * D;                 // [KST][BN][D]
  bf16* sV = sK + KST * BN * D;              // [VST][BN][D]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + VST * BN * D);
  uint64_t* k_full = q_full + 1;   // [KST]: a K tile is in
  uint64_t* v_full = k_full + KST; // [VST]: a V tile is in
  // [VST]: warpgroups done with p·v of the slot's tile, counted to the last
  unsigned* v_done = reinterpret_cast<unsigned*>(v_full + VST);
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < KST; ++s) hop::mbar_init(&k_full[s], 1);
    for (int s = 0; s < VST; ++s) {
      hop::mbar_init(&v_full[s], 1);
      v_done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (64 * w >= qb) return;  // past a ragged last block's rows (no block barrier follows)

  // key tile kt_lo + j into its ring slot
  auto issue_k = [&](int j) {
    const int s = j % KST;
    hop::fence_async_smem();
    hop::mbar_expect_tx(&k_full[s], C::TILE);
    tma_rows(sK + s * BN * D, &maps.k, (kt_lo + j) * BN, kvh, b, &k_full[s]);
  };
  auto issue_v = [&](int j) {
    const int s = j % VST;
    hop::fence_async_smem();
    hop::mbar_expect_tx(&v_full[s], C::TILE);
    tma_rows(sV + s * BN * D, &maps.v, (kt_lo + j) * BN, kvh, b, &v_full[s]);
  };
  if (threadIdx.x == 0) {  // Q and the rings' first tiles; the warpgroups refill the rings
    hop::mbar_expect_tx(q_full, (qb / 64) * C::TILE);
    for (int r = 0; r < qb; r += 64) tma_rows(sQ + r * D, &maps.q, q0 + r, h, b, q_full);
    for (int j = 0; j < KST && j < n_it; ++j) issue_k(j);
    for (int j = 0; j < VST && j < n_it; ++j) issue_v(j);
  }
  __syncwarp();

  // running max (raw scores) and the thread's part of the row sum, rows qr, qr + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NH][NO];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[hh][i] = 0.f;

  if (n_it > 0) {
    const float sl2 = scale * LOG2E;  // p = 2^(s·sl2 − m·sl2)
    const bf16* sQw = sQ + 64 * w * D;
    float sc[32];        // the score tile: 64 queries x 64 keys, then its p in fp32
    uint32_t pa[4][4];   // p in bf16, the A operand of the 4 16-key steps of p·v
    float corr[2];

    // s = q·kᵀ of tile j (issued, not waited for)
    auto s_product = [&](int j) {
      const bf16* sKs = sK + (j % KST) * BN * D;
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        hop::wgmma_ss<0>(sc, hop::Sw<D>::desc_k(sQw, k, 64), hop::Sw<D>::desc_k(sKs, k, BN),
                         k > 0);
      hop::wg_commit();
    };
    // o += p·v of tile j
    auto pv_product = [&](int j) {
      const bf16* sVs = sV + (j % VST) * BN * D;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          hop::wgmma_rs<1>(acc[hh], pa[kk], hop::Sw<D>::desc_mn(sVs + hh * 128 * BN, kk, BN), 1);
      hop::wg_commit();
    };
    // the online softmax of tile j's scores: masked entries to NEG_INF (on a
    // tile the mask cuts), the new running max, corr = 2^((m_old − m)·sl2)
    // for o, p in fp32 into sc, the row sums
    auto softmax = [&](int j) {
      const int k0 = (kt_lo + j) * BN;
      const bool all = (!causal || k0 + BN - 1 <= qw0 + off) &&
                       (window <= 0 || qw0 + 63 + off - k0 < window);
      if (!all) {  // a tile of the warpgroup, so uniform
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * nb + e;
            sc[i] = visible(qr + 8 * (e >> 1) + off, k0 + 8 * nb + 2 * t + (e & 1), causal,
                            window)
                        ? sc[i]
                        : NEG_INF;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float nm[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = quad_max(mx[h2]);
        corr[h2] = ex2((m[h2] - mx[h2]) * sl2);
        m[h2] = mx[h2];
        // a row with no visible key yet: every p is 2^(NEG_INF·sl2) = 0
        nm[h2] = mx[h2] == NEG_INF ? 0.f : -mx[h2] * sl2;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = ex2(fmaf(sc[i], sl2, nm[(i >> 1) & 1]));
        ls[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) l[h2] = l[h2] * corr[h2] + ls[h2];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_to_a(pa[kk], sc + 8 * kk, sc + 8 * kk + 4);
    };

    hop::mbar_wait(q_full, 0);
    hop::mbar_wait(&k_full[0], 0);
    hop::wg_fence();
    s_product(0);
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    softmax(0);
    pack_p();
    for (int it = 0; it + 1 < n_it; ++it) {
      const int j = it + 1;
      hop::mbar_wait(&k_full[j % KST], (j / KST) & 1);
      hop::mbar_wait(&v_full[it % VST], (it / VST) & 1);
      hop::wg_fence();
      s_product(j);
      pv_product(it);
      // the softmax of tile j while p·v of tile it is in flight
      hop::wg_wait<1>();
      hop::fence_regs(sc);
      softmax(j);
      hop::wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) hop::fence_regs(acc[hh]);
      // o rescaled where a row's max grew (a warp-uniform test: corr is 1
      // exactly where it did not)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int i = 0; i < NO; ++i) acc[hh][i] *= corr[(i >> 1) & 1];
      }
      pack_p();
      // the stage of tile it is free once both warpgroups are done with it:
      // the last of them refills K three tiles on and V two, so that neither
      // waits for the other
      hop::bar_sync(1 + w, 128);
      if (tid == 0) {
        __threadfence_block();
        if (atomicInc(&v_done[it % VST], qb / 64 - 1) == qb / 64 - 1) {
          __threadfence_block();
          if (it + KST < n_it) issue_k(it + KST);
          if (it + VST < n_it) issue_v(it + VST);
        }
      }
      __syncwarp();
    }
    const int last = n_it - 1;
    hop::mbar_wait(&v_full[last % VST], (last / VST) & 1);
    hop::wg_fence();
    pv_product(last);
    hop::wg_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) hop::fence_regs(acc[hh]);
  }

  // lse = m·scale + log l; o = acc / l rounded to bf16 once
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = qr + 8 * h2;
    const float li = fmaxf(quad_sum(l[h2]), 1e-30f), inv = 1.f / li;
    if (t == 0) lse[((int64_t)b * H + h) * S + row] = m[h2] * scale + logf(li);
    bf16* orow = o + (((int64_t)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int nb = 0; nb < NO / 4; ++nb)
        *reinterpret_cast<uint32_t*>(orow + hh * 128 + 8 * nb) =
            pack_bf16(acc[hh][4 * nb + 2 * h2] * inv, acc[hh][4 * nb + 2 * h2 + 1] * inv);
  }
}

template <int D>
int launch_fwd_wg(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                  int Tk, int H, int Kv, int causal, int window, float scale,
                  cudaStream_t stream) {
  using C = FwdWg<D>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  FlashMaps maps;
  int e = flash_maps(&maps, q, k, v, nullptr, B, S, Tk, H, Kv, D);
  if (e != 0) return e;
  static bool limit_set[64] = {};
  auto kernel = flash_fwd_wg_kernel<D>;
  cudaError_t err = smem_limit_once(kernel, C::SMEM, limit_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, (S + C::BM - 1) / C::BM);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>(maps, (bf16*)o, lse, S, Tk, H, Kv, causal, window,
                                            scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_fwd_wg(int B, int S, int H, int* out) {
  using C = FwdWg<D>;
  auto kernel = flash_fwd_wg_kernel<D>;
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
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int T, int H, int Kv, int hd, int causal, int window,
                         float scale, int is_bf16, void* stream) {
  if (S % fa::FWD_BM || T % fa::FWD_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  // by type, not a fallback: bf16 only ever reaches the wgmma kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_fwd_wg, hd, q, k, v, o, (float*)lse, B, S, T, H, Kv, causal, window,
                 scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_fwd_fma, hd, q, k, v, o, (float*)lse, B, S, T, H, Kv, causal, window,
               scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_fwd_wg).
extern "C" int flash_fwd_grid(int B, int S, int H, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_fwd_wg, hd, B, S, H, out);
}
