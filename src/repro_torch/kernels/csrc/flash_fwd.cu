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
// * bf16 -> flash_fwd_tc_kernel, on the tensor cores.  A block of 4 warps owns
//   64 query rows (16 a warp) and keeps them in shared memory as bf16; K and V
//   stream in BN-row bf16 tiles through a two-stage ring filled by cp.async, so
//   tile j + 1 is in flight while tile j is multiplied.  Both products are
//   `mma.sync.m16n8k16` (bf16 operands from ldmatrix, fp32 accumulators): s =
//   q·kᵀ into registers, the online softmax in fp32 registers (row max and sum
//   over the 4 lanes of a quad), then p, rounded to bf16, goes straight from the
//   score accumulators into the A operand of p·v (the fragment layouts match;
//   flash_mma.cuh).  This is the one rounding the fp32 path does not have; the
//   row sum l uses the fp32 p.  Why mma.sync and not wgmma: a wgmma tile is 64
//   rows a warpgroup, so at hd = 256 one warpgroup holds a 64 x 256 fp32 output
//   (128 registers a thread) beside the 64 x BN score tile, and keeping it fed
//   takes the producer/consumer split with register reallocation, swizzled
//   layouts and descriptors; the warp-level product keeps 16 rows a warp with
//   the same 128 accumulator registers and none of that machinery.  wgmma is the
//   next step for this kernel.  Registers at hd = 256: output 16 x 256 fp32 / 32
//   lanes = 128, scores 16 x BN / 32 = BN / 2, fragments 8, so BN = 32 there
//   (ptxas: 252 registers, no spills) and 64 for smaller head dims.  Shared
//   memory at hd = 256: (64 + 2 stages x 2 x 32) rows x 264 bf16 = 101,376
//   bytes, two blocks (8 warps) an SM.
//   Kept from the fp32 kernel: the finite NEG_INF, tiles that causality or
//   the window mask wholly are never visited (and fully visible tiles skip
//   the per-entry mask), GQA by index (q-head h reads kv-head h / G), the
//   last query tiles, which see the most keys, first.
//   Distance from the bound (B 4, S = T 4096, H 4, Kv 1, hd 256, causal,
//   chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit):
//   0.645 ms against 0.139 ms, 22 %, on a global layer; 0.213 ms against
//   0.0326 ms, 15 %, with a 512-key window.  What is left, inferred rather
//   than measured: every warp reads its K and V operands from shared memory
//   for its own 16 rows, so shared memory bandwidth, not the tensor cores,
//   sets the pace of mma.sync here.
// * fp32 -> flash_fwd_kernel, IEEE fp32 FMAs from fp32 shared tiles (below),
//   so fp32 inputs keep their 2e-5 parity with the plain version.
#include "flash_common.cuh"
#include "flash_mma.cuh"

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

// ---- bf16 on the tensor cores -------------------------------------------------

template <int D>
struct FwdTc {
  static constexpr int BM = 64;                   // query rows of a block, 16 a warp
  static constexpr int BN = D >= 256 ? 32 : 64;   // keys of a streamed tile
  static constexpr int NTH = 128;                 // 4 warps
  static constexpr int LD = D + 8;                // shared row stride, bf16
  static constexpr size_t SMEM = sizeof(bf16) * (BM + 2 * 2 * BN) * LD;
};

// grid (B, H, S / BM); q, o: (B,S,H,D); k, v: (B,T,Kv,D); lse: (B,H,S).
template <int D>
__global__ void __launch_bounds__(FwdTc<D>::NTH, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int S, int Tk, int H, int Kv, int causal, int window, float scale) {
  using C = FwdTc<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NTH = C::NTH;
  constexpr int NS = BN / 8;  // 8-key column tiles of the score tile
  constexpr int ND = D / 8;   // 8-wide column tiles of the output
  extern __shared__ float4 smem_f4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_f4);
  bf16* sK = sQ + BM * LD;       // [2 stages][BN][LD]
  bf16* sV = sK + 2 * BN * LD;   // [2 stages][BN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, h = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (H / Kv);
  const int off = Tk - S;
  const int64_t q_stride = (int64_t)H * D, k_stride = (int64_t)Kv * D;
  const bf16* kp = k + ((int64_t)b * Tk * Kv + kvh) * D;
  const bf16* vp = v + ((int64_t)b * Tk * Kv + kvh) * D;

  int kt_lo, kt_hi;
  key_tile_range(q0, BM, BN, off, Tk, causal, window, &kt_lo, &kt_hi);
  auto load_kv = [&](int kt, int stage) {
    const int64_t base = (int64_t)kt * BN * k_stride;
    cp_tile<D, LD, BN, NTH>(sK + stage * BN * LD, kp + base, k_stride);
    cp_tile<D, LD, BN, NTH>(sV + stage * BN * LD, vp + base, k_stride);
  };
  cp_tile<D, LD, BM, NTH>(sQ, q + (((int64_t)b * S + q0) * H + h) * D, q_stride);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // this thread's rows of the block: r[0] = 16 warp + g, r[1] = r[0] + 8
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const float sl2 = scale * LOG2E;  // scores in log2 units: p = exp2(s·sl2 − m)
  float acc[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16* sQw = sQ + warp * 16 * LD;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and tile kt are in
    __syncthreads();
    const bf16* sKs = sK + stage * BN * LD;
    const bf16* sVs = sV + stage * BN * LD;

    // s = q·kᵀ, 16 x BN a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(sQw, LD, d0, lane));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, bt_addr(sKs, LD, n * 8, d0, lane));
        mma_bf16(s[n], a, bb[0], bb[1]);
        mma_bf16(s[n + 1], a, bb[2], bb[3]);
      }
    }

    // mask, online softmax (fp32, log2 units)
    const int k0 = kt * BN;
    const bool full = (!causal || k0 + BN - 1 <= q0 + off) &&
                      (window <= 0 || q0 + BM - 1 + off - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!full && !visible(q0 + r0 + 8 * (e >> 1) + off, k0 + 8 * n + 2 * t + (e & 1),
                              causal, window))
          x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked entry contributes nothing, also while the max is still NEG_INF
        const float p = s[n][e] > 0.5f * NEG_INF ? exp2f(s[n][e] - mx[e >> 1]) : 0.f;
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p·v: p (bf16) from the score registers, v by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      c_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_addr(sVs, LD, n * 8, j * 16, lane));
        mma_bf16(acc[n], a, bb[0], bb[1]);
        mma_bf16(acc[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit (an empty range issues loads too)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const float li = fmaxf(l[i], 1e-30f), inv = 1.f / li;
    if (t == 0) lse[((int64_t)b * H + h) * S + row] = m[i] * LN2 + logf(li);
    bf16* orow = o + (((int64_t)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                  int Tk, int H, int Kv, int causal, int window, float scale,
                  cudaStream_t stream) {
  using C = FwdTc<D>;
  if (Tk % C::BN || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, H, S / C::BM);
  kernel<<<grid, C::NTH, C::SMEM, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            (bf16*)o, lse, S, Tk, H, Kv, causal, window,
                                            scale);
  return (int)cudaGetLastError();
}

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int D>
int grid_fwd_tc(int B, int S, int H, int* out) {
  using C = FwdTc<D>;
  auto kernel = flash_fwd_tc_kernel<D>;
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
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int T, int H, int Kv, int hd, int causal, int window,
                         float scale, int is_bf16, void* stream) {
  if (S % fa::FWD_BM || T % fa::FWD_BN || T < S || H % Kv) return (int)cudaErrorInvalidValue;
  // by type, not a fallback: bf16 only ever reaches the tensor-core kernel
  if (is_bf16)
    FA_SWITCH_HD(fa::launch_fwd_tc, hd, q, k, v, o, (float*)lse, B, S, T, H, Kv, causal, window,
                 scale, (cudaStream_t)stream);
  FA_SWITCH_HD(fa::launch_fwd_fma, hd, q, k, v, o, (float*)lse, B, S, T, H, Kv, causal, window,
               scale, (cudaStream_t)stream);
}

// The bf16 kernel's launch geometry for these dims (out[4], see grid_fwd_tc).
extern "C" int flash_fwd_grid(int B, int S, int H, int hd, int* out) {
  FA_SWITCH_HD(fa::grid_fwd_tc, hd, B, S, H, out);
}
