// Mamba-2 SSD within one chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel` of
// src/repro/kernels/ssd_chunk.py (called from `ssd_chunk`).  Per (batch,
// head, chunk) of Q rows, with x (Q,hp), dt (Q), B and C (Q,N) and a scalar
// decay rate a < 0:
//   cum     = cumsum(dt) * a
//   L_ij    = exp(cum_i - cum_j) for i >= j, else 0
//   y       = ((C B^T) . L) @ (x dt)                (Q, hp), x's dtype
//   states  = (B exp(cum_Q - cum))^T @ (x dt)       (N, hp), fp32
// and cum itself (fp32).  The Q x Q matrices never reach device memory.
//
// What bounds it on this card: bytes, for the tensor cores.  At mamba2-1.3b's
// shapes (Q = 256, hp = 64, N = 128, 64 heads, batch 4 x 4096) the causal
// half of the two Q x Q products and the states product are 69 GFLOP, 0.07 ms
// at the bf16 tensor-core rate, against 0.42 GB of inputs and outputs, 0.125
// ms at 3.35 TB/s.
//
// Shared by both kernels below: the TPU kernel holds the whole (Q,Q) decay and
// score matrices in VMEM; in fp32 at Q = 256 they are 256 KB each, more than
// an SM has (227 KB).  Here a block owns one chunk of one head and walks it in
// 64-row tiles: for a row tile i it keeps C_i in shared memory and streams the
// column tiles j <= i (tiles above the diagonal are never visited), forming
// C_i B_j^T . L_ij for one 64 x 64 tile at a time and adding (tile) @ (x dt)_j
// into y_i's registers.  exp is evaluated only where i >= j, so no exponent is
// ever positive and nothing overflows.  The states are a sum over every
// column tile of the chunk (the fp32 kernel takes it on the last row tile's
// walk, the bf16 kernel on a walk of its own).  cum is a prefix sum over the
// chunk inside the block (one warp).  The kernels read the model's
// (batch, chunk, row, head) layout through strides, and B/C through a head ->
// group index, so the model's tensors go in without a copy and B/C are not
// repeated per head.  Rows past Q (a ragged last tile) are zeros.
//
// * bf16 -> ssd_chunk_tc_kernel, on the tensor cores.  A block of 4 warps,
//   16 rows of the row tile each; C_i, B_j and x_j are bf16 tiles in shared
//   memory (rows padded by 16 bytes), B_j and x_j streamed through a
//   two-stage cp.async ring.  All three products are `mma.sync.m16n8k16`
//   (bf16 operands by ldmatrix, fp32 accumulators):
//     1. s = C_i·B_jᵀ (16 x 64 a warp, contraction N, in two halves of 32
//        keys), A by `a_addr`, B_j by `bt_addr`; on the diagonal tile warp w
//        forms only keys < 16 (w + 1);
//     2. att = s · exp(cum_i − cum_j) · dt_j in fp32 registers, masked to
//        i >= j, then rounded to bf16 — one rounding, as p in the flash
//        kernels — and repacked from the C fragments into the A operand;
//     3. y_i += att·x_j, x_j by `b_addr` + ldmatrix.trans, so x stays exact
//        bf16 (dt sits in att);
//     4. after all the pairs, a second walk over the column tiles (on the
//        same ring) sums states += (B_j · w)ᵀ·x_j, w_r = exp(cum_Q − cum_r)·dt_r:
//        Bᵀ is read as the A operand by `at_addr` + ldmatrix.trans and each
//        of its bf16 pairs is multiplied by its rows' w in fp32 and rounded
//        once; warp w owns the 16-row state tiles w, w + 4.
//   y is rounded to bf16 once at the end; states and cum stay fp32.
//   Registers: the states walk is separate from the pairs so that y's 32
//   accumulators and the states' 64 (hp 64, N 128) are never live together;
//   with the score tile formed in halves of 32 keys and the row copies not
//   fully unrolled, ptxas needs 127 at (64, 128), at most 128 (launch bounds:
//   3 blocks of 128 threads an SM).  Walking the states inside the last row tile's pairs
//   instead saves 4 tile loads a block but needs 255 registers, 2 blocks an
//   SM, and ran slower (PERF.md, findings).  Shared memory: C_i and two
//   stages of B_j, x_j at (N + 8) and (hp + 8) bf16 a row, plus dt, cum and w
//   for 256 rows: 73,728 bytes at hp 64, N 128, three blocks (12 warps) an SM.
//   Distance from the bound (mamba2-1.3b's shape above, chip_smoke.py on an
//   NVIDIA H100 80GB HBM3 at a 700 W power limit): 0.711 ms against 0.125 ms,
//   18 % (the fp32-FMA path for bf16 took 2.97 ms).  What is left, inferred
//   rather than measured: each warp reads all of B_j and x_j from shared
//   memory for its 16 rows, and B_j, x_j come again from L2 for every row
//   tile that sees them.
//   cp.async copies 16 bytes, so x, B and C must start on 16-byte boundaries
//   with every row stride a multiple of 8 elements (the wrapper checks it).
// * fp32 -> ssd_chunk_kernel, IEEE fp32 FMAs from fp32 shared tiles (below),
//   so fp32 inputs keep their 2e-5 parity with the plain version.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace ssd {

using fa::bf16;
using fa::NT;                 // 256 threads: 16 (ty) x 16 (tx)
constexpr int BT = 64;        // rows of a tile (row and column tiles alike)
constexpr int LDA = BT + 16;  // row stride of the score tile (as flash's sP)
constexpr int QMAX = 256;

struct Args {
  const void* x;
  const float* dt;
  const void* b;
  const void* c;
  const float* a;
  void* y;
  float* st;
  float* cum;
  // strides in elements: x, dt, y, cum over (batch, chunk, row, head);
  // b, c over (batch, chunk, row, group); st over (batch, chunk, head, n)
  int64_t sx[4], sd[4], sb[4], sc[4], sy[4], sk[4], ss[4];
  int64_t sa;
  int Q, rep;
};

// ---- fp32: IEEE FMAs ----------------------------------------------------------
// 16 x 16 threads; the score tile goes through shared memory, the states
// product is a scalar FMA loop on the last row tile.

// Rows [r0, r0 + BT) of a (Q, D) matrix into a zero-padded fp32 tile with row
// stride D + 4; each row multiplied by mul[row] when mul is given.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int r0,
                                          int Q, const float* mul) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < BT * V; idx += NT) {
    const int r = idx / V;
    const int col = (idx % V) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Q) {
      v = fa::ld4(src + (int64_t)(r0 + r) * stride + col);
      if (mul != nullptr) {
        const float s = mul[r0 + r];
        v = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
      }
    }
    fa::st4(dst + r * (D + 4) + col, v);
  }
}

// Column c of a thread's HP/16 columns (flash_common's tile_accum layout).
template <int HP>
__device__ __forceinline__ int col_of(int tx, int c) {
  if constexpr (HP >= 64) {
    return (tx + 16 * (c / 4)) * 4 + (c % 4);
  } else {
    return tx + 16 * c;
  }
}

template <int HP, int N>
constexpr size_t smem_floats(int QP) {
  return 3 * (size_t)QP + 2 * BT * (N + 4) + BT * (HP + 4) + BT * LDA;
}

// grid (nc, H, batch); one block per chunk of one head.
template <int HP, int N>
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(Args p) {
  constexpr int CPT = HP / 16;  // output columns of a thread
  constexpr int NPT = N / 16;   // states rows of a thread
  const int Q = p.Q;
  const int QP = (Q + BT - 1) / BT * BT;
  const int nt = QP / BT;
  const int c = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / p.rep;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ float4 smem_f4[];
  float* sDt = reinterpret_cast<float*>(smem_f4);
  float* sCum = sDt + QP;
  float* sSd = sCum + QP;  // exp(cum_Q - cum_j)
  float* sC = sSd + QP;
  float* sB = sC + BT * (N + 4);
  float* sX = sB + BT * (N + 4);
  float* sA = sX + BT * (HP + 4);

  const float* xp = (const float*)p.x + bb * p.sx[0] + c * p.sx[1] + h * p.sx[3];
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const float* bp = (const float*)p.b + bb * p.sb[0] + c * p.sb[1] + g * p.sb[3];
  const float* cp = (const float*)p.c + bb * p.sc[0] + c * p.sc[1] + g * p.sc[3];
  float* yp = (float*)p.y + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
  float* kp = p.cum + bb * p.sk[0] + c * p.sk[1] + h * p.sk[3];
  float* sp = p.st + bb * p.ss[0] + c * p.ss[1] + h * p.ss[2];
  const float a = p.a[h * p.sa];

  for (int r = threadIdx.x; r < QP; r += NT) sDt[r] = r < Q ? dtp[(int64_t)r * p.sd[2]] : 0.f;
  __syncthreads();

  // cum: one warp; lane l sums rows [l E, (l+1) E) and the lanes' totals are
  // scanned with shuffles.  Padded rows add dt = 0, so they repeat cum_{Q-1}.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int E = QP / 32;
    float tot = 0.f;
    for (int e = 0; e < E; ++e) tot += sDt[lane * E + e];
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.f;
    for (int e = 0; e < E; ++e) {
      run += sDt[lane * E + e];
      sCum[lane * E + e] = run * a;
    }
  }
  __syncthreads();
  const float cum_q = sCum[Q - 1];
  for (int r = threadIdx.x; r < QP; r += NT) {
    sSd[r] = expf(cum_q - sCum[r]);
    if (r < Q) kp[(int64_t)r * p.sk[2]] = sCum[r];
  }

  float st[NPT][CPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) st[k][j] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int i0 = it * BT;
    const bool last = it == nt - 1;
    __syncthreads();  // the previous row tile is done with sC (and sSd is written)
    load_rows<N>(sC, cp, p.sc[2], i0, Q, nullptr);

    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    const int jt_end = last ? nt : it + 1;
    for (int jt = 0; jt < jt_end; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();  // everyone is done with the previous sB, sX
      load_rows<N>(sB, bp, p.sb[2], j0, Q, nullptr);
      load_rows<HP>(sX, xp, p.sx[2], j0, Q, sDt);
      __syncthreads();

      if (jt <= it) {
        float s[4][4];
        fa::tile_dot<N, 4, 4>(sC, sB, ty, tx, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = j0 + tx + 16 * j;
            const float att = gi >= gj ? s[i][j] * expf(sCum[gi] - sCum[gj]) : 0.f;
            sA[(ty + 16 * i) * LDA + tx + 16 * j] = att;
          }
        }
        __syncwarp();  // a half warp reads back only the rows of sA it wrote
        fa::tile_accum<HP, 4, BT, LDA>(sA, sX, ty, tx, acc);
      }
      if (last) {
        // states[n][q] += sum_r B[r][n] exp(cum_Q - cum_r) (x dt)[r][q]
        for (int r = 0; r < BT; ++r) {
          const float sd = sSd[j0 + r];
          float bn[NPT], xq[CPT];
#pragma unroll
          for (int k = 0; k < NPT; ++k) bn[k] = sB[r * (N + 4) + ty + 16 * k] * sd;
#pragma unroll
          for (int j = 0; j < CPT; ++j) xq[j] = sX[r * (HP + 4) + col_of<HP>(tx, j)];
#pragma unroll
          for (int k = 0; k < NPT; ++k)
#pragma unroll
            for (int j = 0; j < CPT; ++j) st[k][j] = fmaf(bn[k], xq[j], st[k][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty + 16 * i;
      if (gi < Q) {
        float* row = yp + (int64_t)gi * p.sy[2];
#pragma unroll
        for (int j = 0; j < CPT; ++j) fa::st1(row + col_of<HP>(tx, j), acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    float* row = sp + (int64_t)(ty + 16 * k) * p.ss[3];
#pragma unroll
    for (int j = 0; j < CPT; ++j) row[col_of<HP>(tx, j)] = st[k][j];
  }
}

template <int HP, int N>
struct Fma {
  static int run(const Args& args, int Bt, int nc, int H, cudaStream_t stream) {
    const int QP = (args.Q + BT - 1) / BT * BT;
    const size_t smem = sizeof(float) * smem_floats<HP, N>(QP);
    auto kernel = ssd_chunk_kernel<HP, N>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nc, H, Bt), NT, smem, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

// ---- bf16 on the tensor cores -------------------------------------------------

template <int HP, int N>
struct Tc {
  static constexpr int NTH = 128;          // 4 warps, 16 rows of a row tile each
  static constexpr int LDN = N + 8;        // shared row strides, bf16
  static constexpr int LDX = HP + 8;
  static constexpr size_t SMEM =
      sizeof(bf16) * (3 * BT * LDN + 2 * BT * LDX) + sizeof(float) * 3 * QMAX;
};

// Rows [r0, r0 + BT) of a (Q, D) bf16 matrix into a shared tile with row
// stride LD by cp.async, 16 bytes a thread; rows past Q are zeros.
template <int D, int LD, int NTH>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int64_t stride, int r0,
                                        int Q) {
  constexpr int V = D / 8;
  // unrolled by 2, not fully: fully unrolled, ptxas keeps every row's address
  // offsets live across the kernel's loops and the kernel needs > 168 registers
#pragma unroll 2
  for (int i = 0; i < BT * V / NTH; ++i) {
    const int idx = threadIdx.x + i * NTH;
    const int r = idx / V, col = (idx % V) * 8;
    bf16* d = dst + r * LD + col;
    if (r0 + r < Q)
      fa::cp_async16(d, src + (int64_t)(r0 + r) * stride + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A pair of bf16 times (lo, hi) in fp32, rounded back to a pair of bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return fa::pack_bf16(f.x * lo, f.y * hi);
}

// grid (nc, H, batch); one block per chunk of one head.
template <int HP, int N>
__global__ void __launch_bounds__(Tc<HP, N>::NTH, 3) ssd_chunk_tc_kernel(Args p) {
  using C = Tc<HP, N>;
  constexpr int NTH = C::NTH, LDN = C::LDN, LDX = C::LDX;
  constexpr int NX = HP / 8;              // 8-wide column tiles of y and states
  constexpr int MT = N / 16;              // 16-row tiles of states
  constexpr int MPW = (MT + 3) / 4;       // of them a warp owns: w, w + 4, ...
  const int Q = p.Q;
  const int nt = (Q + BT - 1) / BT;
  const int c = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / p.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem_f4[];
  bf16* sC = reinterpret_cast<bf16*>(smem_f4);  // [BT][LDN]
  bf16* sB = sC + BT * LDN;                     // [2 stages][BT][LDN]
  bf16* sX = sB + 2 * BT * LDN;                 // [2 stages][BT][LDX]
  float* sDt = reinterpret_cast<float*>(sX + 2 * BT * LDX);  // [QMAX]
  float* sCum = sDt + QMAX;                                  // [QMAX]
  float* sW = sCum + QMAX;  // exp(cum_Q - cum_r) dt_r, [QMAX]

  const bf16* xp = (const bf16*)p.x + bb * p.sx[0] + c * p.sx[1] + h * p.sx[3];
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const bf16* bp = (const bf16*)p.b + bb * p.sb[0] + c * p.sb[1] + g * p.sb[3];
  const bf16* cp = (const bf16*)p.c + bb * p.sc[0] + c * p.sc[1] + g * p.sc[3];
  bf16* yp = (bf16*)p.y + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
  float* kp = p.cum + bb * p.sk[0] + c * p.sk[1] + h * p.sk[3];
  float* sp = p.st + bb * p.ss[0] + c * p.ss[1] + h * p.ss[2];
  const float a = p.a[h * p.sa];

  auto load_bx = [&](int jt, int stage) {
    cp_rows<N, LDN, NTH>(sB + stage * BT * LDN, bp, p.sb[2], jt * BT, Q);
    cp_rows<HP, LDX, NTH>(sX + stage * BT * LDX, xp, p.sx[2], jt * BT, Q);
  };
  load_bx(0, 0);
  fa::cp_async_commit();

  // dt, cum (one warp, as in the fp32 kernel), w; padded rows have dt = 0
  const int QP = nt * BT;
  for (int r = threadIdx.x; r < QP; r += NTH) sDt[r] = r < Q ? dtp[(int64_t)r * p.sd[2]] : 0.f;
  __syncthreads();
  if (warp == 0) {
    const int E = QP / 32;
    float tot = 0.f;
    for (int e = 0; e < E; ++e) tot += sDt[lane * E + e];
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.f;
    for (int e = 0; e < E; ++e) {
      run += sDt[lane * E + e];
      sCum[lane * E + e] = run * a;
    }
  }
  __syncthreads();
  const float cum_q = sCum[Q - 1];
  for (int r = threadIdx.x; r < QP; r += NTH) {
    sW[r] = expf(cum_q - sCum[r]) * sDt[r];
    if (r < Q) kp[(int64_t)r * p.sk[2]] = sCum[r];
  }

  // The ring carries the column tiles of every (row tile it, column tile
  // jt <= it) pair, then every column tile once more for the states: step q
  // < npairs is a pair, step npairs + jt the states' share of tile jt.  So
  // y's and the states' accumulators are never live together, which keeps the
  // kernel within the 168 registers that let 3 blocks share an SM.
  const int npairs = nt * (nt + 1) / 2, nsteps = npairs + nt;
  float acc[NX][4];
#pragma unroll
  for (int n = 0; n < NX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int li0 = warp * 16 + gq;  // the thread's rows li0, li0 + 8 of a row tile
  int it = 0, jt = 0;
  for (int q = 0; q < npairs; ++q) {
    const int stage = q & 1;
    // sC is free: the previous step ended with a barrier
    if (jt == 0) cp_rows<N, LDN, NTH>(sC, cp, p.sc[2], it * BT, Q);
    fa::cp_async_commit();
    const int next_it = jt < it ? it : it + 1, next_jt = jt < it ? jt + 1 : 0;
    load_bx(next_jt, stage ^ 1);  // after the last pair: tile 0, for the states
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // all but the newest group: C_i, B_j and x_j are in
    __syncthreads();
    const bf16* sBs = sB + stage * BT * LDN;
    const bf16* sXs = sX + stage * BT * LDX;
    const int i0 = it * BT, j0 = jt * BT;
    const bool diag = jt == it;
    // on the diagonal tile the warp's rows 16 w .. 16 w + 15 see keys < 16 (w + 1)
    const int ncol = diag ? 2 * (warp + 1) : 8;  // 8-key column tiles it needs
    const float ci[2] = {sCum[i0 + li0], sCum[i0 + li0 + 8]};

    // the tile's 64 keys in two halves of 32: 16 x 32 scores live at a time
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = 4 * half;  // first 8-key column tile of the half
      if (n0 >= ncol) break;

      // 1. s = C_i·B_jᵀ, 16 rows x 32 keys a warp
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t af[4];
        fa::ldsm_x4(af, fa::a_addr(sC + warp * 16 * LDN, LDN, k0, lane));
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          if (n0 + n < ncol) {
            uint32_t bf[4];
            fa::ldsm_x4(bf, fa::bt_addr(sBs, LDN, (n0 + n) * 8, k0, lane));
            fa::mma_bf16(s[n], af, bf[0], bf[1]);
            fa::mma_bf16(s[n + 1], af, bf[2], bf[3]);
          }
        }
      }

      // 2. att = s · exp(cum_i − cum_j) · dt_j for i >= j, in fp32
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n0 + n < ncol) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int li = li0 + 8 * (e >> 1), lj = 8 * (n0 + n) + 2 * t + (e & 1);
            float v = 0.f;
            if (!diag || li >= lj)
              v = s[n][e] * exp2f((ci[e >> 1] - sCum[j0 + lj]) * fa::LOG2E) * sDt[j0 + lj];
            s[n][e] = v;
          }
        }
      }

      // 3. y_i += att·x_j: att rounded to bf16 in the A operand, x_j exact
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int kk = 2 * half + kh;  // 16-key step of the tile
        if (2 * kk < ncol) {
          uint32_t af[4];
          fa::c_to_a(af, s[2 * kh], s[2 * kh + 1]);
#pragma unroll
          for (int n = 0; n < NX; n += 2) {
            uint32_t bx[4];
            fa::ldsm_x4_t(bx, fa::b_addr(sXs, LDX, n * 8, kk * 16, lane));
            fa::mma_bf16(acc[n], af, bx[0], bx[1]);
            fa::mma_bf16(acc[n + 1], af, bx[2], bx[3]);
          }
        }
      }
    }

    if (diag) {  // y_i is complete
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gi = i0 + li0 + 8 * i;
        if (gi < Q) {
          bf16* row = yp + (int64_t)gi * p.sy[2] + 2 * t;
#pragma unroll
          for (int n = 0; n < NX; ++n)
            *reinterpret_cast<uint32_t*>(row + 8 * n) =
                fa::pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < NX; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;  // for the next row tile
    }
    __syncthreads();  // everyone is done with this stage and with sC
    it = next_it;
    jt = next_jt;
  }

  // 4. states = Σ_j (B_j · w)ᵀ·x_j: Bᵀ read as the A operand by ldmatrix.trans,
  //    each bf16 pair times its rows' w in fp32, rounded once
  float st[MPW][NX][4];
#pragma unroll
  for (int m = 0; m < MPW; ++m)
#pragma unroll
    for (int n = 0; n < NX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][n][e] = 0.f;
  for (int q = npairs; q < nsteps; ++q) {
    const int stage = q & 1, j0 = (q - npairs) * BT;
    if (q + 1 < nsteps) load_bx(q + 1 - npairs, stage ^ 1);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // all but the newest group: B_j and x_j are in
    __syncthreads();
    const bf16* sBs = sB + stage * BT * LDN;
    const bf16* sXs = sX + stage * BT * LDX;
#pragma unroll 1  // unrolled, ptxas hoists the next steps' loads beside 64 accumulators
    for (int kk = 0; kk < 4; ++kk) {
      const int r = j0 + kk * 16 + 2 * t;  // k of a0 / a1; r + 8 for a2 / a3
      const float w0 = sW[r], w1 = sW[r + 1], w8 = sW[r + 8], w9 = sW[r + 9];
      uint32_t af[MPW][4];
#pragma unroll
      for (int mi = 0; mi < MPW; ++mi) {
        const int m = warp + 4 * mi;
        if (m < MT) {
          fa::ldsm_x4_t(af[mi], fa::at_addr(sBs, LDN, m * 16, kk * 16, lane));
          af[mi][0] = scale_pair(af[mi][0], w0, w1);
          af[mi][1] = scale_pair(af[mi][1], w0, w1);
          af[mi][2] = scale_pair(af[mi][2], w8, w9);
          af[mi][3] = scale_pair(af[mi][3], w8, w9);
        }
      }
#pragma unroll
      for (int n = 0; n < NX; n += 2) {
        uint32_t bx[4];
        fa::ldsm_x4_t(bx, fa::b_addr(sXs, LDX, n * 8, kk * 16, lane));
#pragma unroll
        for (int mi = 0; mi < MPW; ++mi) {
          if (warp + 4 * mi < MT) {
            fa::mma_bf16(st[mi][n], af[mi], bx[0], bx[1]);
            fa::mma_bf16(st[mi][n + 1], af[mi], bx[2], bx[3]);
          }
        }
      }
    }
    __syncthreads();  // everyone is done with this stage
  }
  fa::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
    const int m = warp + 4 * mi;
    if (m < MT) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = sp + (int64_t)(16 * m + gq + 8 * i) * p.ss[3] + 2 * t;
#pragma unroll
        for (int n = 0; n < NX; ++n)
          *reinterpret_cast<float2*>(row + 8 * n) =
              make_float2(st[mi][n][2 * i], st[mi][n][2 * i + 1]);
      }
    }
  }
}

template <int HP, int N>
struct TcLaunch {
  static int run(const Args& args, int Bt, int nc, int H, cudaStream_t stream) {
    using C = Tc<HP, N>;
    // 16-byte cp.async of x, B and C rows
    const int64_t* strides[3] = {args.sx, args.sb, args.sc};
    const void* bases[3] = {args.x, args.b, args.c};
    for (int i = 0; i < 3; ++i) {
      if (!fa::aligned16(bases[i])) return (int)cudaErrorInvalidValue;
      for (int d = 0; d < 4; ++d)
        if (strides[i][d] % 8) return (int)cudaErrorInvalidValue;
    }
    auto kernel = ssd_chunk_tc_kernel<HP, N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nc, H, Bt), C::NTH, C::SMEM, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int HP, int N>
struct TcGrid {
  static int run(int Bt, int nc, int H, int* out) {
    using C = Tc<HP, N>;
    auto kernel = ssd_chunk_tc_kernel<HP, N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, C::NTH, C::SMEM);
    out[0] = Bt * nc * H;
    out[2] = C::NTH;
    out[3] = (int)C::SMEM;
    return (int)err;
  }
};

// F<hp, N>::run(a...) for the head dims and state sizes the kernels are
// instantiated for (HEAD_DIMS, STATE_DIMS in ssd_chunk.py); anything else is
// cudaErrorInvalidValue.
template <template <int, int> class F, int HP, typename... A>
int switch_n(int N, A... a) {
  switch (N) {
    case 16: return F<HP, 16>::run(a...);
    case 32: return F<HP, 32>::run(a...);
    case 64: return F<HP, 64>::run(a...);
    case 128: return F<HP, 128>::run(a...);
  }
  return (int)cudaErrorInvalidValue;
}

template <template <int, int> class F, typename... A>
int switch_dims(int hp, int N, A... a) {
  switch (hp) {
    case 16: return switch_n<F, 16>(N, a...);
    case 32: return switch_n<F, 32>(N, a...);
    case 64: return switch_n<F, 64>(N, a...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd

// x (Bt,nc,Q,H,hp), dt (Bt,nc,Q,H) fp32, b and c (Bt,nc,Q,G,N), a (H,) fp32;
// y (Bt,nc,Q,H,hp) like x, st (Bt,nc,H,N,hp) fp32, cum (Bt,nc,Q,H) fp32.
// The last dimension of x, b, c, y and st is contiguous; `strides` holds the
// other 29 (see ssd::Args, in that order, then a's).  Head h reads group
// h / (H / G).  Returns cudaGetLastError() of the launch.
extern "C" int ssd_chunk(const void* x, const void* dt, const void* b, const void* c,
                         const void* a, void* y, void* st, void* cum,
                         const long long* strides, int Bt, int nc, int Q, int H, int G,
                         int hp, int N, int is_bf16, void* stream) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (Bt == 0 || nc == 0 || H == 0) return 0;
  ssd::Args args;
  args.x = x;
  args.dt = (const float*)dt;
  args.b = b;
  args.c = c;
  args.a = (const float*)a;
  args.y = y;
  args.st = (float*)st;
  args.cum = (float*)cum;
  int64_t* dst[7] = {args.sx, args.sd, args.sb, args.sc, args.sy, args.sk, args.ss};
  for (int t = 0; t < 7; ++t)
    for (int k = 0; k < 4; ++k) dst[t][k] = strides[4 * t + k];
  args.sa = strides[28];
  args.Q = Q;
  args.rep = H / G;
  cudaStream_t s = (cudaStream_t)stream;
  // by type, not a fallback: bf16 only ever reaches the tensor-core kernel
  if (is_bf16) return ssd::switch_dims<ssd::TcLaunch>(hp, N, args, Bt, nc, H, s);
  return ssd::switch_dims<ssd::Fma>(hp, N, args, Bt, nc, H, s);
}

// The bf16 kernel's launch geometry for these dims (out[4], see ssd::TcGrid).
extern "C" int ssd_chunk_grid(int Bt, int nc, int H, int hp, int N, int* out) {
  return ssd::switch_dims<ssd::TcGrid>(hp, N, Bt, nc, H, out);
}
