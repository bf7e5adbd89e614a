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
//
// The backward, entry point `ssd_chunk_bwd` (the TPU kernel has none: JAX
// differentiates the reference's einsums).  Per (batch, chunk, head h of group
// g), with u_j = x_j dt_j, L_ij = exp(cum_i - cum_j) (i >= j), s_ij = C_i.B_j,
// P_ij = s_ij L_ij, w_j = exp(cum_{Q-1} - cum_j), and dy, dS (N,hp), dcum given:
//   du_j   = sum_{i>=j} P_ij dy_i + w_j (B_j dS)     dx_j = du_j dt_j
//   dP_ij  = <dy_i, u_j>,  ds_ij = dP_ij L_ij
//   dC_i   = sum_j ds_ij B_j,  dB_j = sum_i ds_ij C_i + w_j (dS u_j)   (and over
//            the heads of the group)
//   dcum_i += sum_j dP_ij P_ij - sum_k dP_ki P_ki, and the states' decay
//            w_j <B_j, dS u_j> moves from dcum_j to dcum_{Q-1}
//   ddt_k  = <du_k, x_k> + a sum_{i>=k} dcum_i,  da = sum dcum_i cumsum(dt)_i
// What bounds it: bytes, with operations close behind.  At mamba2-1.3b's shape
// (B 4, nc 16, Q 256, 64 heads of 64, N 128, bf16) the causal half of the five
// Q x Q products (s = C B^T once a group, the other four a head) and the two
// states products are 0.138 TFLOP, 0.140 ms at the bf16 tensor-core rate,
// against 0.566 GB of inputs and outputs, 0.169 ms.
// Three device kernels, in a fixed order and with no atomics, so that every
// sum is the same from run to run:
//   1. one block per (batch, chunk, head): everything of one head, in two
//      walks over the causal tile pairs, as flash's backward splits dk/dv from
//      dq.  Walk 1 holds a column tile j (B_j, x_j) and streams the row tiles
//      i >= j (C_i, dy_i): s, P, dP, ds recomputed from the inputs (nothing
//      the forward wrote is read), du_j += P^T dy_i, dB_j += ds^T C_i, the
//      column sums of dP P in registers, its row sums over the warps through
//      shared memory; at the end of each column tile the states' terms (dS
//      read once a block), dx_j, the direct part of ddt_j.  Walk 2 holds a row
//      tile i (C_i, dy_i) and streams j <= i (B_j, x_j): dP, ds again and
//      dC_i += ds B_j.  Then one warp turns the sums into dcum, scans it from
//      the end into ddt and sums this head's share of da.  dB and dC of the
//      head go to fp32 partials (B·nc·H, Q, N), da's to (B·nc·H).
//   2. bwd_reduce_kernel sums the partials of a group's heads in head order
//      into db, dc (b's dtype); 3. bwd_da_kernel sums da over batch and chunks
//      in order.  At mamba2's shape the partials are 1.07 GB of fp32, written
//      once and read once.
//   Distance from the bound at mamba2's shape (chip_smoke.py on an NVIDIA H100
//   80GB HBM3 at a 700 W power limit): 2.64 ms against 0.169 ms, 6.4 %, with
//   2 blocks of 128 threads an SM (219 registers at hp 64, N 128); the
//   backward it replaced re-ran the plain forward (9.3 ms) and took autograd
//   of it (17.7 ms).  Not measured:
//   how the time splits between the walks, the partials and the sums.
// * bf16 -> ssd_chunk_bwd_tc_kernel: 4 warps, 16 rows of the held tile each,
//   every product an `mma.sync.m16n8k16` of bf16 operands into fp32: s =
//   B_j C_i^T and dP = x_j dy_i^T (times dt_j in fp32), P and ds rounded to
//   bf16 once before du += P^T dy_i and dB += ds^T C_i (walk 1) and dC += ds B_j
//   (walk 2); dS rounded to bf16 in shared memory, w_j B_j and w_j dt_j x_j
//   rounded once before they meet it.  exp only where i >= j.  Held and
//   streamed tiles through the same two-stage cp.async ring as the forward.
// * fp32 -> ssd_chunk_bwd_kernel: the same walks with IEEE fp32 FMAs from
//   fp32 shared tiles, for the 5e-5 parity of fp32 gradients.
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

// ---- the backward ---------------------------------------------------------------

struct BwdArgs {
  const void* x;
  const float* dt;
  const void* b;
  const void* c;
  const float* a;
  const void* dy;
  const float* ds;  // dstates (batch, chunk, head, n, p), any strides
  const float* dcum;
  void* dx;
  float* ddt;
  float* pdb;  // partials of dB and dC: (batch, chunk, head, Q, N) fp32, contiguous
  float* pdc;
  float* pda;  // (batch, chunk, head)
  // strides in elements: x, dt, dy, dcum, dx, ddt over (batch, chunk, row,
  // head); b, c over (batch, chunk, row, group); ds over (batch, chunk, head,
  // n, p)
  int64_t sx[4], sd[4], sb[4], sc[4], sy[4], sS[5], sk[4], sdx[4], sdd[4];
  int64_t sa;
  int Q, rep;
};

// The block's vectors over the chunk's rows, in shared memory after its tiles.
struct BwdVecs {
  float *dt, *cs, *cum, *w, *row, *col, *ddt, *dw;
  __device__ explicit BwdVecs(float* base)
      : dt(base), cs(base + QMAX), cum(base + 2 * QMAX), w(base + 3 * QMAX),
        row(base + 4 * QMAX), col(base + 5 * QMAX), ddt(base + 6 * QMAX),
        dw(base + 7 * QMAX) {}
};
constexpr int BWD_VEC_FLOATS = 8 * QMAX;

// dt of the head's chunk, its prefix sums cs and cum = cs a (one warp, as the
// forward computes them: the same values), w = exp(cum_{Q-1} - cum); row and
// col zeroed.  Padded rows have dt = 0.
template <int NTH>
__device__ void bwd_prologue(const BwdArgs& p, const float* dtp, float a, int Q, int QP,
                             const BwdVecs& v) {
  for (int r = threadIdx.x; r < QP; r += NTH) {
    v.dt[r] = r < Q ? dtp[(int64_t)r * p.sd[2]] : 0.f;
    v.row[r] = 0.f;
    v.col[r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int E = QP / 32;
    float tot = 0.f;
    for (int e = 0; e < E; ++e) tot += v.dt[lane * E + e];
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.f;
    for (int e = 0; e < E; ++e) {
      run += v.dt[lane * E + e];
      v.cs[lane * E + e] = run;
      v.cum[lane * E + e] = run * a;
    }
  }
  __syncthreads();
  const float cum_q = v.cum[Q - 1];
  for (int r = threadIdx.x; r < QP; r += NTH) v.w[r] = expf(cum_q - v.cum[r]);
}

// Warp 0, after a barrier: dcum_k = dcum_in_k + row_k - col_k - dw_k (+ sum_j
// dw_j at k = Q-1), then ddt_k = ddt_direct_k + a sum_{m>=k} dcum_m (a scan from
// the end: each lane a run of rows, the lanes' totals by shuffles) and this
// head's share of da, sum_k dcum_k cs_k.  Every sum in a fixed order.
__device__ void bwd_final(const BwdArgs& p, const float* dcp, float* ddtp, float* pda, float a,
                          int Q, int QP, const BwdVecs& v) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int E = QP / 32;
  float tw = 0.f;
  for (int e = 0; e < E; ++e) tw += v.dw[lane * E + e];
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) tw += __shfl_xor_sync(0xffffffffu, tw, s);
  float tot = 0.f;
  for (int e = 0; e < E; ++e) {
    const int k = lane * E + e;
    float d = 0.f;
    if (k < Q) {
      d = dcp[(int64_t)k * p.sk[2]] + v.row[k] - v.col[k] - v.dw[k];
      if (k == Q - 1) d += tw;
    }
    v.row[k] = d;  // dcum, in place
    tot += d;
  }
  float incl = tot;  // suffix sums of the lanes' totals
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, s);
    if (lane + s < 32) incl += o;
  }
  float run = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) run = 0.f;
  float da = 0.f;
  for (int e = E - 1; e >= 0; --e) {
    const int k = lane * E + e;
    run += v.row[k];
    da = fmaf(v.row[k], v.cs[k], da);
    if (k < Q) ddtp[(int64_t)k * p.sdd[2]] = v.ddt[k] + a * run;
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) da += __shfl_xor_sync(0xffffffffu, da, s);
  if (lane == 0) *pda = da;
}

// ---- backward, fp32: IEEE FMAs ----------------------------------------------------
// 256 threads; thread (r, cg) = (tid / 4, tid % 4) owns row r of the held tile
// and the columns cg, cg + 4, ... of every product; fp32 tiles in shared
// memory, rows padded by one float.

template <int HP, int N>
struct Fb {
  static constexpr int LN = N + 1, LX = HP + 1, LT = BT + 1;
  // held and streamed N- and hp-tiles, dS (N x hp), P, ds and dP P tiles
  static constexpr size_t FLOATS =
      2 * BT * LN + 2 * BT * LX + N * LX + 3 * BT * LT + BWD_VEC_FLOATS;
};

// Rows [r0, r0 + BT) of a (Q, D) fp32 matrix into a tile with row stride LD;
// rows past Q are zeros.
template <int D, int LD>
__device__ __forceinline__ void rows_f32(float* dst, const float* src, int64_t stride, int r0,
                                         int Q) {
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, col = idx % D;
    dst[r * LD + col] = r0 + r < Q ? src[(int64_t)(r0 + r) * stride + col] : 0.f;
  }
}

// grid (nc, H, batch); one block per chunk of one head.
template <int HP, int N>
__global__ void __launch_bounds__(NT) ssd_chunk_bwd_kernel(BwdArgs p) {
  using F = Fb<HP, N>;
  constexpr int LN = F::LN, LX = F::LX, LT = F::LT;
  constexpr int CN = N / 4, CX = HP / 4;  // columns of a thread in N- and hp-wide results
  const int Q = p.Q;
  const int nt = (Q + BT - 1) / BT, QP = nt * BT;
  const int c = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / p.rep;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;

  extern __shared__ float4 smem_f4[];
  float* sHN = reinterpret_cast<float*>(smem_f4);  // held N-tile
  float* sHX = sHN + BT * LN;                      // held hp-tile
  float* sSN = sHX + BT * LX;                      // streamed N-tile
  float* sSX = sSN + BT * LN;                      // streamed hp-tile
  float* sDS = sSX + BT * LX;                      // dS [N][LX]
  float* sP = sDS + N * LX;                        // [BT][LT] each
  float* sD = sP + BT * LT;
  float* sG = sD + BT * LT;
  const BwdVecs v(sG + BT * LT);

  const float* xp = (const float*)p.x + bb * p.sx[0] + c * p.sx[1] + h * p.sx[3];
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const float* bp = (const float*)p.b + bb * p.sb[0] + c * p.sb[1] + g * p.sb[3];
  const float* cp = (const float*)p.c + bb * p.sc[0] + c * p.sc[1] + g * p.sc[3];
  const float* yp = (const float*)p.dy + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
  const float* Sp = p.ds + bb * p.sS[0] + c * p.sS[1] + h * p.sS[2];
  const float* dcp = p.dcum + bb * p.sk[0] + c * p.sk[1] + h * p.sk[3];
  float* dxp = (float*)p.dx + bb * p.sdx[0] + c * p.sdx[1] + h * p.sdx[3];
  float* ddtp = p.ddt + bb * p.sdd[0] + c * p.sdd[1] + h * p.sdd[3];
  const int64_t blk = ((int64_t)bb * gridDim.x + c) * gridDim.y + h;
  float* pdb = p.pdb + blk * Q * N;
  float* pdc = p.pdc + blk * Q * N;
  const float a = p.a[h * p.sa];

  for (int idx = threadIdx.x; idx < N * HP; idx += NT) {
    const int n = idx / HP, q = idx % HP;
    sDS[n * LX + q] = Sp[n * p.sS[3] + q * p.sS[4]];
  }
  bwd_prologue<NT>(p, dtp, a, Q, QP, v);

  // walk 1: held column tile j (B_j, x_j), streamed row tiles i >= j (C_i, dy_i)
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * BT, gj = j0 + r;
    __syncthreads();
    rows_f32<N, LN>(sHN, bp, p.sb[2], j0, Q);
    rows_f32<HP, LX>(sHX, xp, p.sx[2], j0, Q);
    float du[CX], db[CN];
#pragma unroll
    for (int k = 0; k < CX; ++k) du[k] = 0.f;
#pragma unroll
    for (int k = 0; k < CN; ++k) db[k] = 0.f;
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();
      rows_f32<N, LN>(sSN, cp, p.sc[2], i0, Q);
      rows_f32<HP, LX>(sSX, yp, p.sy[2], i0, Q);
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < BT / 4; ++k) {
        const int il = cg + 4 * k, gi = i0 + il;
        float P = 0.f, ds = 0.f, seg = 0.f;
        if (gi >= gj) {
          float s = 0.f, d = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) s = fmaf(sHN[r * LN + n], sSN[il * LN + n], s);
#pragma unroll 4
          for (int q = 0; q < HP; ++q) d = fmaf(sHX[r * LX + q], sSX[il * LX + q], d);
          d *= v.dt[gj];
          const float L = expf(v.cum[gi] - v.cum[gj]);
          P = s * L;
          ds = d * L;
          seg = d * P;
        }
        sP[r * LT + il] = P;
        sD[r * LT + il] = ds;
        sG[r * LT + il] = seg;
      }
      __syncthreads();
      // the sums of dP P: over the tile's rows j into row i, over its columns i into j
      if (threadIdx.x < BT) {
        float s = 0.f;
#pragma unroll 4
        for (int jl = 0; jl < BT; ++jl) s += sG[jl * LT + threadIdx.x];
        v.row[i0 + threadIdx.x] += s;
      } else if (threadIdx.x < 2 * BT) {
        const int jl = threadIdx.x - BT;
        float s = 0.f;
#pragma unroll 4
        for (int il = 0; il < BT; ++il) s += sG[jl * LT + il];
        v.col[j0 + jl] += s;
      }
      // du_j += P^T dy_i, dB_j += ds^T C_i
#pragma unroll
      for (int k = 0; k < CX; ++k) {
        const int q = cg + 4 * k;
#pragma unroll 4
        for (int il = 0; il < BT; ++il) du[k] = fmaf(sP[r * LT + il], sSX[il * LX + q], du[k]);
      }
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        const int n = cg + 4 * k;
#pragma unroll 4
        for (int il = 0; il < BT; ++il) db[k] = fmaf(sD[r * LT + il], sSN[il * LN + n], db[k]);
      }
    }
    // the states' terms of row j: q = w_j (B_j dS), du += q, dw = <q, u_j>;
    // dB_j += w_j (dS u_j); then dx_j, the direct part of ddt_j, dB_j's partial
    const float wj = v.w[gj], dtj = v.dt[gj];
    float dw = 0.f, dd = 0.f;
#pragma unroll
    for (int k = 0; k < CX; ++k) {
      const int q = cg + 4 * k;
      float s = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) s = fmaf(sHN[r * LN + n], sDS[n * LX + q], s);
      s *= wj;
      const float xv = sHX[r * LX + q];
      dw = fmaf(s, xv, dw);
      du[k] += s;
      dd = fmaf(du[k], xv, dd);
    }
    dw = fa::quad_sum(dw) * dtj;
    dd = fa::quad_sum(dd);
    if (cg == 0) {
      v.dw[gj] = dw;
      v.ddt[gj] = dd;
    }
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      const int n = cg + 4 * k;
      float s = 0.f;
#pragma unroll 4
      for (int q = 0; q < HP; ++q) s = fmaf(sHX[r * LX + q], sDS[n * LX + q], s);
      db[k] = fmaf(s, wj * dtj, db[k]);
    }
    if (gj < Q) {
#pragma unroll
      for (int k = 0; k < CX; ++k) dxp[(int64_t)gj * p.sdx[2] + cg + 4 * k] = du[k] * dtj;
#pragma unroll
      for (int k = 0; k < CN; ++k) pdb[(int64_t)gj * N + cg + 4 * k] = db[k];
    }
  }

  // walk 2: held row tile i (C_i, dy_i), streamed column tiles j <= i (B_j, x_j)
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * BT, gi = i0 + r;
    __syncthreads();
    rows_f32<N, LN>(sHN, cp, p.sc[2], i0, Q);
    rows_f32<HP, LX>(sHX, yp, p.sy[2], i0, Q);
    float dc[CN];
#pragma unroll
    for (int k = 0; k < CN; ++k) dc[k] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();
      rows_f32<N, LN>(sSN, bp, p.sb[2], j0, Q);
      rows_f32<HP, LX>(sSX, xp, p.sx[2], j0, Q);
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < BT / 4; ++k) {
        const int jl = cg + 4 * k, gj = j0 + jl;
        float ds = 0.f;
        if (gi >= gj) {
          float d = 0.f;
#pragma unroll 4
          for (int q = 0; q < HP; ++q) d = fmaf(sHX[r * LX + q], sSX[jl * LX + q], d);
          ds = d * v.dt[gj] * expf(v.cum[gi] - v.cum[gj]);
        }
        sD[r * LT + jl] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        const int n = cg + 4 * k;
#pragma unroll 4
        for (int jl = 0; jl < BT; ++jl) dc[k] = fmaf(sD[r * LT + jl], sSN[jl * LN + n], dc[k]);
      }
    }
    if (gi < Q) {
#pragma unroll
      for (int k = 0; k < CN; ++k) pdc[(int64_t)gi * N + cg + 4 * k] = dc[k];
    }
  }
  __syncthreads();
  bwd_final(p, dcp, ddtp, p.pda + blk, a, Q, QP, v);
}

template <int HP, int N>
struct FmaB {
  static int run(const BwdArgs& args, int Bt, int nc, int H, cudaStream_t stream) {
    const size_t smem = sizeof(float) * Fb<HP, N>::FLOATS;
    auto kernel = ssd_chunk_bwd_kernel<HP, N>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nc, H, Bt), NT, smem, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

// ---- backward, bf16 on the tensor cores ---------------------------------------------

template <int HP, int N>
struct TcB {
  static constexpr int NTH = 128;  // 4 warps, 16 rows of the held tile each
  static constexpr int LDN = N + 8, LDX = HP + 8;
  // held N- and hp-tiles, two stages of streamed N- and hp-tiles, dS [N][LDX];
  // the warps' row sums of dP P [4][BT], the vectors
  static constexpr size_t SMEM = sizeof(bf16) * (3 * BT * LDN + 3 * BT * LDX + N * LDX) +
                                 sizeof(float) * (4 * BT + BWD_VEC_FLOATS);
};

// The A fragment's rows g (a0, a2) and g + 8 (a1, a3) times f0 and f8 in fp32,
// rounded back to bf16.
__device__ __forceinline__ void scale_rows(uint32_t (&af)[4], float f0, float f8) {
  af[0] = scale_pair(af[0], f0, f0);
  af[1] = scale_pair(af[1], f8, f8);
  af[2] = scale_pair(af[2], f0, f0);
  af[3] = scale_pair(af[3], f8, f8);
}

// The row sums of dP P of the last pair of walk 1 (sRed: [warp][column]), over
// the warps in order, into row tile `tile` of v.row.
__device__ __forceinline__ void add_row_sums(const float* sRed, int tile, const BwdVecs& v) {
  const int i = threadIdx.x;
  if (i < BT)
    v.row[tile * BT + i] += ((sRed[i] + sRed[BT + i]) + sRed[2 * BT + i]) + sRed[3 * BT + i];
}

// grid (nc, H, batch); one block per chunk of one head.
template <int HP, int N>
__global__ void __launch_bounds__(TcB<HP, N>::NTH, 2) ssd_chunk_bwd_tc_kernel(BwdArgs p) {
  using C = TcB<HP, N>;
  constexpr int NTH = C::NTH, LDN = C::LDN, LDX = C::LDX;
  constexpr int NX = HP / 8, NN = N / 8;  // 8-wide column tiles of hp- and N-wide results
  const int Q = p.Q;
  const int nt = (Q + BT - 1) / BT, QP = nt * BT;
  const int c = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / p.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int l0 = warp * 16 + gq;  // the thread's rows l0, l0 + 8 of the held tile

  extern __shared__ float4 smem_f4[];
  bf16* sHN = reinterpret_cast<bf16*>(smem_f4);  // held N-tile [BT][LDN]
  bf16* sHX = sHN + BT * LDN;                    // held hp-tile [BT][LDX]
  bf16* sRN = sHX + BT * LDX;                    // streamed N-tiles [2][BT][LDN]
  bf16* sRX = sRN + 2 * BT * LDN;                // streamed hp-tiles [2][BT][LDX]
  bf16* sDS = sRX + 2 * BT * LDX;                // dS [N][LDX]
  float* sRed = reinterpret_cast<float*>(sDS + N * LDX);  // [4][BT]
  const BwdVecs v(sRed + 4 * BT);

  const bf16* xp = (const bf16*)p.x + bb * p.sx[0] + c * p.sx[1] + h * p.sx[3];
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const bf16* bp = (const bf16*)p.b + bb * p.sb[0] + c * p.sb[1] + g * p.sb[3];
  const bf16* cp = (const bf16*)p.c + bb * p.sc[0] + c * p.sc[1] + g * p.sc[3];
  const bf16* yp = (const bf16*)p.dy + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
  const float* Sp = p.ds + bb * p.sS[0] + c * p.sS[1] + h * p.sS[2];
  const float* dcp = p.dcum + bb * p.sk[0] + c * p.sk[1] + h * p.sk[3];
  bf16* dxp = (bf16*)p.dx + bb * p.sdx[0] + c * p.sdx[1] + h * p.sdx[3];
  float* ddtp = p.ddt + bb * p.sdd[0] + c * p.sdd[1] + h * p.sdd[3];
  const int64_t blk = ((int64_t)bb * gridDim.x + c) * gridDim.y + h;
  float* pdb = p.pdb + blk * Q * N;
  float* pdc = p.pdc + blk * Q * N;
  const float a = p.a[h * p.sa];

  // rows [r0, r0 + BT) of an N-wide and an hp-wide input into two tiles
  auto load_pair = [&](bf16* dn, bf16* dx_, const bf16* srcn, int64_t strn, const bf16* srcx,
                       int64_t strx, int r0) {
    cp_rows<N, LDN, NTH>(dn, srcn, strn, r0, Q);
    cp_rows<HP, LDX, NTH>(dx_, srcx, strx, r0, Q);
  };

  // dS in bf16, read along whichever of its two last dims is contiguous
  const bool n_inner = p.sS[3] == 1 && p.sS[4] != 1;
  for (int idx = threadIdx.x; idx < N * HP; idx += NTH) {
    const int n = n_inner ? idx % N : idx / HP, q = n_inner ? idx / N : idx % HP;
    sDS[n * LDX + q] = __float2bfloat16(Sp[n * p.sS[3] + q * p.sS[4]]);
  }
  bwd_prologue<NTH>(p, dtp, a, Q, QP, v);

  const int npairs = nt * (nt + 1) / 2;
  float accN[NN][4];  // dB_j in walk 1, dC_i in walk 2
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accN[n][e] = 0.f;

  // ---- walk 1: held column tile jt (B_j, x_j), streamed row tiles it >= jt (C_i, dy_i)
  {
    float du[NX][4];
#pragma unroll
    for (int n = 0; n < NX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) du[n][e] = 0.f;
    float colsum[2] = {0.f, 0.f};
    load_pair(sRN, sRX, cp, p.sc[2], yp, p.sy[2], 0);
    fa::cp_async_commit();
    int jt = 0, it = 0;
    for (int q = 0; q < npairs; ++q) {
      const int stage = q & 1;
      // the held tiles are free: the previous step ended with a barrier
      if (it == jt) load_pair(sHN, sHX, bp, p.sb[2], xp, p.sx[2], jt * BT);
      fa::cp_async_commit();
      const int next_jt = it + 1 < nt ? jt : jt + 1, next_it = it + 1 < nt ? it + 1 : jt + 1;
      if (q + 1 < npairs)
        load_pair(sRN + (stage ^ 1) * BT * LDN, sRX + (stage ^ 1) * BT * LDX, cp, p.sc[2], yp,
                  p.sy[2], next_it * BT);
      fa::cp_async_commit();
      if (q > 0) add_row_sums(sRed, jt == it ? nt - 1 : it - 1, v);  // the previous pair's
      fa::cp_async_wait<1>();  // all but the newest group: the held tiles, C_i, dy_i are in
      __syncthreads();
      const bf16* sC_ = sRN + stage * BT * LDN;
      const bf16* sY_ = sRX + stage * BT * LDX;
      const int i0 = it * BT, j0 = jt * BT;
      const bool diag = it == jt;
      // on the diagonal tile the warp's rows 16 w .. 16 w + 15 see the columns
      // i >= 16 w: 8-column tiles from 2 w on
      const int nlo = diag ? 2 * warp : 0;
      const float cj[2] = {v.cum[j0 + l0], v.cum[j0 + l0 + 8]};
      const float dtj[2] = {v.dt[j0 + l0], v.dt[j0 + l0 + 8]};

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = 4 * half;  // first 8-column tile of the half (32 columns i)
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        if (n0 + 4 > nlo) {
          // s = B_j C_i^T and dP / dt_j = x_j dy_i^T, 16 rows j x 32 columns i a warp
#pragma unroll
          for (int k0 = 0; k0 < N; k0 += 16) {
            uint32_t af[4];
            fa::ldsm_x4(af, fa::a_addr(sHN + warp * 16 * LDN, LDN, k0, lane));
#pragma unroll
            for (int n = 0; n < 4; n += 2) {
              if (n0 + n >= nlo) {
                uint32_t bf[4];
                fa::ldsm_x4(bf, fa::bt_addr(sC_, LDN, (n0 + n) * 8, k0, lane));
                fa::mma_bf16(s[n], af, bf[0], bf[1]);
                fa::mma_bf16(s[n + 1], af, bf[2], bf[3]);
              }
            }
          }
#pragma unroll
          for (int k0 = 0; k0 < HP; k0 += 16) {
            uint32_t af[4];
            fa::ldsm_x4(af, fa::a_addr(sHX + warp * 16 * LDX, LDX, k0, lane));
#pragma unroll
            for (int n = 0; n < 4; n += 2) {
              if (n0 + n >= nlo) {
                uint32_t bf[4];
                fa::ldsm_x4(bf, fa::bt_addr(sY_, LDX, (n0 + n) * 8, k0, lane));
                fa::mma_bf16(dp[n], af, bf[0], bf[1]);
                fa::mma_bf16(dp[n + 1], af, bf[2], bf[3]);
              }
            }
          }
        }
        // P = s L, ds = dP L and dP P for i >= j; the row sums of dP P over the
        // warp's 16 rows by shuffles, one value a column into sRed
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float red[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int li = 8 * (n0 + n) + 2 * t + (e & 1);
            float P = 0.f, ds = 0.f, seg = 0.f;
            if (n0 + n >= nlo && (!diag || li >= l0 + 8 * rr)) {
              const float L = exp2f((v.cum[i0 + li] - cj[rr]) * fa::LOG2E);
              const float d = dp[n][e] * dtj[rr];
              P = s[n][e] * L;
              ds = d * L;
              seg = d * P;
            }
            s[n][e] = P;
            dp[n][e] = ds;
            colsum[rr] += seg;
            red[e & 1] += seg;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            red[k] += __shfl_xor_sync(0xffffffffu, red[k], 4);
            red[k] += __shfl_xor_sync(0xffffffffu, red[k], 8);
            red[k] += __shfl_xor_sync(0xffffffffu, red[k], 16);
          }
          if (gq == 0) {
            sRed[warp * BT + 8 * (n0 + n) + 2 * t] = red[0];
            sRed[warp * BT + 8 * (n0 + n) + 2 * t + 1] = red[1];
          }
        }
        // du_j += P^T dy_i and dB_j += ds^T C_i: P and ds rounded to bf16 in the A operand
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int kk = 2 * half + kh;  // 16-column step over i
          if (2 * kk >= nlo) {
            uint32_t af[4];
            fa::c_to_a(af, s[2 * kh], s[2 * kh + 1]);
#pragma unroll
            for (int n = 0; n < NX; n += 2) {
              uint32_t bx[4];
              fa::ldsm_x4_t(bx, fa::b_addr(sY_, LDX, n * 8, kk * 16, lane));
              fa::mma_bf16(du[n], af, bx[0], bx[1]);
              fa::mma_bf16(du[n + 1], af, bx[2], bx[3]);
            }
            fa::c_to_a(af, dp[2 * kh], dp[2 * kh + 1]);
#pragma unroll
            for (int n = 0; n < NN; n += 2) {
              uint32_t bc[4];
              fa::ldsm_x4_t(bc, fa::b_addr(sC_, LDN, n * 8, kk * 16, lane));
              fa::mma_bf16(accN[n], af, bc[0], bc[1]);
              fa::mma_bf16(accN[n + 1], af, bc[2], bc[3]);
            }
          }
        }
      }

      if (it + 1 == nt) {  // column tile jt is complete: the states' terms, then its outputs
        const float wj[2] = {v.w[j0 + l0], v.w[j0 + l0 + 8]};
        // q = (w_j B_j) dS, w_j B_j rounded to bf16; du += q; dw = dt_j <q, x_j>
        float qv[NX][4];
#pragma unroll
        for (int n = 0; n < NX; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) qv[n][e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < N; k0 += 16) {
          uint32_t af[4];
          fa::ldsm_x4(af, fa::a_addr(sHN + warp * 16 * LDN, LDN, k0, lane));
          scale_rows(af, wj[0], wj[1]);
#pragma unroll
          for (int n = 0; n < NX; n += 2) {
            uint32_t bd[4];
            fa::ldsm_x4_t(bd, fa::b_addr(sDS, LDX, n * 8, k0, lane));
            fa::mma_bf16(qv[n], af, bd[0], bd[1]);
            fa::mma_bf16(qv[n + 1], af, bd[2], bd[3]);
          }
        }
        float dw[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NX; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const float xv =
                __bfloat162float(sHX[(l0 + 8 * rr) * LDX + 8 * n + 2 * t + (e & 1)]);
            dw[rr] = fmaf(qv[n][e], xv, dw[rr]);
            du[n][e] += qv[n][e];
            dd[rr] = fmaf(du[n][e], xv, dd[rr]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          dw[rr] = fa::quad_sum(dw[rr]) * dtj[rr];
          dd[rr] = fa::quad_sum(dd[rr]);
          colsum[rr] = fa::quad_sum(colsum[rr]);
          const int gj = j0 + l0 + 8 * rr;
          if (t == 0) {
            v.dw[gj] = dw[rr];
            v.ddt[gj] = dd[rr];
            v.col[gj] = colsum[rr];
          }
          if (gj < Q) {
            bf16* row = dxp + (int64_t)gj * p.sdx[2] + 2 * t;
#pragma unroll
            for (int n = 0; n < NX; ++n)
              *reinterpret_cast<uint32_t*>(row + 8 * n) =
                  fa::pack_bf16(du[n][2 * rr] * dtj[rr], du[n][2 * rr + 1] * dtj[rr]);
          }
          colsum[rr] = 0.f;
        }
        // dB_j += (w_j dt_j x_j) dS^T, w_j dt_j x_j rounded to bf16
#pragma unroll
        for (int k0 = 0; k0 < HP; k0 += 16) {
          uint32_t af[4];
          fa::ldsm_x4(af, fa::a_addr(sHX + warp * 16 * LDX, LDX, k0, lane));
          scale_rows(af, wj[0] * dtj[0], wj[1] * dtj[1]);
#pragma unroll
          for (int n = 0; n < NN; n += 2) {
            uint32_t bd[4];
            fa::ldsm_x4(bd, fa::bt_addr(sDS, LDX, n * 8, k0, lane));
            fa::mma_bf16(accN[n], af, bd[0], bd[1]);
            fa::mma_bf16(accN[n + 1], af, bd[2], bd[3]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int gj = j0 + l0 + 8 * rr;
          if (gj < Q) {
            float* row = pdb + (int64_t)gj * N + 2 * t;
#pragma unroll
            for (int n = 0; n < NN; ++n)
              *reinterpret_cast<float2*>(row + 8 * n) =
                  make_float2(accN[n][2 * rr], accN[n][2 * rr + 1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) accN[n][e] = 0.f;
#pragma unroll
        for (int n = 0; n < NX; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) du[n][e] = 0.f;
      }
      __syncthreads();  // everyone is done with this stage, the held tiles and sRed
      jt = next_jt;
      it = next_it;
    }
    add_row_sums(sRed, nt - 1, v);  // the last pair's: (nt - 1, nt - 1)
    fa::cp_async_wait<0>();
    __syncthreads();
  }

  // ---- walk 2: held row tile it (C_i, dy_i), streamed column tiles jt <= it (B_j, x_j)
  {
    load_pair(sRN, sRX, bp, p.sb[2], xp, p.sx[2], 0);
    fa::cp_async_commit();
    int it = 0, jt = 0;
    for (int q = 0; q < npairs; ++q) {
      const int stage = q & 1;
      if (jt == 0) load_pair(sHN, sHX, cp, p.sc[2], yp, p.sy[2], it * BT);
      fa::cp_async_commit();
      const int next_it = jt < it ? it : it + 1, next_jt = jt < it ? jt + 1 : 0;
      if (q + 1 < npairs)
        load_pair(sRN + (stage ^ 1) * BT * LDN, sRX + (stage ^ 1) * BT * LDX, bp, p.sb[2], xp,
                  p.sx[2], next_jt * BT);
      fa::cp_async_commit();
      fa::cp_async_wait<1>();
      __syncthreads();
      const bf16* sB_ = sRN + stage * BT * LDN;
      const bf16* sX_ = sRX + stage * BT * LDX;
      const int i0 = it * BT, j0 = jt * BT;
      const bool diag = it == jt;
      // on the diagonal tile the warp's rows see the columns j < 16 (w + 1)
      const int ncol = diag ? 2 * (warp + 1) : 8;
      const float ci[2] = {v.cum[i0 + l0], v.cum[i0 + l0 + 8]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = 4 * half;
        if (n0 >= ncol) break;
        // dP / dt_j = dy_i x_j^T, 16 rows i x 32 columns j a warp
        float dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < HP; k0 += 16) {
          uint32_t af[4];
          fa::ldsm_x4(af, fa::a_addr(sHX + warp * 16 * LDX, LDX, k0, lane));
#pragma unroll
          for (int n = 0; n < 4; n += 2) {
            if (n0 + n < ncol) {
              uint32_t bf[4];
              fa::ldsm_x4(bf, fa::bt_addr(sX_, LDX, (n0 + n) * 8, k0, lane));
              fa::mma_bf16(dp[n], af, bf[0], bf[1]);
              fa::mma_bf16(dp[n + 1], af, bf[2], bf[3]);
            }
          }
        }
        // ds = dP L for i >= j
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int lj = 8 * (n0 + n) + 2 * t + (e & 1);
            float ds = 0.f;
            if (n0 + n < ncol && (!diag || l0 + 8 * rr >= lj))
              ds = dp[n][e] * v.dt[j0 + lj] * exp2f((ci[rr] - v.cum[j0 + lj]) * fa::LOG2E);
            dp[n][e] = ds;
          }
        }
        // dC_i += ds B_j, ds rounded to bf16 in the A operand
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int kk = 2 * half + kh;
          if (2 * kk < ncol) {
            uint32_t af[4];
            fa::c_to_a(af, dp[2 * kh], dp[2 * kh + 1]);
#pragma unroll
            for (int n = 0; n < NN; n += 2) {
              uint32_t bq[4];
              fa::ldsm_x4_t(bq, fa::b_addr(sB_, LDN, n * 8, kk * 16, lane));
              fa::mma_bf16(accN[n], af, bq[0], bq[1]);
              fa::mma_bf16(accN[n + 1], af, bq[2], bq[3]);
            }
          }
        }
      }
      if (diag) {  // dC_i is complete
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int gi = i0 + l0 + 8 * rr;
          if (gi < Q) {
            float* row = pdc + (int64_t)gi * N + 2 * t;
#pragma unroll
            for (int n = 0; n < NN; ++n)
              *reinterpret_cast<float2*>(row + 8 * n) =
                  make_float2(accN[n][2 * rr], accN[n][2 * rr + 1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) accN[n][e] = 0.f;
      }
      __syncthreads();  // everyone is done with this stage and the held tiles
      it = next_it;
      jt = next_jt;
    }
    fa::cp_async_wait<0>();
    __syncthreads();
  }
  bwd_final(p, dcp, ddtp, p.pda + blk, a, Q, QP, v);
}

template <int HP, int N>
struct TcLaunchB {
  static int run(const BwdArgs& args, int Bt, int nc, int H, cudaStream_t stream) {
    using C = TcB<HP, N>;
    // 16-byte cp.async of x, dy, B and C rows
    const int64_t* strides[4] = {args.sx, args.sy, args.sb, args.sc};
    const void* bases[4] = {args.x, args.dy, args.b, args.c};
    for (int i = 0; i < 4; ++i) {
      if (!fa::aligned16(bases[i])) return (int)cudaErrorInvalidValue;
      for (int d = 0; d < 4; ++d)
        if (strides[i][d] % 8) return (int)cudaErrorInvalidValue;
    }
    auto kernel = ssd_chunk_bwd_tc_kernel<HP, N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nc, H, Bt), C::NTH, C::SMEM, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

template <int HP, int N>
struct TcGridB {
  static int run(int Bt, int nc, int H, int* out) {
    using C = TcB<HP, N>;
    auto kernel = ssd_chunk_bwd_tc_kernel<HP, N>;
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

// ---- backward: the sums over the heads of a group, and over batch and chunks ----

__device__ __forceinline__ void store4(float* dst, float4 s) { fa::st4(dst, s); }
__device__ __forceinline__ void store4(bf16* dst, float4 s) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(fa::pack_bf16(s.x, s.y), fa::pack_bf16(s.z, s.w));
}

// db and dc (batch, chunk, Q, G, N), contiguous: the partials of the group's
// heads summed in head order, 4 neighbouring n a thread; blockIdx.y picks db
// (0) or dc (1).
template <typename T>
__global__ void bwd_reduce_kernel(const float* __restrict__ pdb, const float* __restrict__ pdc,
                                  T* db, T* dc, int64_t rows, int Q, int G, int N, int H,
                                  int rep) {
  const int V = N / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * V) return;
  const float* part = blockIdx.y ? pdc : pdb;
  T* out = blockIdx.y ? dc : db;
  const int n = (int)(idx % V) * 4;
  const int64_t row = idx / V;  // (batch·chunk, q, g)
  const int gg = (int)(row % G);
  const int q = (int)(row / G % Q);
  const int64_t bc = row / G / Q;
  const float* src = part + ((bc * H + (int64_t)gg * rep) * Q + q) * N + n;
  float4 s = fa::ld4(src);
  for (int r = 1; r < rep; ++r) {
    const float4 u = fa::ld4(src + (int64_t)r * Q * N);
    s = make_float4(s.x + u.x, s.y + u.y, s.z + u.z, s.w + u.w);
  }
  store4(out + row * N + n, s);
}

// da[h]: the (batch, chunk) partials of head h summed in order.
__global__ void bwd_da_kernel(const float* __restrict__ pda, float* da, int64_t bcs, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int64_t k = 0; k < bcs; ++k) s += pda[k * H + h];
    da[h] = s;
  }
}

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

// The gradient of ssd_chunk.  Inputs as ssd_chunk's, and dy like y, dstates
// (Bt,nc,H,N,hp) fp32 with any strides, dcum (Bt,nc,Q,H) fp32; outputs dx like x,
// ddt (Bt,nc,Q,H) fp32, db and dc (Bt,nc,Q,G,N) like b, contiguous, da (H,)
// fp32; scratch pdb, pdc (Bt·nc·H, Q, N) and pda (Bt·nc·H) fp32.  `strides`
// holds 38 (see ssd::BwdArgs, in that order, then a's).  Three device kernels:
// the heads', the sum over each group's heads, the sum of da.  Returns
// cudaGetLastError() after each launch.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* b, const void* c,
                             const void* a, const void* dy, const void* dstates,
                             const void* dcum, void* dx, void* ddt, void* db, void* dc,
                             void* da, void* pdb, void* pdc, void* pda,
                             const long long* strides, int Bt, int nc, int Q, int H, int G,
                             int hp, int N, int is_bf16, void* stream) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t bcs = (int64_t)Bt * nc;
  if (bcs > 0) {
    ssd::BwdArgs args;
    args.x = x;
    args.dt = (const float*)dt;
    args.b = b;
    args.c = c;
    args.a = (const float*)a;
    args.dy = dy;
    args.ds = (const float*)dstates;
    args.dcum = (const float*)dcum;
    args.dx = dx;
    args.ddt = (float*)ddt;
    args.pdb = (float*)pdb;
    args.pdc = (float*)pdc;
    args.pda = (float*)pda;
    int64_t* dst[9] = {args.sx, args.sd, args.sb, args.sc, args.sy,
                       args.sS, args.sk, args.sdx, args.sdd};
    const int len[9] = {4, 4, 4, 4, 4, 5, 4, 4, 4};
    int k = 0;
    for (int t = 0; t < 9; ++t)
      for (int d = 0; d < len[t]; ++d) dst[t][d] = strides[k++];
    args.sa = strides[k];
    args.Q = Q;
    args.rep = H / G;
    // by type, not a fallback: bf16 only ever reaches the tensor-core kernel
    int err = is_bf16 ? ssd::switch_dims<ssd::TcLaunchB>(hp, N, args, Bt, nc, H, s)
                      : ssd::switch_dims<ssd::FmaB>(hp, N, args, Bt, nc, H, s);
    if (err != 0) return err;
    const int64_t rows = bcs * Q * G;
    const dim3 grid((unsigned)((rows * (N / 4) + 255) / 256), 2);
    if (is_bf16)
      ssd::bwd_reduce_kernel<ssd::bf16><<<grid, 256, 0, s>>>(
          (const float*)pdb, (const float*)pdc, (ssd::bf16*)db, (ssd::bf16*)dc, rows, Q, G, N, H,
          H / G);
    else
      ssd::bwd_reduce_kernel<float><<<grid, 256, 0, s>>>((const float*)pdb, (const float*)pdc,
                                                        (float*)db, (float*)dc, rows, Q, G, N,
                                                        H, H / G);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  ssd::bwd_da_kernel<<<1, 256, 0, s>>>((const float*)pda, (float*)da, bcs, H);
  return (int)cudaGetLastError();
}

// The bf16 backward kernel's launch geometry for these dims (out[4], see
// ssd::TcGridB).
extern "C" int ssd_chunk_bwd_grid(int Bt, int nc, int H, int hp, int N, int* out) {
  return ssd::switch_dims<ssd::TcGridB>(hp, N, Bt, nc, H, out);
}
