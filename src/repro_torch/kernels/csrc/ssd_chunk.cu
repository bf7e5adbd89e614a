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
// an SM has (227 KB).  Here the chunk is walked in 64-row tiles: for a row
// tile i only the column tiles j <= i are visited (tiles above the diagonal
// never), forming C_i B_j^T . L_ij for one 64 x 64 tile at a time and adding
// (tile) @ (x dt)_j into y_i's registers.  exp is evaluated only where
// i >= j, so no exponent is ever positive and nothing overflows.  The states
// are a sum over every column tile of the chunk.  The kernels read the
// model's (batch, chunk, row, head) layout through strides, and B/C through a
// head -> group index, so the model's tensors go in without a copy and B/C
// are not repeated per head.  Rows past Q (a ragged last tile) are zeros.
//
// * bf16 -> ssd_chunk_wg_kernel, on `wgmma` fed by TMA (hopper.cuh).  A block
//   owns (batch, chunk, group, slice of R heads, role): R consecutive heads
//   of the group (ssd_chunk.py's ssd_fwd_geometry, as the backward's: the
//   largest divisor of H / G up to 16; at mamba2's shape R = 16, 4 slices),
//   and one of nt + 1 roles: the slice's states and cum (role 0), or y of
//   one row tile t (role r: t = nt − r, the heaviest first); 1,280 blocks at
//   mamba2's shape.  The block's B tiles (B_0..B_t, or all for the states)
//   and a y block's C_t are copied once by TMA and held in shared memory for
//   all its heads, so B and C cross device memory once a slice and role, not
//   once a head.  Two warpgroups take the slice's heads alternately; each
//   streams its heads' x tiles through its own mbarrier ring of 4 (one TMA
//   box a 64-row tile, issued by the warpgroup's thread 0: no producer warp,
//   see the backward's note), and forms a head's dt, cum (a scan over the
//   warpgroup) and weights in shared memory while its next head's dt loads.
//     - y block: s_j = C_t B_j^T (m64n64, contraction N, both operands from
//       shared memory) for j <= t, formed once for the slice's heads and held
//       in fp32 registers (four tiles, 128 a thread).  Per head and j,
//       att = s_j · exp(cum_i − cum_j) · dt_j in fp32 registers: below the
//       diagonal as exp(cum_i − cum_e) · (exp(cum_e − cum_j) · dt_j), e the
//       last row of tile j (both exponents <= 0; one exponent a row and one a
//       column instead of one an entry), on it one exponent an entry with the
//       pairs i < j at -inf; att rounded to bf16 once into the register A
//       operand (`fa::c_to_a`) of y += att·x_j, x_j read MN-major, so x stays
//       exact bf16 (dt sits in att).  y is rounded to bf16 once at the end.
//     - states block: states += (B_j w)^T x_j, w_r = exp(cum_{Q-1} − cum_r)
//       · dt_r: B_j^T read as the register A operand by ldmatrix.trans from
//       the swizzled tile, each bf16 pair times its rows' w in fp32 and
//       rounded once; 64-row tiles of n (N = 128: two m64 products a step),
//       x_j MN-major; fp32 out.  And cum, fp32.
//   Every head's dt (16-byte loads along the heads where they are
//   contiguous), cum and weights are formed once at the block's start.
//   The roundings are those of the mma.sync kernel it replaced (PERF.md row 6;
//   docs/torch_port.md).  Registers (ptxas): 201–234, no spill, no product
//   serialized (five warpgroup.arrive that ptxas injects, C7519); shared
//   memory 199,752 bytes at hp 64, N 128, one block an SM.
//   Distance from the bound at mamba2's shape (chip_smoke.py, NVIDIA H100
//   80GB HBM3 at a 700 W power limit): 0.33 ms of kernel against 0.125 ms,
//   38 % (the mma.sync kernel: 0.68 ms).  What is left, from a clock64 count
//   (scripts/ssd_phases.py): a y block's barrier and refill after each tile
//   (28–30 %) and its elementwise att (22 %); each block's start, every head's
//   vectors (a quarter of a y block); the states blocks, twice a y block's
//   work, in the tail.  The TMA maps need x, B and C to start on 16-byte
//   boundaries with every row stride a multiple of 8 elements (the wrapper
//   checks it).
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
// Every sum in a fixed order and with no float atomics, so that the gradients
// are the same from run to run.
// * bf16 -> ssd_chunk_bwd_wg_kernel, then three small kernels.  A block owns
//   (batch, chunk, group, slice of R heads, row tile t): R consecutive heads of
//   the group (ssd_chunk.py's ssd_bwd_geometry: the largest divisor of H / G
//   up to 16; at mamba2's shape R = 16, 4 slices, 1,024 blocks) and the 64 rows
//   of tile t, as a column tile (walk 1: du_t, dx_t, dB_t, the sums of dP P,
//   over the row tiles i >= t) and as a row tile (walk 2: dC_t, over the
//   column tiles j <= t): nt + 1 tile pairs a head in every block, so the
//   blocks are even, and the 7.76 waves of one block an SM end in a tail of
//   0.76 wave (no persistent grid: 16 heads a block already leave few blocks).
//   The block's B_0..B_t and C_t..C_{nt-1} are copied once and held in shared
//   memory for all its heads.  Two warpgroups take the heads alternately and
//   sum dB_t and dC_t over theirs in fp32 registers, then warpgroup 0's plus
//   warpgroup 1's through shared memory: one (Q, N) partial of dB and one of
//   dC a slice cross device memory (with the heads' vectors 96.5 MB of scratch
//   at mamba2's shape, from 1.07 GB of per-head partials).  Every product is a
//   `wgmma` m64nNk16 of one warpgroup (64 rows): s^T = B_t C_i^T and
//   dP^T = x_t dy_i^T from shared memory; P and ds packed from the accumulators
//   into the register A operand of du += P^T dy_i and dB += ds^T C_i, and of
//   dC += ds B_j in walk 2; the states' terms q = (w B_t) dS and
//   dB += (w dt x_t) dS^T with A from registers, dS put into shared memory in
//   bf16 once a head.  Tiles are swizzled (hopper.cuh) and copied by TMA, one
//   box a 64-row sub-tile, into mbarrier rings of two held and two streamed
//   tiles a warpgroup; thread 0 of the warpgroup issues each copy two tiles
//   ahead.  No producer warp: with one (320 or 384 threads, setmaxnreg 232 or
//   not) ptxas compiled the warpgroups for 168 registers, spilled and
//   serialized the products (C7512); at 256 threads they take 254.  dt and
//   cum of each head are kept from walk 1 for walk 2.  On the diagonal tile
//   the exponent of a pair i < j is replaced by -inf before exp2 (L = 0, as
//   the plain version's where), so no positive exponent is ever evaluated.
//   Roundings: P, ds, w B_t, w dt x_t and dS to bf16 before their products,
//   as the mma.sync backward kernel did (docs/torch_port.md).  s = B_t C_i^T
//   is still formed once a head: its fp32 tiles, held for the heads, would
//   need 64 KB more than the 216 KB a block has.  Then bwd_reduce_kernel sums
//   the slices in order into db, dc (b's dtype); bwd_final_kernel turns each
//   head's row and column sums into dcum, scans it into ddt and sums the
//   head's share of da; bwd_da_kernel sums da over batch and chunks.
//   Distance from the bound at mamba2's shape (chip_smoke.py, NVIDIA H100
//   80GB HBM3 at a 700 W power limit): 1.04 ms a call against 0.169 ms, 16 %;
//   the main kernel 0.73, the slices' sum 0.022, the heads' last step 0.038,
//   da 0.004, the rest the wrapper's host time.  The mma.sync kernel it
//   replaced (one block a head, its partials 1.07 GB): 2.65 ms, 6.4 % (its
//   kernel 1.76 ms, the heads' sum 0.35).  What is left, from a clock64 count
//   of the warpgroups' phases (scripts/ssd_bwd_phases.py): waits on the
//   products 28 %, the elementwise passes 20 %, the states' terms 16 %, each
//   head's start 16 % (its dS load 7 %); two warpgroups an SM hide little
//   latency.
// * fp32 -> ssd_chunk_bwd_kernel: one block per (batch, chunk, head), the same
//   walks with IEEE fp32 FMAs from fp32 shared tiles, for the 5e-5 parity of
//   fp32 gradients; dB and dC of each head go to fp32 partials (B·nc·H, Q, N)
//   that bwd_reduce_kernel sums in head order, then bwd_da_kernel.
#include "flash_common.cuh"
#include "flash_wg.cuh"

namespace ssd {

using fa::bf16;
using fa::NT;                 // 256 threads: 16 (ty) x 16 (tx)
constexpr int BT = 64;        // rows of a tile (row and column tiles alike)
static_assert(BT == hop::TMA_ROWS, "a TMA box fills one row tile");
constexpr int LDA = BT + 16;  // row stride of the score tile (as flash's sP)
constexpr int QMAX = 256;
// heads of a slice at most (SLICE_HEADS in ssd_chunk.py): the bf16 kernels'
// blocks each take a slice of a group's heads
constexpr int SLICE_HEADS = 16;

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

// ---- bf16: two warpgroups on wgmma, fed by TMA (the forward here, the
// backward below) ------------------------------------------------------------------

// A pair of bf16 times (lo, hi) in fp32, rounded back to a pair of bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return fa::pack_bf16(f.x * lo, f.y * hi);
}

// Rows [64 tile, 64 tile + 64) of head (or group) hg of a D-wide input into
// a canonical tile at dst: a box a sub-tile.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, const int* ord,
                                         int tile, int hg, int c, int bb, uint64_t* bar) {
  const int logical[4] = {tile * BT, hg, c, bb};
  const int c1 = logical[ord[0]], c2 = logical[ord[1]], c3 = logical[ord[2]],
            c4 = logical[ord[3]];
  constexpr int C = hop::Sw<D>::C;
#pragma unroll
  for (int s = 0; s < D / C; ++s)
    hop::tma_load(dst + s * BT * C, map, bar, s * C, c1, c2, c3, c4);
}

// dt of rows 2 tid and 2 tid + 1 of one head's chunk (0 past Q): the
// warpgroup's threads load the next head's while they work on this one.
__device__ __forceinline__ void load_dt(float (&d)[2], const float* dtp, int64_t sdt, int Q,
                                        int tid) {
  d[0] = 2 * tid < Q ? dtp[(int64_t)(2 * tid) * sdt] : 0.f;
  d[1] = 2 * tid + 1 < Q ? dtp[(int64_t)(2 * tid + 1) * sdt] : 0.f;
}

// The chunk's dt of one head (d as load_dt gave it) and its prefix sums
// times a into cum: each thread's two rows, a scan over the warp, the warps'
// totals through `tot` (4 floats), in a fixed order.  Ends with the
// warpgroup's barrier.
__device__ __forceinline__ void wg_head_vectors(const float (&d)[2], float a, float* vdt,
                                                float* vcum, float* tot, int tid, int bar) {
  const int lane = tid & 31, warp = tid >> 5;
  float s = d[0] + d[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  float run = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) run = 0.f;
  if (lane == 31) tot[warp] = s;
  *reinterpret_cast<float2*>(vdt + 2 * tid) = make_float2(d[0], d[1]);
  hop::bar_sync(bar, 128);
  float base = 0.f;
  for (int k = 0; k < warp; ++k) base += tot[k];
  run += base;
  run += d[0];
  const float c0 = run * a;
  run += d[1];
  *reinterpret_cast<float2*>(vcum + 2 * tid) = make_float2(c0, run * a);
  hop::bar_sync(bar, 128);
}

using fa::ex2;  // 2^x, one instruction (flash_wg.cuh)

// ---- forward, bf16 ------------------------------------------------------------------

// x, b and c as 5-d TMA maps (make_map below); `ord[m][k]` is which of (row,
// head or group, chunk, batch) dim k + 1 of map m (x, b, c) is.
struct FwdMaps {
  CUtensorMap x, b, c;
};

struct FwdArgs {
  Args p;
  int ord[3][4];
  int nc, G, S, R, nt;  // chunks, groups, slices a group, heads a slice, row tiles
};

template <int HP, int N>
struct FwdWg {
  // two warpgroups; a thread of each issues its own copies (see the note)
  static constexpr int NTH = 256;
  static constexpr int TILE_N = BT * N * 2, TILE_X = BT * HP * 2;  // bytes of a bf16 tile
  static constexpr int RING = 4;              // a warpgroup's streamed x tiles
  static constexpr int NTM = QMAX / BT;       // held score tiles: a chunk's row tiles at most
  static constexpr int NMT = (N + 63) / 64;   // 64-row tiles of a head's states
  static constexpr int MAXH = SLICE_HEADS / 2;  // a warpgroup's heads
  // a warpgroup's own: its ring, each of its heads' dt, cum and weights (QMAX
  // each), the warps' totals of each head's scan
  static constexpr int WGB =
      (RING * TILE_X + (MAXH * 3 * QMAX + MAXH * 4) * 4 + 1023) / 1024 * 1024;
  static constexpr int BARS = (1 + 2 * RING) * 8;  // B/C in; each ring tile in
  // B_0..B_{nt-1}, C_t (a y block's row tile), the warpgroups', the
  // barriers, and 1024 bytes to align the base (the swizzle's period)
  static size_t smem(int nt) { return 1024 + (size_t)(nt + 1) * TILE_N + 2 * WGB + BARS; }
};

// grid: one block per (batch, chunk, group, slice of R heads, role), role
// fastest: role 0 the slice's states (and cum), role r > 0 y of row tile
// nt − r; two warpgroups, heads w, w + 2, ... of the slice each (see the
// note at the top of the file).
template <int HP, int N>
__global__ void __launch_bounds__(FwdWg<HP, N>::NTH, 1)
    ssd_chunk_wg_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs A) {
  using W = FwdWg<HP, N>;
  constexpr int NY = HP / 2;  // accumulators a thread of an m64 x hp result
  constexpr int RING = W::RING, NTM = W::NTM, NMT = W::NMT;
  const Args& p = A.p;
  const int Q = p.Q, nt = A.nt, R = A.R;
  int blk = blockIdx.x;
  const int role = blk % (nt + 1);
  blk /= nt + 1;
  const int sl = blk % A.S;
  blk /= A.S;
  const int g = blk % A.G;
  blk /= A.G;
  const int c = blk % A.nc, bb = blk / A.nc;
  const bool states = role == 0;
  const int ti = nt - role;               // a y block's row tile
  const int per = states ? nt : ti + 1;   // x tiles a head: x_0 .. x_{per-1}
  const int h0 = g * p.rep + sl * R;      // the slice's first head

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = fa::smem_base(smem_raw);
  bf16* sB = reinterpret_cast<bf16*>(base);  // B_0 .. B_{nt-1}
  bf16* sC = sB + nt * BT * N;               // C_ti
  uint8_t* wgbase = base + (size_t)(nt + 1) * W::TILE_N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wgbase + 2 * W::WGB);
  // the warpgroup, broadcast from lane 0 so that ptxas sees it as uniform
  const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const int lane = tid & 31, wq = tid >> 5;
  uint64_t* ring_full = bars + 1 + RING * w;
  bf16* ring_buf = reinterpret_cast<bf16*>(wgbase + w * W::WGB);
  // the warpgroup's k-th head's dt, cum and weights at vecs + 3 k QMAX, + QMAX, + 2 QMAX
  float* vecs = reinterpret_cast<float*>(wgbase + w * W::WGB + RING * W::TILE_X);
  float* sTot = vecs + W::MAXH * 3 * QMAX;  // [MAXH][4]
  if (threadIdx.x == 0) {
    for (int k = 0; k < 1 + 2 * RING; ++k) hop::mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's x tiles, in the order it consumes them: x_0 .. x_{per-1}
  // of each of its heads, each into the slot the copy RING before it frees.
  // Issued by the warpgroup's thread 0.
  const int nh = R > w ? (R - w + 1) / 2 : 0;  // heads w, w + 2, ...
  auto issue_ring = [&](int n) {
    if (n >= nh * per) return;
    const int h = h0 + w + 2 * (n / per), tile = n % per;
    hop::fence_async_smem();
    hop::mbar_expect_tx(&ring_full[n % RING], W::TILE_X);
    tma_tile<HP>(ring_buf + (n % RING) * BT * HP, &maps.x, A.ord[0], tile, h, c, bb,
                 &ring_full[n % RING]);
  };
  if (tid == 0) {
    if (w == 0) {  // the block's B tiles (and a y block's C tile), once
      const int nb = states ? nt : ti + 1;
      hop::mbar_expect_tx(&bars[0], (nb + !states) * W::TILE_N);
      for (int k = 0; k < nb; ++k)
        tma_tile<N>(sB + k * BT * N, &maps.b, A.ord[1], k, g, c, bb, &bars[0]);
      if (!states) tma_tile<N>(sC, &maps.c, A.ord[2], ti, g, c, bb, &bars[0]);
    }
    for (int n = 0; n < RING; ++n) issue_ring(n);
  }
  __syncwarp();
  if (nh == 0) return;  // a slice of one head: warpgroup 1 has none (no block barrier follows)
  // ring tile n is free once the warpgroup is done with it: the one RING
  // further on goes into its slot
  auto release = [&](int n) {
    hop::bar_sync(1 + w, 128);
    if (tid == 0) issue_ring(n + RING);
  };

  const int q4 = lane & 3, rl0 = wq * 16 + (lane >> 2);  // rows rl0, rl0 + 8 of a tile
  const int bar = 1 + w;                                  // the warpgroup's barrier
  // Every head's vectors, once, while B, C and the first x tiles are in
  // flight: dt, cum (its prefix sums times a: a scan over the warpgroup, in
  // wg_head_vectors' order) and the weights vw_r = exp(cum_e − cum_r)·dt_r,
  // e the last row of r's tile (y) or Q − 1 (states); the states block
  // writes cum.
  {
    constexpr int MAXH = W::MAXH;
    // dt of the warpgroup's heads into vecs, rows past Q zeros: where a row's
    // heads are contiguous and aligned, a warp reads 8 rows' R heads in
    // 16-byte loads (the warpgroup keeps every other head), else one element
    // a load; and every head's a
    const float* dtb = p.dt + bb * p.sd[0] + c * p.sd[1];
    if (p.sd[3] == 1 && p.sd[2] % 4 == 0 && R % 4 == 0 && fa::aligned16(dtb + h0)) {
      const int row4 = R / 4;  // 16-byte loads a row
      for (int i = tid; i < QMAX * row4; i += 128) {
        const int r = i / row4, m = i % row4;
        const float4 v =
            r < Q ? fa::ld4(dtb + (int64_t)r * p.sd[2] + h0 + 4 * m) : make_float4(0.f, 0.f, 0.f, 0.f);
        vecs[6 * m * QMAX + r] = w ? v.y : v.x;
        vecs[(6 * m + 3) * QMAX + r] = w ? v.w : v.z;
      }
    } else {
      for (int i = tid; i < QMAX * nh; i += 128) {
        const int k = i / QMAX, r = i % QMAX;
        vecs[3 * k * QMAX + r] =
            r < Q ? dtb[(int64_t)r * p.sd[2] + (int64_t)(h0 + w + 2 * k) * p.sd[3]] : 0.f;
      }
    }
    float d[MAXH][2], av[MAXH], run[MAXH];
#pragma unroll
    for (int k = 0; k < MAXH; ++k)
      if (k < nh) av[k] = p.a[(h0 + w + 2 * k) * p.sa];
    hop::bar_sync(bar, 128);
#pragma unroll
    for (int k = 0; k < MAXH; ++k) {
      if (k < nh) {
        const float2 dd = *reinterpret_cast<const float2*>(vecs + 3 * k * QMAX + 2 * tid);
        d[k][0] = dd.x;
        d[k][1] = dd.y;
        float t = d[k][0] + d[k][1];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, t, o);
          if (lane >= o) t += v;
        }
        run[k] = __shfl_up_sync(0xffffffffu, t, 1);
        if (lane == 0) run[k] = 0.f;
        if (lane == 31) sTot[4 * k + wq] = t;
      }
    }
    hop::bar_sync(bar, 128);
#pragma unroll
    for (int k = 0; k < MAXH; ++k) {
      if (k < nh) {
        float base = 0.f;
        for (int m = 0; m < wq; ++m) base += sTot[4 * k + m];
        float t = run[k] + base;
        t += d[k][0];
        const float c0 = t * av[k];
        t += d[k][1];
        *reinterpret_cast<float2*>(vecs + (3 * k + 1) * QMAX + 2 * tid) =
            make_float2(c0, t * av[k]);
      }
    }
    hop::bar_sync(bar, 128);
#pragma unroll
    for (int k = 0; k < MAXH; ++k) {
      if (k < nh) {
        const float* vd = vecs + 3 * k * QMAX;
        const float* vc = vd + QMAX;
        float* kp = p.cum + bb * p.sk[0] + c * p.sk[1] + (h0 + w + 2 * k) * p.sk[3];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r2 = 2 * tid + e;
          vecs[(3 * k + 2) * QMAX + r2] =
              ex2((vc[states ? Q - 1 : r2 | (BT - 1)] - vc[r2]) * fa::LOG2E) * vd[r2];
          if (states && r2 < Q) kp[(int64_t)r2 * p.sk[2]] = vc[r2];
        }
      }
    }
    hop::bar_sync(bar, 128);
  }
  hop::mbar_wait(&bars[0], 0);
  int rs = 0;  // the warpgroup's ring tiles consumed

  if (!states) {
    // ---- y_ti = Σ_{j <= ti} (s_j ∘ L ∘ dt) x_j, s_j = C_ti B_jᵀ formed once
    // for the slice's heads and held in fp32 registers
    float s[NTM][32];
    hop::wg_fence();
#pragma unroll
    for (int j = 0; j < NTM; ++j) {
      if (j <= ti) {
#pragma unroll
        for (int k = 0; k < N / 16; ++k)
          hop::wgmma_ss<0>(s[j], hop::Sw<N>::desc_k(sC, k, BT),
                           hop::Sw<N>::desc_k(sB + j * BT * N, k, BT), k > 0);
      }
    }
    hop::wg_commit();
    hop::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NTM; ++j) hop::fence_regs(s[j]);
    for (int k = 0; k < nh; ++k) {
      const int h = h0 + w + 2 * k;
      const float* vdt = vecs + 3 * k * QMAX;
      const float* vcum = vdt + QMAX;
      const float* vw = vcum + QMAX;
      const float ci[2] = {vcum[ti * BT + rl0], vcum[ti * BT + rl0 + 8]};
      float y[NY];
#pragma unroll
      for (int i = 0; i < NY; ++i) y[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NTM; ++j) {
        if (j <= ti) {
          const int q = rs % RING;
          hop::mbar_wait(&ring_full[q], (rs / RING) & 1);
          const bf16* sX = ring_buf + q * BT * HP;
          // att = s · exp(cum_i − cum_j) · dt_j in fp32: below the diagonal
          // exp(cum_i − cum_e) · exp(cum_e − cum_j), e the tile's last row (both
          // exponents <= 0); on it one exponent an entry, -inf where i < j
          float att[32];
          if (j < ti) {
            const float ce = vcum[j * BT + BT - 1];
            const float u[2] = {ex2((ci[0] - ce) * fa::LOG2E), ex2((ci[1] - ce) * fa::LOG2E)};
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              const float2 wv = *reinterpret_cast<const float2*>(vw + j * BT + 8 * nb + 2 * q4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                att[4 * nb + e] = s[j][4 * nb + e] * u[e >> 1] * ((e & 1) ? wv.y : wv.x);
            }
          } else {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              const float2 cj = *reinterpret_cast<const float2*>(vcum + j * BT + 8 * nb + 2 * q4);
              const float2 dj = *reinterpret_cast<const float2*>(vdt + j * BT + 8 * nb + 2 * q4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = 8 * nb + 2 * q4 + (e & 1), row = rl0 + 8 * (e >> 1);
                const float arg = col <= row ? ci[e >> 1] - ((e & 1) ? cj.y : cj.x) : -INFINITY;
                att[4 * nb + e] = s[j][4 * nb + e] * ex2(arg * fa::LOG2E) * ((e & 1) ? dj.y : dj.x);
              }
            }
          }
          // y += att·x_j: att rounded to bf16 in the A operand, x_j exact
          uint32_t af[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fa::c_to_a(af[kk], att + 8 * kk, att + 8 * kk + 4);
          hop::wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_rs<1>(y, af[kk], hop::Sw<HP>::desc_mn(sX, kk, BT), 1);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::fence_regs(y);
          release(rs++);
        }
      }
      // y_ti, rounded to bf16 once
      bf16* yp = (bf16*)p.y + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int gi = ti * BT + rl0 + 8 * h2;
        if (gi < Q) {
          bf16* row = yp + (int64_t)gi * p.sy[2] + 2 * q4;
#pragma unroll
          for (int nb = 0; nb < HP / 8; ++nb)
            *reinterpret_cast<uint32_t*>(row + 8 * nb) =
                fa::pack_bf16(y[4 * nb + 2 * h2], y[4 * nb + 2 * h2 + 1]);
        }
      }
    }
  } else {
    // ---- states = Σ_j (B_j w_j)ᵀ x_j, w_r = exp(cum_{Q-1} − cum_r)·dt_r: Bᵀ
    // read as the register A operand by ldmatrix.trans, each bf16 pair times
    // its rows' w in fp32 and rounded once; and cum
    for (int k = 0; k < nh; ++k) {
      const int h = h0 + w + 2 * k;
      const float* vw = vecs + (3 * k + 2) * QMAX;
      float st[NMT][NY];
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
        for (int i = 0; i < NY; ++i) st[mt][i] = 0.f;
      for (int j = 0; j < nt; ++j) {
        const int q = rs % RING;
        hop::mbar_wait(&ring_full[q], (rs / RING) & 1);
        const bf16* sX = ring_buf + q * BT * HP;
        const uint8_t* sBj = reinterpret_cast<const uint8_t*>(sB + j * BT * N);
        uint32_t af[NMT][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int r0 = j * BT + 16 * kk + 2 * q4;  // k of a0 / a1; r0 + 8 for a2 / a3
          const float2 w01 = *reinterpret_cast<const float2*>(vw + r0);
          const float2 w89 = *reinterpret_cast<const float2*>(vw + r0 + 8);
#pragma unroll
          for (int mt = 0; mt < NMT; ++mt) {
            const int n0 = 64 * mt + 16 * wq;  // the warp's 16 rows n of the states tile
            if (n0 < N) {                      // N < 64: rows past N are zeros
              fa::ldsm_x4_t(af[mt][kk], reinterpret_cast<const bf16*>(
                                            sBj + hop::Sw<N>::off(16 * kk + (lane >> 4) * 8 +
                                                                      (lane & 7),
                                                                  n0 + ((lane >> 3) & 1) * 8, BT)));
              af[mt][kk][0] = scale_pair(af[mt][kk][0], w01.x, w01.y);
              af[mt][kk][1] = scale_pair(af[mt][kk][1], w01.x, w01.y);
              af[mt][kk][2] = scale_pair(af[mt][kk][2], w89.x, w89.y);
              af[mt][kk][3] = scale_pair(af[mt][kk][3], w89.x, w89.y);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) af[mt][kk][e] = 0u;
            }
          }
        }
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mt = 0; mt < NMT; ++mt)
            hop::wgmma_rs<1>(st[mt], af[mt][kk], hop::Sw<HP>::desc_mn(sX, kk, BT), 1);
        hop::wg_commit();
        hop::wg_wait<0>();
#pragma unroll
        for (int mt = 0; mt < NMT; ++mt) hop::fence_regs(st[mt]);
        release(rs++);
      }
      float* sp = p.st + bb * p.ss[0] + c * p.ss[1] + h * p.ss[2];
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 64 * mt + rl0 + 8 * h2;
          if (n < N) {
            float* row = sp + (int64_t)n * p.ss[3] + 2 * q4;
#pragma unroll
            for (int nb = 0; nb < HP / 8; ++nb)
              *reinterpret_cast<float2*>(row + 8 * nb) =
                  make_float2(st[mt][4 * nb + 2 * h2], st[mt][4 * nb + 2 * h2 + 1]);
          }
        }
    }
  }
}

template <int HP, int N>
struct FwdLaunch {
  static int run(const FwdMaps& maps, const FwdArgs& args, int blocks, cudaStream_t stream) {
    auto kernel = ssd_chunk_wg_kernel<HP, N>;
    // the limit for the longest chunk, set once a device (fa::smem_limit_once)
    static bool limit_set[64] = {};
    cudaError_t err = fa::smem_limit_once(kernel, FwdWg<HP, N>::smem(QMAX / BT), limit_set);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, FwdWg<HP, N>::NTH, FwdWg<HP, N>::smem(args.nt), stream>>>(maps, args);
    return (int)cudaGetLastError();
  }
};

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int HP, int N>
struct FwdGrid {
  static int run(int blocks, int nt, int* out) {
    auto kernel = ssd_chunk_wg_kernel<HP, N>;
    const size_t smem = FwdWg<HP, N>::smem(nt);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, FwdWg<HP, N>::NTH,
                                                          smem);
    out[0] = blocks;
    out[2] = FwdWg<HP, N>::NTH;
    out[3] = (int)smem;
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

// ---- backward, bf16: two warpgroups on wgmma, fed by TMA --------------------------

// The four bf16 inputs as 5-d TMA maps: dim 0 the row's columns (hp or N),
// then row, head (group for b and c), chunk and batch in the order of their
// strides; `ord[m][k]` is which of (row, head, chunk, batch) dim k + 1 of map
// m (x, dy, b, c) is.
struct WgMaps {
  CUtensorMap x, dy, b, c;
};

struct WgArgs {
  BwdArgs p;    // pdb, pdc: a slice's partials (batch, chunk, group, slice, Q, N); pda a head's
  float* pvec;  // a head's vectors (batch, chunk, head, nt + 3, Q): see bwd_final_kernel
  int ord[4][4];
  int nc, G, S, R, nt;  // chunks, groups, slices a group, heads a slice, row tiles
};

template <int HP, int N>
struct Wg {
  // two warpgroups; a thread of each issues its own copies (see the note)
  static constexpr int NTH = 256;
  static constexpr int TILE_N = BT * N * 2, TILE_X = BT * HP * 2;  // bytes of a bf16 tile
  static constexpr int HELD = 2, RING = 2;  // a warpgroup's held and streamed hp-tiles
  static constexpr int MAXH = 8;            // its heads: a slice of at most 16 (SLICE_HEADS)
  // a warpgroup's own: its held and streamed tiles, dS (N x hp bf16), dt and
  // cum of each of its heads (QMAX each), two [4][BT] row-sum buffers, the
  // warps' totals of a scan
  static constexpr int WGB =
      ((HELD + RING) * TILE_X + N * HP * 2 + (2 * MAXH * QMAX + 2 * 4 * BT + 4) * 4 + 1023) /
      1024 * 1024;
  static constexpr int BARS = (1 + 2 * (HELD + RING)) * 8;  // B/C in; each tile in
  // B_0..B_t and C_t..C_{nt-1} (nt + 1 tiles), the warpgroups', the barriers,
  // and 1024 bytes to align the base (the swizzle's period)
  static size_t smem(int nt) { return 1024 + (size_t)(nt + 1) * TILE_N + 2 * WGB + BARS; }
};

// The pair of bf16 at (r, c) of a D-wide 64-row canonical tile.
template <int D>
__device__ __forceinline__ uint32_t tile_pair(const bf16* tile, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(tile) +
                                            hop::Sw<D>::off(r, c, BT));
}

// The A operand of the 16-deep step k of a D-wide 64-row canonical tile,
// read from shared memory (rows jl0, jl0 + 8; the warp's quad column 2 q4),
// each row's pair times f0 / f8 in fp32 and rounded back to bf16.
template <int D>
__device__ __forceinline__ void tile_a(uint32_t (&a)[4], const bf16* tile, int k, int jl0, int q4,
                                       float f0, float f8) {
  const int c = 16 * k + 2 * q4;
  a[0] = scale_pair(tile_pair<D>(tile, jl0, c), f0, f0);
  a[1] = scale_pair(tile_pair<D>(tile, jl0 + 8, c), f8, f8);
  a[2] = scale_pair(tile_pair<D>(tile, jl0, c + 8), f0, f0);
  a[3] = scale_pair(tile_pair<D>(tile, jl0 + 8, c + 8), f8, f8);
}

// The sums over the warp's 16 rows (over g = lane / 4) of a thread's 16
// column values v[2 nb + e] (column 8 nb + 2 q4 + e of its two rows), by a
// halving exchange with the lanes xor 16, 8 and 4: afterwards v[0] and v[1]
// hold the sums of columns col and col + 1, col returned.
__device__ __forceinline__ int rows_sum16(float (&v)[16], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float send = b4 ? v[k] : v[k + 8];
    v[k] = (b4 ? v[k + 8] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b3 ? v[k] : v[k + 4];
    v[k] = (b3 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b2 ? v[k] : v[k + 2];
    v[k] = (b2 ? v[k + 2] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const int slot = 8 * b4 + 4 * b3 + 2 * b2;  // v[0], v[1] are slots slot, slot + 1
  return 8 * (slot >> 1) + 2 * (lane & 3);
}

// grid: one block per (batch, chunk, group, slice of R heads, row tile t),
// t fastest; two warpgroups (see the note at the top of the file).
template <int HP, int N>
__global__ void __launch_bounds__(Wg<HP, N>::NTH, 1)
    ssd_chunk_bwd_wg_kernel(const __grid_constant__ WgMaps maps, const WgArgs A) {
  using W = Wg<HP, N>;
  constexpr int NX = HP / 2, NN = N / 2;  // accumulators a thread of hp- and N-wide results
  const BwdArgs& p = A.p;
  const int Q = p.Q, nt = A.nt, R = A.R;
  int blk = blockIdx.x;
  const int t = blk % nt;
  blk /= nt;
  const int sl = blk % A.S;
  blk /= A.S;
  const int g = blk % A.G;
  blk /= A.G;
  const int c = blk % A.nc, bb = blk / A.nc;
  const int H = A.G * p.rep;
  const int h0 = g * p.rep + sl * R;  // the slice's first head

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  bf16* sBC = reinterpret_cast<bf16*>(base);  // slot k <= t: B_k; slot k > t: C_{k-1}
  uint8_t* wgbase = base + (size_t)(nt + 1) * W::TILE_N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wgbase + 2 * W::WGB);
  // the exchange of the warpgroups' sums: slot nt (C_{nt-1}), free once both
  // have left walk 1, 64 x N / 2 fp32
  float* xch = reinterpret_cast<float*>(sBC + nt * BT * N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp >> 2, wq = warp & 3, tid = threadIdx.x & 127;
  // bars[0]: B and C in; warpgroup w's: its two held and two streamed tiles in
  constexpr int HELD = W::HELD, RING = W::RING;
  uint64_t* held_full = bars + 1 + (HELD + RING) * w;
  uint64_t* ring_full = held_full + HELD;
  bf16* held_buf = reinterpret_cast<bf16*>(wgbase + w * W::WGB);
  bf16* ring_buf = held_buf + HELD * BT * HP;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 1 + 2 * (HELD + RING); ++k) hop::mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's copies, in the order it consumes them, each into the
  // slot the copy two (HELD, RING) before it frees: held tile m, streamed
  // tile n.  Walk 1 holds x_t of each head and streams dy_t .. dy_{nt-1};
  // walk 2 holds dy_t and streams x_0 .. x_t.  Issued by the warpgroup's
  // thread 0.
  const int nh = R > w ? (R - w + 1) / 2 : 0;  // heads w, w + 2, ...
  auto issue_held = [&](int m) {
    if (m >= 2 * nh) return;
    const int walk = m >= nh, h = h0 + w + 2 * (m - walk * nh);
    hop::fence_async_smem();
    hop::mbar_expect_tx(&held_full[m & 1], W::TILE_X);
    tma_tile<HP>(held_buf + (m & 1) * BT * HP, walk ? &maps.dy : &maps.x, A.ord[walk], t, h, c,
                 bb, &held_full[m & 1]);
  };
  auto issue_ring = [&](int n) {
    const int n0 = nh * (nt - t);
    if (n >= n0 + nh * (t + 1)) return;
    const int walk = n >= n0, per = walk ? t + 1 : nt - t, k = walk ? n - n0 : n;
    const int h = h0 + w + 2 * (k / per), tile = (walk ? 0 : t) + k % per;
    hop::fence_async_smem();
    hop::mbar_expect_tx(&ring_full[n % RING], W::TILE_X);
    tma_tile<HP>(ring_buf + (n % RING) * BT * HP, walk ? &maps.x : &maps.dy,
                 A.ord[walk ? 0 : 1], tile, h, c, bb, &ring_full[n % RING]);
  };
  if (tid == 0) {
    if (w == 0) {  // the block's B and C tiles, once: B_0..B_t, C_t..C_{nt-1}
      hop::mbar_expect_tx(&bars[0], (nt + 1) * W::TILE_N);
      for (int k = 0; k <= nt; ++k) {
        if (k <= t)
          tma_tile<N>(sBC + k * BT * N, &maps.b, A.ord[2], k, g, c, bb, &bars[0]);
        else
          tma_tile<N>(sBC + k * BT * N, &maps.c, A.ord[3], k - 1, g, c, bb, &bars[0]);
      }
    }
    issue_held(0);
    issue_held(1);
    for (int n = 0; n < RING; ++n) issue_ring(n);
  }
  __syncwarp();

  // ---- warpgroup w: heads w, w + 2, ... of the slice
  const int q4 = lane & 3, jl0 = wq * 16 + (lane >> 2);  // rows jl0, jl0 + 8 of a tile
  const int bar = 1 + w;                                    // the warpgroup's barrier
  uint8_t* mine = wgbase + w * W::WGB;
  bf16* sDS = reinterpret_cast<bf16*>(mine + (HELD + RING) * W::TILE_X);  // rows n, columns p
  // dt and cum of the warpgroup's m-th head at vecs + 2 m QMAX, + QMAX
  float* vecs = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(sDS) + N * HP * 2);
  float* sRed = vecs + 2 * W::MAXH * QMAX;  // [2][4][BT]
  float* sTot = sRed + 2 * 4 * BT;           // [4]
  const bf16* sBt = sBC + t * BT * N;
  const int64_t sp = (((int64_t)bb * A.nc + c) * A.G + g) * A.S + sl;  // the slice's partial
  const int gj0 = t * BT + jl0;                                        // the thread's rows
  float accN[NN];  // dB_t over walk 1's heads, then dC_t over walk 2's
#pragma unroll
  for (int i = 0; i < NN; ++i) accN[i] = 0.f;
  auto ds_of = [&](int h) { return p.ds + bb * p.sS[0] + c * p.sS[1] + h * p.sS[2]; };
  const bool ds_fast = p.sS[4] == 1 && p.sS[3] % 4 == 0 && p.sS[2] % 4 == 0 &&
                       p.sS[1] % 4 == 0 && p.sS[0] % 4 == 0 && fa::aligned16(p.ds);
  // dt of the warpgroup's next head, loaded while it works on this one
  auto dt_of = [&](int h) { return p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3]; };
  float dtn[2] = {0.f, 0.f};
  if (nh > 0) load_dt(dtn, dt_of(h0 + w), p.sd[2], Q, tid);
  hop::mbar_wait(&bars[0], 0);
  int hs = 0, rs = 0, buf = 0;

  // the warpgroups' sums of accN, warpgroup 0's then 1's, into rows of `out`
  // (a slice's (Q, N) partial), through the exchange buffer in two halves
  auto combine = [&](float* out) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      hop::bar_sync(3, 256);  // both are past their walk and the previous half
      if (w == 1) {
#pragma unroll
        for (int i = 0; i < NN / 2; ++i) xch[i * 128 + tid] = accN[half * NN / 2 + i];
      }
      hop::bar_sync(3, 256);
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < NN / 2; ++i) accN[half * NN / 2 + i] += xch[i * 128 + tid];
      }
    }
    if (w == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int gj = gj0 + 8 * h2;
        if (gj < Q) {
          float* row = out + (sp * Q + gj) * N + 2 * q4;
#pragma unroll
          for (int nb = 0; nb < N / 8; ++nb)
            *reinterpret_cast<float2*>(row + 8 * nb) =
                make_float2(accN[4 * nb + 2 * h2], accN[4 * nb + 2 * h2 + 1]);
        }
      }
    }
    hop::bar_sync(3, 256);
#pragma unroll
    for (int i = 0; i < NN; ++i) accN[i] = 0.f;
  };

  // ---- walk 1: column tile t held (B_t, x_t), row tiles it >= t streamed
  // (C_it from the block's tiles, dy_it from the ring): du_t, dB_t, the sums
  // of dP P, and at the end the states' terms
  for (int r = w; r < R; r += 2) {
    const int h = h0 + r;
    const float a = p.a[h * p.sa];
    float* vec = A.pvec + (((int64_t)bb * A.nc + c) * H + h) * (nt + 3) * Q;
    hop::bar_sync(bar, 128);  // the previous head's readers of its tiles, vectors, dS are done
    if (tid == 0 && hs > 0) issue_held(hs + 1);
    // dS in bf16: 16-byte loads along p where rows of p are contiguous and
    // aligned, all in flight at once; else along whichever dim is contiguous
    const float* Sp = ds_of(h);
    if (ds_fast) {
      constexpr int ITEMS = (N * HP / 8 + 127) / 128;
      float4 lo[ITEMS], hi[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int idx = tid + 128 * k;
        if (idx < N * HP / 8) {
          const float* src = Sp + (idx / (HP / 8)) * p.sS[3] + (idx % (HP / 8)) * 8;
          lo[k] = fa::ld4(src);
          hi[k] = fa::ld4(src + 4);
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int idx = tid + 128 * k;
        if (idx < N * HP / 8) {
          const int n = idx / (HP / 8), p8 = idx % (HP / 8);
          *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(sDS) +
                                    hop::Sw<HP>::off(n, 8 * p8, N)) =
              make_uint4(fa::pack_bf16(lo[k].x, lo[k].y), fa::pack_bf16(lo[k].z, lo[k].w),
                         fa::pack_bf16(hi[k].x, hi[k].y), fa::pack_bf16(hi[k].z, hi[k].w));
        }
      }
    } else {
      const bool n_inner = p.sS[3] == 1 && p.sS[4] != 1;
      for (int idx = tid; idx < N * HP / 8; idx += 128) {
        const int n = n_inner ? idx % N : idx / (HP / 8);
        const int p8 = n_inner ? idx / N : idx % (HP / 8);
        const float* src = Sp + n * p.sS[3] + p8 * 8 * p.sS[4];
        uint4 v;
        v.x = fa::pack_bf16(src[0], src[p.sS[4]]);
        v.y = fa::pack_bf16(src[2 * p.sS[4]], src[3 * p.sS[4]]);
        v.z = fa::pack_bf16(src[4 * p.sS[4]], src[5 * p.sS[4]]);
        v.w = fa::pack_bf16(src[6 * p.sS[4]], src[7 * p.sS[4]]);
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(sDS) +
                                  hop::Sw<HP>::off(n, 8 * p8, N)) = v;
      }
    }
    hop::fence_async_smem();
    // the head's dt and cum, kept for walk 2
    float* vdt = vecs + 2 * hs * QMAX;
    float* vcum = vdt + QMAX;
    {
      const float d[2] = {dtn[0], dtn[1]};
      if (hs + 1 < nh) load_dt(dtn, dt_of(h + 2), p.sd[2], Q, tid);
      wg_head_vectors(d, a, vdt, vcum, sTot, tid, bar);
    }
    const int hsl = hs & 1;
    hop::mbar_wait(&held_full[hsl], (hs >> 1) & 1);
    const bf16* sX = held_buf + hsl * BT * HP;
    const float cj[2] = {vcum[gj0], vcum[gj0 + 8]};
    const float dtj[2] = {vdt[gj0], vdt[gj0 + 8]};
    float du[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) du[i] = 0.f;
    float colsum[2] = {0.f, 0.f};

    for (int it = t; it < nt; ++it) {
      const int q = rs % RING;
      hop::mbar_wait(&ring_full[q], (rs / RING) & 1);
      const bf16* sY = ring_buf + q * BT * HP;
      const bf16* sC = sBC + (it + 1) * BT * N;
      // sᵀ = B_t C_itᵀ and dPᵀ / dt_t = x_t dy_itᵀ (rows j, columns i)
      float sT[32], dPT[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sT[i] = dPT[i] = 0.f;
      hop::wg_fence();
#pragma unroll
      for (int k = 0; k < N / 16; ++k)
        hop::wgmma_ss<0>(sT, hop::Sw<N>::desc_k(sBt, k, BT), hop::Sw<N>::desc_k(sC, k, BT), 1);
#pragma unroll
      for (int k = 0; k < HP / 16; ++k)
        hop::wgmma_ss<0>(dPT, hop::Sw<HP>::desc_k(sX, k, BT), hop::Sw<HP>::desc_k(sY, k, BT),
                         1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sT);
      hop::fence_regs(dPT);
      // P = s L, ds = dP L, dP P; on the diagonal tile the exponent of a pair
      // i < j is -inf (L = 0, as the plain version's mask), so none is positive
      const bool diag = it == t;
      float rp[16];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 ci2 = *reinterpret_cast<const float2*>(vcum + it * BT + 8 * nb + 2 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nb + e, h2 = e >> 1;
          float arg = ((e & 1) ? ci2.y : ci2.x) - cj[h2];
          if (diag && 8 * nb + 2 * q4 + (e & 1) < jl0 + 8 * h2) arg = -INFINITY;
          const float L = exp2f(arg * fa::LOG2E);
          const float d = dPT[i] * dtj[h2];
          const float P = sT[i] * L, ds = d * L, seg = d * P;
          sT[i] = P;
          dPT[i] = ds;
          colsum[h2] += seg;
          if (h2 == 0)
            rp[2 * nb + (e & 1)] = seg;
          else
            rp[2 * nb + (e & 1)] += seg;
        }
      }
      const int col = rows_sum16(rp, lane);
      float* red = sRed + buf * 4 * BT + wq * BT;
      red[col] = rp[0];
      red[col + 1] = rp[1];
      // du_t += Pᵀ dy_it and dB_t += dsᵀ C_it: P and ds rounded to bf16 in the A operand
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fa::c_to_a(pa[kk], sT + 8 * kk, sT + 8 * kk + 4);
        fa::c_to_a(da[kk], dPT + 8 * kk, dPT + 8 * kk + 4);
      }
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<1>(du, pa[kk], hop::Sw<HP>::desc_mn(sY, kk, BT), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<1>(accN, da[kk], hop::Sw<N>::desc_mn(sC, kk, BT), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(du);
      hop::fence_regs(accN);
      // the streamed tile is free: the one RING further on goes into it; the row
      // sums of dP P over the tile's columns j, the warps in order
      hop::bar_sync(bar, 128);
      if (tid == 0) issue_ring(rs + RING);
      if (tid < BT && it * BT + tid < Q) {
        const float* rr = sRed + buf * 4 * BT + tid;
        vec[t * Q + it * BT + tid] = ((rr[0] + rr[BT]) + rr[2 * BT]) + rr[3 * BT];
      }
      ++rs;
      buf ^= 1;
    }

    // the states' terms of rows j of tile t: q = (w_j B_t) dS with w_j B_t
    // rounded to bf16; dw_j = dt_j <q, x_j>; du += q; dx_j, ddt_j's direct
    // part; and dB_t += (w_j dt_j x_j) dSᵀ, w_j dt_j x_j rounded to bf16, on the
    // tensor cores while the rest is computed
    const float cq = vcum[Q - 1];
    const float wj[2] = {expf(cq - cj[0]), expf(cq - cj[1])};
    {
      float qv[NX];
      {
        uint32_t ab[N / 16][4];
#pragma unroll
        for (int k = 0; k < N / 16; ++k) tile_a<N>(ab[k], sBt, k, jl0, q4, wj[0], wj[1]);
#pragma unroll
        for (int i = 0; i < NX; ++i) qv[i] = 0.f;
        hop::wg_fence();
#pragma unroll
        for (int k = 0; k < N / 16; ++k)
          hop::wgmma_rs<1>(qv, ab[k], hop::Sw<HP>::desc_mn(sDS, k, N), 1);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(qv);
      }
      // the thread's pairs of x_t (rows jl0 + 8 h2, columns 8 nb + 2 q4): the
      // A operand of the step k = nb / 2 is pairs (nb, 0), (nb, 1), (nb + 1, 0),
      // (nb + 1, 1) of even nb
      uint32_t xq[HP / 8][2];
#pragma unroll
      for (int nb = 0; nb < HP / 8; ++nb)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          xq[nb][h2] = tile_pair<HP>(sX, jl0 + 8 * h2, 8 * nb + 2 * q4);
      uint32_t ax[HP / 16][4];
#pragma unroll
      for (int k = 0; k < HP / 16; ++k) {
        const float f0 = wj[0] * dtj[0], f8 = wj[1] * dtj[1];
        ax[k][0] = scale_pair(xq[2 * k][0], f0, f0);
        ax[k][1] = scale_pair(xq[2 * k][1], f8, f8);
        ax[k][2] = scale_pair(xq[2 * k + 1][0], f0, f0);
        ax[k][3] = scale_pair(xq[2 * k + 1][1], f8, f8);
      }
      hop::wg_fence();
#pragma unroll
      for (int k = 0; k < HP / 16; ++k)
        hop::wgmma_rs<0>(accN, ax[k], hop::Sw<HP>::desc_k(sDS, k, N), 1);
      hop::wg_commit();
      float dw[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < HP / 8; ++nb) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xq[nb][h2]));
          const int i = 4 * nb + 2 * h2;
          dw[h2] = fmaf(qv[i], xv.x, dw[h2]);
          dw[h2] = fmaf(qv[i + 1], xv.y, dw[h2]);
          du[i] += qv[i];
          du[i + 1] += qv[i + 1];
          dd[h2] = fmaf(du[i], xv.x, dd[h2]);
          dd[h2] = fmaf(du[i + 1], xv.y, dd[h2]);
        }
      }
      bf16* dxp = (bf16*)p.dx + bb * p.sdx[0] + c * p.sdx[1] + h * p.sdx[3];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        dw[h2] = fa::quad_sum(dw[h2]) * dtj[h2];
        dd[h2] = fa::quad_sum(dd[h2]);
        const float cs = fa::quad_sum(colsum[h2]);
        const int gj = gj0 + 8 * h2;
        if (gj < Q) {
          bf16* row = dxp + (int64_t)gj * p.sdx[2] + 2 * q4;
#pragma unroll
          for (int nb = 0; nb < HP / 8; ++nb)
            *reinterpret_cast<uint32_t*>(row + 8 * nb) = fa::pack_bf16(
                du[4 * nb + 2 * h2] * dtj[h2], du[4 * nb + 2 * h2 + 1] * dtj[h2]);
          if (q4 == 0) {
            vec[nt * Q + gj] = cs;
            vec[(nt + 1) * Q + gj] = dw[h2];
            vec[(nt + 2) * Q + gj] = dd[h2];
          }
        }
      }
      hop::wg_wait<0>();
      hop::fence_regs(accN);
    }
    ++hs;
  }
  combine(p.pdb);

  // ---- walk 2: row tile t held (dy_t), column tiles jt <= t streamed (x_jt
  // from the ring, B_jt from the block's tiles): dC_t
  for (int r = w; r < R; r += 2) {
    const int h = h0 + r;
    const float a = p.a[h * p.sa];
    hop::bar_sync(bar, 128);
    if (tid == 0 && hs > 0) issue_held(hs + 1);
    const float* vdt = vecs + 2 * (hs - nh) * QMAX;  // as walk 1 left them
    const float* vcum = vdt + QMAX;
    const int hsl = hs & 1;
    hop::mbar_wait(&held_full[hsl], (hs >> 1) & 1);
    const bf16* sY = held_buf + hsl * BT * HP;
    const float ci[2] = {vcum[gj0], vcum[gj0 + 8]};
    for (int jt = 0; jt <= t; ++jt) {
      const int q = rs % RING;
      hop::mbar_wait(&ring_full[q], (rs / RING) & 1);
      const bf16* sXj = ring_buf + q * BT * HP;
      // dP / dt_j = dy_t x_jtᵀ (rows i, columns j)
      float dP[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dP[i] = 0.f;
      hop::wg_fence();
#pragma unroll
      for (int k = 0; k < HP / 16; ++k)
        hop::wgmma_ss<0>(dP, hop::Sw<HP>::desc_k(sY, k, BT), hop::Sw<HP>::desc_k(sXj, k, BT),
                         1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(dP);
      // ds = dP dt_j L, the exponent of a pair i < j -inf as in walk 1
      const bool diag = jt == t;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 cj2 = *reinterpret_cast<const float2*>(vcum + jt * BT + 8 * nb + 2 * q4);
        const float2 dt2 = *reinterpret_cast<const float2*>(vdt + jt * BT + 8 * nb + 2 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nb + e, h2 = e >> 1;
          float arg = ci[h2] - ((e & 1) ? cj2.y : cj2.x);
          if (diag && jl0 + 8 * h2 < 8 * nb + 2 * q4 + (e & 1)) arg = -INFINITY;
          dP[i] = dP[i] * ((e & 1) ? dt2.y : dt2.x) * exp2f(arg * fa::LOG2E);
        }
      }
      // dC_t += ds B_jt, ds rounded to bf16 in the A operand
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fa::c_to_a(da[kk], dP + 8 * kk, dP + 8 * kk + 4);
      const bf16* sB = sBC + jt * BT * N;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<1>(accN, da[kk], hop::Sw<N>::desc_mn(sB, kk, BT), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(accN);
      hop::bar_sync(bar, 128);
      if (tid == 0) issue_ring(rs + RING);
      ++rs;
    }
    ++hs;
  }
  combine(p.pdc);
}

template <int HP, int N>
struct WgLaunch {
  static int run(const WgMaps& maps, const WgArgs& args, int blocks, cudaStream_t stream) {
    auto kernel = ssd_chunk_bwd_wg_kernel<HP, N>;
    const size_t smem = Wg<HP, N>::smem(args.nt);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, Wg<HP, N>::NTH, smem, stream>>>(maps, args);
    return (int)cudaGetLastError();
  }
};

// out: blocks of the grid, resident blocks an SM, threads a block, dynamic
// shared memory bytes.
template <int HP, int N>
struct WgGrid {
  static int run(int blocks, int nt, int* out) {
    auto kernel = ssd_chunk_bwd_wg_kernel<HP, N>;
    const size_t smem = Wg<HP, N>::smem(nt);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, Wg<HP, N>::NTH, smem);
    out[0] = blocks;
    out[2] = Wg<HP, N>::NTH;
    out[3] = (int)smem;
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

// The bf16 route's last step for one head, one warp a (batch, chunk, head),
// from the main kernel's vectors (`pvec`, each Q long: the row sums of dP P
// of row tiles 0 .. nt - 1, then the column sums, dw and ddt's direct part):
// dcum_k = dcum_in_k + sum_{t <= k / 64} row_{t,k} - col_k - dw_k (+ sum_j dw_j
// at k = Q - 1), ddt_k = direct_k + a sum_{m >= k} dcum_m and the head's share
// of da, sum_k dcum_k cs_k: bwd_prologue's and bwd_final's scans, in their
// orders.
__global__ void bwd_final_kernel(BwdArgs p, const float* __restrict__ pvec, int64_t heads, int nc,
                                 int H, int nt) {
  constexpr int EM = QMAX / 32;
  const int64_t bch = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (bch >= heads) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(bch % H), c = (int)(bch / H % nc);
  const int64_t bb = bch / H / nc;
  const int Q = p.Q, E = nt * BT / 32;
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const float* dcp = p.dcum + bb * p.sk[0] + c * p.sk[1] + h * p.sk[3];
  float* ddtp = p.ddt + bb * p.sdd[0] + c * p.sdd[1] + h * p.sdd[3];
  const float* vec = pvec + bch * (nt + 3) * Q;
  const float a = p.a[h * p.sa];
  float cs[EM], dc[EM];
  float tot = 0.f, tw = 0.f;
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    const int k = lane * E + e;
    cs[e] = e < E && k < Q ? dtp[(int64_t)k * p.sd[2]] : 0.f;
    tot += cs[e];
    if (e < E && k < Q) tw += vec[(nt + 1) * Q + k];
  }
  float incl = tot;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    run += cs[e];
    cs[e] = run;
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) tw += __shfl_xor_sync(0xffffffffu, tw, s);
  tot = 0.f;
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    const int k = lane * E + e;
    float d = 0.f;
    if (e < E && k < Q) {
      float row = 0.f;
      for (int t = 0; t <= k / BT; ++t) row += vec[t * Q + k];
      d = dcp[(int64_t)k * p.sk[2]] + row - vec[nt * Q + k] - vec[(nt + 1) * Q + k];
      if (k == Q - 1) d += tw;
    }
    dc[e] = d;
    tot += d;
  }
  incl = tot;  // suffix sums of the lanes' totals
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, s);
    if (lane + s < 32) incl += o;
  }
  run = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) run = 0.f;
  float da = 0.f;
#pragma unroll
  for (int e = EM - 1; e >= 0; --e) {
    if (e >= E) continue;
    const int k = lane * E + e;
    run += dc[e];
    da = fmaf(dc[e], cs[e], da);
    if (k < Q) ddtp[(int64_t)k * p.sdd[2]] = vec[(nt + 2) * Q + k] + a * run;
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) da += __shfl_xor_sync(0xffffffffu, da, s);
  if (lane == 0) p.pda[bch] = da;
}

// The TMA map of a bf16 input (batch, chunk, row, head or group, D) with
// strides `s` (elements: batch, chunk, row, head; D contiguous): hop::make_map
// over (row, head, chunk, batch).
static int make_map(CUtensorMap* map, int* ord, const void* base, const int64_t* s, int D, int Q,
                    int heads, int nc, int Bt) {
  return hop::make_map(map, ord, base, D, {Q, heads, nc, Bt}, {s[2], s[3], s[1], s[0]});
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
// h / (H / G).  bf16: slices of R heads a block (ssd_fwd_geometry in
// ssd_chunk.py); fp32: R is not read.  Returns cudaGetLastError() of the
// launch.
extern "C" int ssd_chunk(const void* x, const void* dt, const void* b, const void* c,
                         const void* a, void* y, void* st, void* cum,
                         const long long* strides, int Bt, int nc, int Q, int H, int G,
                         int hp, int N, int R, int is_bf16, void* stream) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (is_bf16 && (R < 1 || R > ssd::SLICE_HEADS || (H / G) % R)) return (int)cudaErrorInvalidValue;
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
  // by type, not a fallback: bf16 only ever reaches the wgmma kernel
  if (is_bf16) {
    ssd::FwdArgs fa_;
    fa_.p = args;
    fa_.nc = nc;
    fa_.G = G;
    fa_.R = R;
    fa_.S = H / G / R;
    fa_.nt = (Q + ssd::BT - 1) / ssd::BT;
    ssd::FwdMaps maps;
    int err;
    if ((err = ssd::make_map(&maps.x, fa_.ord[0], x, args.sx, hp, Q, H, nc, Bt)) ||
        (err = ssd::make_map(&maps.b, fa_.ord[1], b, args.sb, N, Q, G, nc, Bt)) ||
        (err = ssd::make_map(&maps.c, fa_.ord[2], c, args.sc, N, Q, G, nc, Bt)))
      return err;
    const int blocks = Bt * nc * G * fa_.S * (fa_.nt + 1);
    return ssd::switch_dims<ssd::FwdLaunch>(hp, N, maps, fa_, blocks, s);
  }
  return ssd::switch_dims<ssd::Fma>(hp, N, args, Bt, nc, H, s);
}

// The bf16 kernel's launch geometry for these dims and R heads a slice
// (out[4], see ssd::FwdGrid).
extern "C" int ssd_chunk_grid(int Bt, int nc, int Q, int H, int G, int hp, int N, int R,
                              int* out) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G || R < 1 || R > ssd::SLICE_HEADS ||
      (H / G) % R)
    return (int)cudaErrorInvalidValue;
  const int nt = (Q + ssd::BT - 1) / ssd::BT;
  return ssd::switch_dims<ssd::FwdGrid>(hp, N, Bt * nc * G * (H / G / R) * (nt + 1), nt, out);
}

// The gradient of ssd_chunk.  Inputs as ssd_chunk's, and dy like y, dstates
// (Bt,nc,H,N,hp) fp32 with any strides, dcum (Bt,nc,Q,H) fp32; outputs dx like x,
// ddt (Bt,nc,Q,H) fp32, db and dc (Bt,nc,Q,G,N) like b, contiguous, da (H,)
// fp32.  `strides` holds 38 (see ssd::BwdArgs, in that order, then a's).
// fp32 scratch: pda (Bt·nc·H); for bf16, pdb and pdc (Bt·nc·G·S, Q, N), a
// partial for each slice of R heads (S = H / G / R), and pvec (Bt·nc·H,
// ceil(Q / 64) + 3, Q); for fp32, pdb and pdc (Bt·nc·H, Q, N) and no pvec.
// Device kernels: bf16, ssd_chunk_bwd_wg_kernel, bwd_reduce_kernel over the
// slices, bwd_final_kernel; fp32, ssd_chunk_bwd_kernel, bwd_reduce_kernel
// over the heads; both then bwd_da_kernel.  Returns cudaGetLastError() after
// each launch.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* b, const void* c,
                             const void* a, const void* dy, const void* dstates,
                             const void* dcum, void* dx, void* ddt, void* db, void* dc,
                             void* da, void* pdb, void* pdc, void* pvec, void* pda,
                             const long long* strides, int Bt, int nc, int Q, int H, int G,
                             int hp, int N, int R, int is_bf16, void* stream) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (is_bf16 && (R < 1 || R > ssd::SLICE_HEADS || (H / G) % R))
    return (int)cudaErrorInvalidValue;
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
    const int64_t rows = bcs * Q * G;
    const dim3 grid((unsigned)((rows * (N / 4) + 255) / 256), 2);
    int err;
    // by type, not a fallback: bf16 only ever reaches the wgmma kernel
    if (is_bf16) {
      ssd::WgArgs wa;
      wa.p = args;
      wa.pvec = (float*)pvec;
      wa.nc = nc;
      wa.G = G;
      wa.R = R;
      wa.S = H / G / R;
      wa.nt = (Q + ssd::BT - 1) / ssd::BT;
      ssd::WgMaps maps;
      if ((err = ssd::make_map(&maps.x, wa.ord[0], x, args.sx, hp, Q, H, nc, Bt)) ||
          (err = ssd::make_map(&maps.dy, wa.ord[1], dy, args.sy, hp, Q, H, nc, Bt)) ||
          (err = ssd::make_map(&maps.b, wa.ord[2], b, args.sb, N, Q, G, nc, Bt)) ||
          (err = ssd::make_map(&maps.c, wa.ord[3], c, args.sc, N, Q, G, nc, Bt)))
        return err;
      const int blocks = (int)(bcs * G * wa.S * wa.nt);
      err = ssd::switch_dims<ssd::WgLaunch>(hp, N, maps, wa, blocks, s);
      if (err != 0) return err;
      ssd::bwd_reduce_kernel<ssd::bf16><<<grid, 256, 0, s>>>(
          (const float*)pdb, (const float*)pdc, (ssd::bf16*)db, (ssd::bf16*)dc, rows, Q, G, N,
          G * wa.S, wa.S);
      if ((err = (int)cudaGetLastError())) return err;
      const int64_t heads = bcs * H;
      ssd::bwd_final_kernel<<<(unsigned)((heads * 32 + 127) / 128), 128, 0, s>>>(
          args, (const float*)pvec, heads, nc, H, wa.nt);
    } else {
      err = ssd::switch_dims<ssd::FmaB>(hp, N, args, Bt, nc, H, s);
      if (err != 0) return err;
      ssd::bwd_reduce_kernel<float><<<grid, 256, 0, s>>>((const float*)pdb, (const float*)pdc,
                                                        (float*)db, (float*)dc, rows, Q, G, N,
                                                        H, H / G);
    }
    if ((err = (int)cudaGetLastError())) return err;
  }
  ssd::bwd_da_kernel<<<1, 256, 0, s>>>((const float*)pda, (float*)da, bcs, H);
  return (int)cudaGetLastError();
}

// The bf16 backward's main kernel's launch geometry for these dims and R
// heads a slice (out[4], see ssd::WgGrid).
extern "C" int ssd_chunk_bwd_grid(int Bt, int nc, int Q, int H, int G, int hp, int N, int R,
                                  int* out) {
  if (Q < 1 || Q > ssd::QMAX || G < 1 || H % G || R < 1 || R > ssd::SLICE_HEADS ||
      (H / G) % R)
    return (int)cudaErrorInvalidValue;
  const int nt = (Q + ssd::BT - 1) / ssd::BT;
  return ssd::switch_dims<ssd::WgGrid>(hp, N, Bt * nc * G * (H / G / R) * nt, nt, out);
}
