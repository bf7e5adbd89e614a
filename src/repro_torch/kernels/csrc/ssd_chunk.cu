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
// ms at 3.35 TB/s.  This version runs the products as fp32 FMAs (67 TFLOP/s
// outside the tensor cores), so in fact it is bound by operations, about 1 ms
// at best; tensor cores come with a later version.
// What the design does about it: the TPU kernel holds the whole (Q,Q) decay
// and score matrices in VMEM; in fp32 at Q = 256 they are 256 KB each, more
// than an SM has (227 KB).  Here a block owns one chunk and walks it in 64-row
// tiles: for a row tile i it keeps C_i in shared memory and streams the column
// tiles j <= i (tiles above the diagonal are never visited), forming
// C_i B_j^T . L_ij for one 64 x 64 tile at a time in registers and shared
// memory and adding (tile) @ (x dt)_j into y_i's registers.  exp is evaluated
// only where i >= j, so no exponent is ever positive and nothing overflows.
// The last row tile visits every column tile once, and that walk also sums
// the chunk's states, so B and x are read once more only for the earlier row
// tiles (from L2).  cum is a prefix sum over the chunk inside the block (one
// warp).  All products are fp32 FMAs from shared memory for both input types:
// fp32 inputs get IEEE fp32 (as the fp32 tolerance asks), bf16 inputs
// accumulate in fp32.  The kernel reads the model's (batch, chunk, row, head)
// layout through strides, and B/C through a head -> group index, so the
// model's tensors go in without a copy and B/C are not repeated per head.
#include "flash_common.cuh"

namespace ssd {

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

// Rows [r0, r0 + BT) of a (Q, D) matrix into a zero-padded fp32 tile with row
// stride D + 4; each row multiplied by mul[row] when mul is given.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t stride, int r0,
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
template <typename T, int HP, int N>
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

  const T* xp = (const T*)p.x + bb * p.sx[0] + c * p.sx[1] + h * p.sx[3];
  const float* dtp = p.dt + bb * p.sd[0] + c * p.sd[1] + h * p.sd[3];
  const T* bp = (const T*)p.b + bb * p.sb[0] + c * p.sb[1] + g * p.sb[3];
  const T* cp = (const T*)p.c + bb * p.sc[0] + c * p.sc[1] + g * p.sc[3];
  T* yp = (T*)p.y + bb * p.sy[0] + c * p.sy[1] + h * p.sy[3];
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
    load_rows<T, N>(sC, cp, p.sc[2], i0, Q, nullptr);

    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    const int jt_end = last ? nt : it + 1;
    for (int jt = 0; jt < jt_end; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();  // everyone is done with the previous sB, sX
      load_rows<T, N>(sB, bp, p.sb[2], j0, Q, nullptr);
      load_rows<T, HP>(sX, xp, p.sx[2], j0, Q, sDt);
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
        T* row = yp + (int64_t)gi * p.sy[2];
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

template <typename T, int HP, int N>
int launch(const Args& args, int Bt, int nc, int H, cudaStream_t stream) {
  const int QP = (args.Q + BT - 1) / BT * BT;
  const size_t smem = sizeof(float) * smem_floats<HP, N>(QP);
  auto kernel = ssd_chunk_kernel<T, HP, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nc, H, Bt), NT, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, int HP>
int dispatch_n(const Args& args, int N, int Bt, int nc, int H, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, HP, 16>(args, Bt, nc, H, s);
    case 32: return launch<T, HP, 32>(args, Bt, nc, H, s);
    case 64: return launch<T, HP, 64>(args, Bt, nc, H, s);
    case 128: return launch<T, HP, 128>(args, Bt, nc, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& args, int hp, int N, int Bt, int nc, int H, cudaStream_t s) {
  switch (hp) {
    case 16: return dispatch_n<T, 16>(args, N, Bt, nc, H, s);
    case 32: return dispatch_n<T, 32>(args, N, Bt, nc, H, s);
    case 64: return dispatch_n<T, 64>(args, N, Bt, nc, H, s);
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
  if (is_bf16) return ssd::dispatch<__nv_bfloat16>(args, hp, N, Bt, nc, H, s);
  return ssd::dispatch<float>(args, hp, N, Bt, nc, H, s);
}
