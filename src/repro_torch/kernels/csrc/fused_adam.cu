// Fused AdamW step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_adam_kernel` of
// src/repro/kernels/fused_adam.py (called from `fused_adam`): one pass over a
// flat leaf that reads p, g, m, v and writes p, m, v,
//   m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g^2
//   p' = p - lr ((m' / c1) / (sqrt(v' / c2) + eps) + wd p)
//   c1 = 1 - b1^count                 c2 = 1 - b2^count
// all in fp32, each store in its buffer's dtype.
//
// What bounds it on this card: bytes.  About 15 FLOPs per element against 22
// bytes moved (bf16 p and g, fp32 m and v: p, m, v read and written, g read),
// far below the balance point; a 1.45 B-parameter model moves 32 GB a step,
// 9.5 ms at 3.35 TB/s.
// What the design does about it: one read of every input and one write of
// every output, in place (p, m, v are updated where they lie, so the step
// allocates nothing); each thread handles 4 elements spaced a block apart, so
// every load is coalesced and 4 of them are in flight per thread.  `lr`, the
// betas, eps and the weight decay are runtime arguments (a new learning rate
// each step costs nothing), and the step count is read from the int32 device
// tensor inside the kernel, as the TPU kernel reads `cnt_ref`, so the host
// never waits for the device.  1 - b1 and 1 - b2 come from the host, rounded
// once from double, as the plain version's Python constants are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adam {

constexpr int NT = 256;
constexpr int ILP = 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd;
};

template <typename TP, typename TG, typename TS>
__global__ void __launch_bounds__(NT)
adam_kernel(TP* __restrict__ p, const TG* __restrict__ g, TS* __restrict__ m,
            TS* __restrict__ v, const int* __restrict__ count, int64_t n, Hyper h) {
  const float cnt = (float)(*count);
  const float c1 = 1.f - powf(h.b1, cnt);
  const float c2 = 1.f - powf(h.b2, cnt);
  const int64_t stride = (int64_t)gridDim.x * NT * ILP;
  for (int64_t base = (int64_t)blockIdx.x * NT * ILP + threadIdx.x; base < n;
       base += stride) {
    float pv[ILP], gv[ILP], mv[ILP], vv[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t i = base + (int64_t)k * NT;
      if (i < n) {
        pv[k] = ld(p + i);
        gv[k] = ld(g + i);
        mv[k] = ld(m + i);
        vv[k] = ld(v + i);
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t i = base + (int64_t)k * NT;
      if (i < n) {
        // every operation rounded on its own (no contraction into FMAs), in
        // the plain version's order, so that m and v agree bit for bit
        const float m2 = __fadd_rn(__fmul_rn(h.b1, mv[k]), __fmul_rn(h.omb1, gv[k]));
        const float v2 =
            __fadd_rn(__fmul_rn(h.b2, vv[k]), __fmul_rn(h.omb2, __fmul_rn(gv[k], gv[k])));
        const float upd =
            __fdiv_rn(__fdiv_rn(m2, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), h.eps));
        const float p2 = __fsub_rn(pv[k], __fmul_rn(h.lr, __fadd_rn(upd, __fmul_rn(h.wd, pv[k]))));
        st(p + i, p2);
        st(m + i, m2);
        st(v + i, v2);
      }
    }
  }
}

template <typename TP, typename TG, typename TS>
int launch(void* p, const void* g, void* m, void* v, const int* count, int64_t n, Hyper h,
           cudaStream_t stream) {
  // enough blocks to fill the card several times over; the loop covers the rest
  const int64_t want = (n + (int64_t)NT * ILP - 1) / ((int64_t)NT * ILP);
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adam_kernel<TP, TG, TS><<<blocks, NT, 0, stream>>>((TP*)p, (const TG*)g, (TS*)m, (TS*)v,
                                                     count, n, h);
  return (int)cudaGetLastError();
}

}  // namespace adam

// p, g, m, v: n contiguous elements each; count: one int32 on the device.
// p_bf16 / g_bf16 / s_bf16 select bf16 (1) or fp32 (0) for p, g and m/v.
extern "C" int fused_adam(void* p, const void* g, void* m, void* v, const void* count,
                          long long n, float lr, float b1, float b2, float omb1, float omb2,
                          float eps, float wd, int p_bf16, int g_bf16, int s_bf16,
                          void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const adam::Hyper h{lr, b1, b2, omb1, omb2, eps, wd};
  const int* c = (const int*)count;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  switch (p_bf16 * 4 + g_bf16 * 2 + s_bf16) {
    case 0: return adam::launch<float, float, float>(p, g, m, v, c, n, h, s);
    case 1: return adam::launch<float, float, bf>(p, g, m, v, c, n, h, s);
    case 2: return adam::launch<float, bf, float>(p, g, m, v, c, n, h, s);
    case 3: return adam::launch<float, bf, bf>(p, g, m, v, c, n, h, s);
    case 4: return adam::launch<bf, float, float>(p, g, m, v, c, n, h, s);
    case 5: return adam::launch<bf, float, bf>(p, g, m, v, c, n, h, s);
    case 6: return adam::launch<bf, bf, float>(p, g, m, v, c, n, h, s);
    case 7: return adam::launch<bf, bf, bf>(p, g, m, v, c, n, h, s);
  }
  return (int)cudaErrorInvalidValue;
}
