// Fused AdamW step for Hopper (sm_90a), over many leaves in one launch.
//
// Replaces the Pallas TPU kernel `_adam_kernel` of
// src/repro/kernels/fused_adam.py (called from `fused_adam`): one pass over
// flat leaves that reads p, g, m, v and writes p, m, v,
//   m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g^2
//   p' = p - lr ((m' / c1) / (sqrt(v' / c2) + eps) + wd p)
//   c1 = 1 - b1^count                 c2 = 1 - b2^count
// all in fp32, each store in its buffer's dtype.
//
// What bounds it on this card: bytes.  About 16 FLOPs per element against 22
// bytes moved (bf16 p and g, fp32 m and v: p, m, v read and written, g read),
// far below the balance point; a 1.45 B-parameter model moves 32 GB a step,
// 9.5 ms at 3.35 TB/s.
// What the design does about it: one read of every input and one write of
// every output, in place (p, m, v are updated where they lie, so the step
// allocates nothing), with few launches and wide accesses.
// * One launch takes up to MAX_LEAVES leaves of one dtype combination: the
//   leaf table (pointers, sizes, each leaf's first chunk) is a kernel
//   parameter, passed by value (__grid_constant__), so it needs no copy to the
//   device and nothing for the stream to order.  A model's step is one launch
//   per dtype combination (bf16 matrices with fp32 state, fp32 vectors).
// * Leaves are cut into chunks of CHUNK elements; a persistent grid (SMs x
//   resident blocks) walks the chunks of all leaves in order, each block
//   moving forward through the table to the leaf of its next chunk.
// * Each thread moves 8 elements an access (16 bytes of bf16, 2 x 16 bytes of
//   fp32) and keeps ILP of them in flight, with the streaming (evict-first)
//   hint: nothing is read twice.  A leaf's last n % 8 elements go one at a
//   time.
// `lr`, the betas, eps and the weight decay are runtime arguments (a new
// learning rate each step costs nothing), and the step count is read from the
// int32 device tensor inside the kernel, as the TPU kernel reads `cnt_ref`, so
// the host never waits for the device.  1 - b1 and 1 - b2 come from the host,
// rounded once from double, as the plain version's Python constants are.
#include <stdint.h>

#include "vec16.cuh"

namespace adam {

using vec16::Raw;
using vec16::VEC;
using vec16::ld;
using vec16::ld1;
using vec16::st;
using vec16::st1;
using vec16::widen;

constexpr int NT = 256;
// accesses a thread keeps in flight: 4 was faster on the H100 than 1 or 2
// (PERF.md)
constexpr int ILP = 4;
constexpr int CHUNK = 1 << 16;   // elements a block takes at a time (a multiple of NT * VEC * ILP)
constexpr int MAX_LEAVES = 64;   // leaves one launch takes

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd;
};

struct Table {
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* m[MAX_LEAVES];
  void* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first[MAX_LEAVES + 1];  // first chunk of each leaf; first[leaves]: chunks of all
  int leaves;
};
// the classic limit of a kernel's parameters
static_assert(sizeof(Table) + sizeof(Hyper) + sizeof(void*) <= 4096, "table too large");
static_assert(CHUNK % (NT * VEC * ILP) == 0, "a full chunk is whole steps of the block");

struct Step {
  Hyper h;
  float c1, c2;
  // every operation rounded on its own (no contraction into FMAs), in the
  // plain version's order, so that p, m and v agree bit for bit
  __device__ __forceinline__ void operator()(float& p, float g, float& m, float& v) const {
    m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
    v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
    const float upd = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
    p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(upd, __fmul_rn(h.wd, p))));
  }
};

// elements [lo, hi) of one leaf, hi - lo a multiple of VEC; FULL: a whole
// chunk, no bounds to test
template <bool FULL, typename TP, typename TG, typename TS>
__device__ __forceinline__ void vectors(TP* __restrict__ p, const TG* __restrict__ g,
                                        TS* __restrict__ m, TS* __restrict__ v, int64_t lo,
                                        int64_t hi, const Step& step) {
  for (int64_t base = lo + (int64_t)threadIdx.x * VEC; base < hi; base += NT * VEC * ILP) {
    Raw<TP> pr[ILP];
    Raw<TG> gr[ILP];
    Raw<TS> mr[ILP], vr[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t i = base + (int64_t)k * NT * VEC;
      if (FULL || i < hi) {
        ld(p + i, pr[k]);
        ld(g + i, gr[k]);
        ld(m + i, mr[k]);
        ld(v + i, vr[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t i = base + (int64_t)k * NT * VEC;
      if (FULL || i < hi) {
        float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
        widen(pr[k], pv);
        widen(gr[k], gv);
        widen(mr[k], mv);
        widen(vr[k], vv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) step(pv[e], gv[e], mv[e], vv[e]);
        st(p + i, pv);
        st(m + i, mv);
        st(v + i, vv);
      }
    }
  }
}

template <typename TP, typename TG, typename TS>
__global__ void __launch_bounds__(NT)
adam_kernel(const __grid_constant__ Table tab, const int* __restrict__ count, Hyper h) {
  const float cnt = (float)(*count);
  const Step step{h, 1.f - powf(h.b1, cnt), 1.f - powf(h.b2, cnt)};
  const int chunks = tab.first[tab.leaves];
  int leaf = 0;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    while (tab.first[leaf + 1] <= ch) ++leaf;  // a block's chunks ascend
    TP* p = static_cast<TP*>(tab.p[leaf]);
    const TG* g = static_cast<const TG*>(tab.g[leaf]);
    TS* m = static_cast<TS*>(tab.m[leaf]);
    TS* v = static_cast<TS*>(tab.v[leaf]);
    const int64_t n = tab.n[leaf];
    const int64_t lo = (int64_t)(ch - tab.first[leaf]) * CHUNK;
    const int64_t hi = n < lo + CHUNK ? n : lo + CHUNK;
    if (hi - lo == CHUNK) {
      vectors<true>(p, g, m, v, lo, hi, step);
    } else {
      const int64_t vend = lo + (hi - lo) / VEC * VEC;
      vectors<false>(p, g, m, v, lo, vend, step);
      for (int64_t i = vend + threadIdx.x; i < hi; i += NT) {
        float pe = ld1(p + i), me = ld1(m + i), ve = ld1(v + i);
        step(pe, ld1(g + i), me, ve);
        st1(p + i, pe);
        st1(m + i, me);
        st1(v + i, ve);
      }
    }
  }
}

template <typename TP, typename TG, typename TS>
int launch(const Table& tab, const int* count, Hyper h, cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, adam_kernel<TP, TG, TS>, NT, 0);
    return n > 0 ? n : 1;
  }();
  const int chunks = tab.first[tab.leaves];
  const int cap = vec16::sm_count() * per_sm;
  const int blocks = chunks < cap ? chunks : cap;
  if (blocks == 0) return 0;
  adam_kernel<TP, TG, TS><<<blocks, NT, 0, stream>>>(tab, count, h);
  return (int)cudaGetLastError();
}

}  // namespace adam

// One AdamW step over `leaves` leaves (1 to MAX_LEAVES), in place.  ptrs:
// 4 x leaves addresses, p, g, m, v of leaf 0, then of leaf 1, ...; sizes: the
// leaves' element counts.  Every address on a 16-byte boundary, every leaf
// contiguous.  count: one int32 on the device.  p_bf16 / g_bf16 / s_bf16
// select bf16 (1) or fp32 (0) for p, g and m/v of every leaf.  One launch.
// Returns cudaGetLastError().
extern "C" int fused_adam(const long long* ptrs, const long long* sizes, int leaves,
                          const void* count, float lr, float b1, float b2, float omb1,
                          float omb2, float eps, float wd, int p_bf16, int g_bf16, int s_bf16,
                          void* stream) {
  if (leaves < 1 || leaves > adam::MAX_LEAVES) return (int)cudaErrorInvalidValue;
  adam::Table tab{};
  long long chunks = 0;
  for (int i = 0; i < leaves; ++i) {
    for (int k = 0; k < 4; ++k)
      if (ptrs[4 * i + k] % 16) return (int)cudaErrorMisalignedAddress;
    if (sizes[i] < 0) return (int)cudaErrorInvalidValue;
    tab.p[i] = (void*)ptrs[4 * i];
    tab.g[i] = (const void*)ptrs[4 * i + 1];
    tab.m[i] = (void*)ptrs[4 * i + 2];
    tab.v[i] = (void*)ptrs[4 * i + 3];
    tab.n[i] = sizes[i];
    tab.first[i] = (int)chunks;
    chunks += (sizes[i] + adam::CHUNK - 1) / adam::CHUNK;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  tab.first[leaves] = (int)chunks;
  tab.leaves = leaves;
  const adam::Hyper h{lr, b1, b2, omb1, omb2, eps, wd};
  const int* c = (const int*)count;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  switch (p_bf16 * 4 + g_bf16 * 2 + s_bf16) {
    case 0: return adam::launch<float, float, float>(tab, c, h, s);
    case 1: return adam::launch<float, float, bf>(tab, c, h, s);
    case 2: return adam::launch<float, bf, float>(tab, c, h, s);
    case 3: return adam::launch<float, bf, bf>(tab, c, h, s);
    case 4: return adam::launch<bf, float, float>(tab, c, h, s);
    case 5: return adam::launch<bf, float, bf>(tab, c, h, s);
    case 6: return adam::launch<bf, bf, float>(tab, c, h, s);
    case 7: return adam::launch<bf, bf, bf>(tab, c, h, s);
  }
  return (int)cudaErrorInvalidValue;
}
