// 16-byte vector access shared by the memory-bound kernels (rmsnorm.cu,
// fused_adam.cu): a vector is 8 elements, one 16-byte access in bf16 and two
// in fp32, held in registers as loaded (Raw) and widened to fp32 for the
// arithmetic.  Loads and stores carry the streaming (evict-first) hint:
// these kernels read and write every byte once.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vec16 {

constexpr int VEC = 8;

template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void ld(const float* p, Raw<float>& r) {
  r.a = __ldcs(reinterpret_cast<const float4*>(p));
  r.b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void ld(const __nv_bfloat16* p, Raw<__nv_bfloat16>& r) {
  r.a = __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void zero(Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(Raw<__nv_bfloat16>& r) { r.a = make_uint4(0, 0, 0, 0); }

__device__ __forceinline__ void widen(const Raw<float>& r, float (&v)[VEC]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r, float (&v)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void st(float* p, const float (&v)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  __stcs(reinterpret_cast<uint4*>(p), raw);
}

// one element, for a leaf whose length is not a multiple of VEC
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// streaming multiprocessors of the current device
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

}  // namespace vec16
