// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm.py (called from `rmsnorm`): per row of x (rows, d)
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// with the statistics, the rsqrt and both products in fp32 and one cast on
// store (the kernel's rounding order, not the model's `layers.rmsnorm`).
//
// What bounds it on this card: bytes.  It reads each element of x once and
// writes y once and does about 4 FLOPs per element, some 300 times below the
// card's balance point; at d = 4096, 16384 rows in bf16 the bound is 0.08 ms.
// What the design does about it: one pass over device memory.  A row is held
// in registers between the sum of squares and the store (8 elements a thread
// per 16-byte load, at most 8 loads a thread), so x is read once; a warp
// owns a row for d <= 2048 (the reduction is shuffles only), a block of 256
// threads owns a row above that (one shared-memory step joins the 8 warps).
// Loads and stores are 16 bytes a thread on neighbouring addresses.  The TPU
// kernel's row blocks had to divide the row count; here a block takes the
// rows it is given and masks the last ones, so any row count works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rn {

constexpr int NT = 256;     // threads per block
constexpr int VEC = 8;      // elements per 16-byte (bf16) or 2 x 16-byte (fp32) access
constexpr int MAXV = 8;     // vectors a thread keeps in registers

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// TPR threads own one row (32: a warp; NT: the block).  grid: ceil(rows / (NT/TPR)).
template <typename T, int TPR>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               int64_t rows, int d, float eps) {
  constexpr int RPB = NT / TPR;  // rows per block
  __shared__ float warp_sums[NT / 32];
  const int t = threadIdx.x % TPR;
  const int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR;
  const bool live = row < rows;
  const int nv = d / VEC;  // vectors in a row; vector k of the thread is t + k * TPR
  const T* xr = x + row * d;

  float v[MAXV][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int c = t + k * TPR;
    if (live && c < nv) {
      load8(xr + (int64_t)c * VEC, v[k]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[k][e], v[k][e], ss);
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, s);
  if constexpr (TPR > 32) {
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += warp_sums[w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int c = t + k * TPR;
    if (c < nv) {
      float s8[VEC];
      load8(scale + (int64_t)c * VEC, s8);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = v[k][e] * r * (1.f + s8[e]);
      store8(yr + (int64_t)c * VEC, v[k]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, int64_t rows, int d, float eps,
           cudaStream_t stream) {
  if (d <= 32 * VEC * MAXV) {
    const int64_t blocks = (rows + NT / 32 - 1) / (NT / 32);
    rmsnorm_kernel<T, 32><<<(unsigned)blocks, NT, 0, stream>>>(
        (const T*)x, scale, (T*)y, rows, d, eps);
  } else {
    rmsnorm_kernel<T, NT><<<(unsigned)rows, NT, 0, stream>>>((const T*)x, scale, (T*)y, rows,
                                                               d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace rn

// x, y: (rows, d) contiguous, bf16 or fp32; scale: (d,) fp32.  d must be a
// multiple of 8 and at most NT * 8 * 8 = 16384.  Returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                       float eps, int is_bf16, void* stream) {
  if (d % rn::VEC || d > rn::NT * rn::VEC * rn::MAXV || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (is_bf16)
    return rn::launch<__nv_bfloat16>(x, (const float*)scale, y, rows, d, eps,
                                     (cudaStream_t)stream);
  return rn::launch<float>(x, (const float*)scale, y, rows, d, eps, (cudaStream_t)stream);
}
