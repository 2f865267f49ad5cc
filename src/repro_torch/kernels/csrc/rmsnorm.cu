// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` / `_kernel` of
// src/repro/kernels/rmsnorm.py:17-58:  y = x * rsqrt(mean(x^2) + eps) * w,
// reduced and scaled in f32 and cast once at the end.
//
// Bound: bytes.  Each element is read once and written once and costs about
// three floating-point operations, far below the card's ~295 operations per
// byte.  Design: one block of 256 threads per row; 16-byte vector loads and
// stores where the row width allows it; an f32 sum of squares reduced by warp
// shuffles and then across the block's warps; the row is read a second time
// for the output, from L1/L2 (a 2048-wide bf16 row is 4 KiB), so device
// memory sees one read and one write per element.  A ragged row width takes
// the scalar loop; there is no padding of rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int d, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = y + static_cast<long long>(blockIdx.x) * d;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = threadIdx.x * VEC; i < d; i += kThreads * VEC) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_f32<T>(to_f32(xe[j]) * inv * to_f32(we[j]));
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when x, w and y are 16-byte
// aligned and d is a multiple of the vector width (checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), d,
        eps, vec);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
