// Rowwise symmetric int8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_quant_kernel` (src/repro/kernels/quantize.py:17,
// `quantize_int8` at :36) and `_dequant_kernel` (:26, `dequantize_int8` at :65):
//   scale = amax / 127 (1 where amax == 0),  q = clip(rint(x / scale), -127, 127),
//   x' = q * scale.
//
// Bound: bytes.  Quantize reads x once and writes q and one scale per row;
// dequantize reads q and the scales once and writes x'.  A few operations an
// element, far below the card's ~295 operations per byte.
//
// Design: one warp per row, eight rows a block of 256 threads, any number of
// rows (no divisibility: the TPU's `block_rows` was a tiling artefact).  The
// first pass reads the row with 16-byte vector loads where the row width and
// the pointers allow it, reduces |x| to its max in registers and by warp
// shuffles; the second pass reads the row again (from L1/L2: a 1024-wide f32
// row is 4 KiB) and writes q, four bytes a lane at a time where it can.  A
// ragged width takes the scalar loop; nothing is padded.  The numerics are
// the oracle's bit for bit: the scale is a true f32 division `amax / 127.0f`
// and `x / scale` a true IEEE division (`__fdiv_rn`; never a multiply by a
// reciprocal, which moves the ties), rounded half to even with `rintf`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int8_t quant_one(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));  // half to even, as jnp.round
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                long long rows, int cols, int vec) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load: 4 f32 or 8 bf16
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * cols;
  int8_t* qr = q + row * cols;

  float amax = 0.f;
  if (vec) {
    for (int i = lane * VEC; i < cols; i += 32 * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(to_f32(e[j])));
    }
  } else {
    for (int i = lane; i < cols; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  }
  amax = warp_max(amax);
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  if (lane == 0) scale[row] = s;

  if (vec) {
    for (int i = lane * VEC; i < cols; i += 32 * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint32_t packed[VEC / 4] = {};  // four int8 to a word, lowest address lowest byte
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        packed[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_one(to_f32(e[j]), s)))
                         << (8 * (j % 4));
      if constexpr (VEC == 4) {
        *reinterpret_cast<uint32_t*>(qr + i) = packed[0];
      } else {
        *reinterpret_cast<uint2*>(qr + i) = make_uint2(packed[0], packed[1]);
      }
    }
  } else {
    for (int i = lane; i < cols; i += 32) qr[i] = quant_one(to_f32(xr[i]), s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  T* __restrict__ out, long long rows, int cols, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int8_t* qr = q + row * cols;
  T* orow = out + row * cols;
  const float s = scale[row];
  if (vec) {  // four int8 a load, four outputs a store
    for (int i = lane * 4; i < cols; i += 32 * 4) {
      const char4 c = *reinterpret_cast<const char4*>(qr + i);
      const float v[4] = {c.x * s, c.y * s, c.z * s, c.w * s};
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(orow + i) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(orow + i) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  } else {
    for (int i = lane; i < cols; i += 32) orow[i] = from_f32<T>(static_cast<float>(qr[i]) * s);
  }
}

inline dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x).  vec: 1 when x and q are 16-byte
// aligned and cols is a multiple of the vector width (checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int quantize_int8_launch(const void* x, void* q, void* scale, long long rows,
                                    int cols, int dtype, int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quantize_kernel<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), rows,
        cols, vec);
  } else if (dtype == 1) {
    quantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, cols, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (of the output).  vec: 1 when q and out
// are 16-byte aligned and cols is a multiple of 4 (checked by the caller).
extern "C" int dequantize_int8_launch(const void* q, const void* scale, void* out,
                                      long long rows, int cols, int dtype, int vec,
                                      void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dequantize_kernel<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, cols, vec);
  } else if (dtype == 1) {
    dequantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, cols, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
