// Fused RMSNorm and its backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` / `_kernel` of
// src/repro/kernels/rmsnorm.py:17-58:  y = x * rsqrt(mean(x^2) + eps) * w,
// reduced and scaled in f32 and cast once at the end.  The backward is the
// gradient the JAX package takes with `jax.vjp` of `repro.kernels.ref.rmsnorm`
// (src/repro/kernels/ref.py:108-112), with inv = rsqrt(mean(x^2) + eps)
// recomputed per row and g = gy * w:
//   dx = inv * g - x * inv^3 * mean(x * g),    dw = sum over rows of gy * x * inv.
//
// Bound: bytes.  The forward reads x and writes y once (w once per warp);
// the backward reads x and gy and writes dx once.  Each element costs a few
// floating-point operations, far below the card's ~295 operations a byte.
//
// Design.  A row belongs to one warp, or to a group of G = 2..8 warps when
// one warp would hold more than 4 vectors a thread (d > 1024 in bf16, > 512
// in f32); G is chosen from d at launch.  Each thread loads its part of the
// row once into registers with 16-byte loads and keeps it there packed (8
// bf16 or 4 f32 a register quad).  The f32 sum of squares is reduced with
// warp shuffles only -- no shared memory and no __syncthreads when G = 1 --
// and, for G > 1, across the group's warps through a double-buffered slot in
// shared memory with one __syncthreads a row.  (One warp a row up to d =
// 2048, 8 vectors a thread, takes 144 registers and so one block an SM; two
// warps a row there take 76 registers, three blocks, and less time:
// scripts/torch_kernel_variants.py times both.)  The output x*inv*w is
// computed from the registers and written once.  w is loaded once per warp,
// into registers, and a block of 8 warps walks several rows in a
// grid-stride loop over a grid of about SMs x resident blocks, so w is not
// read again per row.  A width that is not a multiple of the 16-byte vector
// (the ragged path) loads scalars the same way, up to 16 a thread.
//
// The backward keeps the same layout (x, gy and w each in registers, and an
// f32 accumulator of dw for the thread's columns).  dw is reduced
// deterministically, with no atomics: each block sums its groups'
// accumulators through shared memory into one partial row of a scratch
// buffer that the wrapper allocates ([blocks][d] f32), and a second kernel
// sums those rows per column in a fixed order and casts to w's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // a block: 8 warps, 8 / G rows at a time
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// One item of a row: a 16-byte vector (VEC) or one element (the ragged path).
template <typename T, bool VEC>
struct Item {
  static constexpr int W = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements
  using Raw = typename std::conditional<VEC, uint4, T>::type;

  static __device__ __forceinline__ Raw load(const T* p, int idx) {
    return reinterpret_cast<const Raw*>(p)[idx];
  }
  static __device__ __forceinline__ void store(T* p, int idx, const Raw& v) {
    reinterpret_cast<Raw*>(p)[idx] = v;
  }
  static __device__ __forceinline__ float get(const Raw& v, int j) {
    if constexpr (VEC) return to_f32(reinterpret_cast<const T*>(&v)[j]);
    else return to_f32(v);
  }
  static __device__ __forceinline__ void set(Raw& v, int j, float f) {
    if constexpr (VEC) reinterpret_cast<T*>(&v)[j] = from_f32<T>(f);
    else v = from_f32<T>(f);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the G warps of a row group.  MULTI (G > 1): one f32 a warp
// through `slot` (double-buffered by row iteration `it`, so one
// __syncthreads a row suffices); every warp of the block takes part.
template <bool MULTI>
__device__ __forceinline__ float group_sum(float v, float (*slot)[kWarps], int it, int warp,
                                           int group, int G) {
  v = warp_sum(v);
  if constexpr (MULTI) {
    float* s = slot[it & 1];
    if ((threadIdx.x & 31) == 0) s[warp] = v;
    __syncthreads();
    v = 0.f;
    for (int g = 0; g < G; ++g) v += s[group * G + g];
  }
  return v;
}

// ---------------------------------------------------------------------------
// Forward.  NV: items a thread holds (the per-thread register array).
template <typename T, int NV, bool VEC, bool MULTI>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               long long rows, int d, float eps, int G) {
  using I = Item<T, VEC>;
  const int warp = threadIdx.x >> 5;
  const int group = warp / G, gthreads = 32 * G, groups = kWarps / G;
  const int gl = (warp % G) * 32 + (threadIdx.x & 31);  // thread within the row group
  const int nitems = d / I::W;
  __shared__ float slot[MULTI ? 2 : 1][kWarps];

  typename I::Raw wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int idx = k * gthreads + gl;
    if (idx < nitems) wv[k] = I::load(w, idx);
  }
  const float inv_d = 1.f / static_cast<float>(d);
  int it = 0;
  for (long long r0 = static_cast<long long>(blockIdx.x) * groups; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * groups, ++it) {
    const long long row = r0 + group;
    const bool valid = row < rows;
    const T* xr = x + row * d;
    typename I::Raw xv[NV];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = k * gthreads + gl;
      if (valid && idx < nitems) {
        xv[k] = I::load(xr, idx);
#pragma unroll
        for (int j = 0; j < I::W; ++j) {
          const float f = I::get(xv[k], j);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = group_sum<MULTI>(ss, slot, it, warp, group, G);
    const float inv = rsqrtf(ss * inv_d + eps);
    if (!valid) continue;
    T* yr = y + row * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = k * gthreads + gl;
      if (idx < nitems) {
        typename I::Raw out;
#pragma unroll
        for (int j = 0; j < I::W; ++j) I::set(out, j, I::get(xv[k], j) * inv * I::get(wv[k], j));
        I::store(yr, idx, out);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dx for every row, and this block's partial dw row.
template <typename T, int NV, bool VEC, bool MULTI>
__global__ void __launch_bounds__(kThreads)
rmsnorm_backward_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ gy,
                        T* __restrict__ dx, float* __restrict__ partial, long long rows, int d,
                        float eps, int G) {
  using I = Item<T, VEC>;
  extern __shared__ float red[];  // [groups][d]: each group's dw, summed by the block
  const int warp = threadIdx.x >> 5;
  const int group = warp / G, gthreads = 32 * G, groups = kWarps / G;
  const int gl = (warp % G) * 32 + (threadIdx.x & 31);
  const int nitems = d / I::W;
  __shared__ float slot_ss[MULTI ? 2 : 1][kWarps], slot_xg[MULTI ? 2 : 1][kWarps];

  typename I::Raw wv[NV];
  float acc[NV][I::W];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int idx = k * gthreads + gl;
    if (idx < nitems) wv[k] = I::load(w, idx);
#pragma unroll
    for (int j = 0; j < I::W; ++j) acc[k][j] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  int it = 0;
  for (long long r0 = static_cast<long long>(blockIdx.x) * groups; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * groups, ++it) {
    const long long row = r0 + group;
    const bool valid = row < rows;
    typename I::Raw xv[NV], gv[NV];
    float ss = 0.f, xg = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = k * gthreads + gl;
      if (valid && idx < nitems) {
        xv[k] = I::load(x + row * d, idx);
        gv[k] = I::load(gy + row * d, idx);
#pragma unroll
        for (int j = 0; j < I::W; ++j) {
          const float xf = I::get(xv[k], j);
          ss = fmaf(xf, xf, ss);
          xg = fmaf(xf, I::get(gv[k], j) * I::get(wv[k], j), xg);
        }
      }
    }
    ss = group_sum<MULTI>(ss, slot_ss, it, warp, group, G);
    xg = group_sum<MULTI>(xg, slot_xg, it, warp, group, G);
    if (!valid) continue;
    const float inv = rsqrtf(ss * inv_d + eps);
    const float c = inv * inv * inv * (xg * inv_d);
    T* dxr = dx + row * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = k * gthreads + gl;
      if (idx < nitems) {
        typename I::Raw out;
#pragma unroll
        for (int j = 0; j < I::W; ++j) {
          const float xf = I::get(xv[k], j), gf = I::get(gv[k], j);
          I::set(out, j, inv * (gf * I::get(wv[k], j)) - xf * c);
          acc[k][j] = fmaf(xf * inv, gf, acc[k][j]);
        }
        I::store(dxr, idx, out);
      }
    }
  }
  // the block's dw: its groups' accumulators summed in group order
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int idx = k * gthreads + gl;
    if (idx < nitems) {
#pragma unroll
      for (int j = 0; j < I::W; ++j) red[group * d + idx * I::W + j] = acc[k][j];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[g * d + col];
    partial[static_cast<long long>(blockIdx.x) * d + col] = s;
  }
}

// dw[col] = sum over the blocks' partial rows, in a fixed order: 8 slices of
// rows a column, then the slices in order.
constexpr int kDwCols = 32, kDwSlices = 8;

template <typename T>
__global__ void __launch_bounds__(kDwCols * kDwSlices)
rmsnorm_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks, int d) {
  __shared__ float s[kDwSlices][kDwCols];
  const int cx = threadIdx.x % kDwCols, sy = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + cx;
  float acc = 0.f;
  if (col < d)
    for (int b = sy; b < blocks; b += kDwSlices) acc += partial[static_cast<long long>(b) * d + col];
  s[sy][cx] = acc;
  __syncthreads();
  if (sy == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kDwSlices; ++k) t += s[k][cx];
    dw[col] = from_f32<T>(t);
  }
}

// ---------------------------------------------------------------------------
// Host side: the row group and register array chosen from d.
constexpr int kVecMaxItems = 8;  // 16-byte vectors a thread holds at most (G = 8)
constexpr int kVecTarget = 4;    // widen the group past 4 vectors a thread
constexpr int kScalarItems = 16; // elements a thread holds on the ragged path

struct Shape {
  int G, NV;  // warps a row, items a thread (0: the row is too wide)
};

Shape choose(int nitems, bool vec) {
  const int cap = vec ? kVecMaxItems : kScalarItems;
  const int target = vec ? kVecTarget : kScalarItems;
  int G = 1;
  while (G < kWarps && nitems > 32 * G * target) G *= 2;
  const int per = (nitems + 32 * G - 1) / (32 * G);
  if (per > cap) return {0, 0};
  if (!vec) return {G, kScalarItems};
  return {G, per <= 2 ? 2 : per <= 4 ? 4 : 8};  // 8 only at G = 8
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Blocks resident on the card at once, for one kernel (cached per kernel).
template <typename K>
int resident_blocks(K kernel, int smem, int* cache) {
  if (*cache <= 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    *cache = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  return *cache;
}

long long grid_for(long long rows, int groups, int resident) {
  const long long need = (rows + groups - 1) / groups;
  return need < resident ? need : resident;
}

template <typename T, int NV, bool VEC, bool MULTI>
cudaError_t forward(const void* x, const void* w, void* y, long long rows, int d, float eps, int G,
                    cudaStream_t s) {
  static int resident = 0;
  const auto kernel = rmsnorm_kernel<T, NV, VEC, MULTI>;
  const long long grid = grid_for(rows, kWarps / G, resident_blocks(kernel, 0, &resident));
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), rows, d, eps, G);
  return cudaGetLastError();
}

template <typename T, int NV, bool VEC, bool MULTI>
cudaError_t backward(const void* x, const void* w, const void* gy, void* dx, void* dw,
                     float* partial, int partial_rows, long long rows, int d, float eps, int G,
                     cudaStream_t s) {
  static int resident = 0, smem_set = 0;
  const auto kernel = rmsnorm_backward_kernel<T, NV, VEC, MULTI>;
  const int smem = (kWarps / G) * d * static_cast<int>(sizeof(float));
  if (smem > smem_set) {  // above 48 KB only after this attribute
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
    resident = 0;
  }
  long long grid = grid_for(rows, kWarps / G, resident_blocks(kernel, smem, &resident));
  if (grid > partial_rows) grid = partial_rows;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(gy),
      static_cast<T*>(dx), partial, rows, d, eps, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw_kernel<T><<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0, s>>>(
      partial, static_cast<T*>(dw), static_cast<int>(grid), d);
  return cudaGetLastError();
}

// The instantiation for (T, vec, NV, G > 1); the same list for both directions.
#define RMSNORM_DISPATCH(T, CALL)                                                         \
  if (vec) {                                                                              \
    if (sh.G > 1) {                                                                       \
      if (sh.NV == 4) return CALL(T, 4, true, true);                                      \
      if (sh.NV == 8) return CALL(T, 8, true, true);                                      \
    } else {                                                                              \
      if (sh.NV == 2) return CALL(T, 2, true, false);                                     \
      if (sh.NV == 4) return CALL(T, 4, true, false);                                     \
    }                                                                                     \
  } else {                                                                                \
    if (sh.G > 1) return CALL(T, kScalarItems, false, true);                              \
    return CALL(T, kScalarItems, false, false);                                           \
  }                                                                                       \
  return cudaErrorInvalidValue;

#define FWD_CALL(T, NV, VEC, MULTI) forward<T, NV, VEC, MULTI>(x, w, y, rows, d, eps, sh.G, s)
#define BWD_CALL(T, NV, VEC, MULTI) \
  backward<T, NV, VEC, MULTI>(x, w, gy, dx, dw, partial, partial_rows, rows, d, eps, sh.G, s)

template <typename T>
cudaError_t forward_dispatch(const void* x, const void* w, void* y, long long rows, int d,
                             float eps, bool vec, Shape sh, cudaStream_t s) {
  RMSNORM_DISPATCH(T, FWD_CALL)
}

template <typename T>
cudaError_t backward_dispatch(const void* x, const void* w, const void* gy, void* dx, void* dw,
                              float* partial, int partial_rows, long long rows, int d, float eps,
                              bool vec, Shape sh, cudaStream_t s) {
  RMSNORM_DISPATCH(T, BWD_CALL)
}

int items(int d, int dtype, int vec) { return vec ? d / (dtype == 1 ? 8 : 4) : d; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y alike).  vec: 1 when x and w
// are 16-byte aligned and d is a multiple of the vector width (the wrapper
// checks; y is fresh from the allocator).  A row wider than the registers
// hold (see choose) is refused.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = choose(items(d, dtype, vec), vec);
  if (!sh.G) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 1 ? forward_dispatch<bf16>(x, w, y, rows, d, eps, vec, sh, s)
                                   : forward_dispatch<float>(x, w, y, rows, d, eps, vec, sh, s);
  return static_cast<int>(e);
}

// The backward: dx (rows, d) in x's dtype and dw (d,) in w's (the same),
// through `partial`, a f32 scratch of partial_rows x d that the wrapper
// allocates (the grid is capped at partial_rows blocks).  Two launches.
extern "C" int rmsnorm_backward_launch(const void* x, const void* w, const void* gy, void* dx,
                                       void* dw, void* partial, int partial_rows, long long rows,
                                       int d, float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || partial_rows <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = choose(items(d, dtype, vec), vec);
  if (!sh.G) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const cudaError_t e =
      dtype == 1 ? backward_dispatch<bf16>(x, w, gy, dx, dw, p, partial_rows, rows, d, eps, vec, sh, s)
                 : backward_dispatch<float>(x, w, gy, dx, dw, p, partial_rows, rows, d, eps, vec, sh, s);
  return static_cast<int>(e);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
