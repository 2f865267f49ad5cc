// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `selective_scan` / `_scan_kernel` of
// src/repro/kernels/selective_scan.py:31-114:
//   x_t = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t,   y_t = <x_t, C_t> + D * u_t,
// u, dt (B,L,Di) and Bm, Cm (B,L,N) in the model's dtype, A (Di,N) and D (Di,)
// in f32; the state is f32 and starts at zero; y is cast to u's dtype.
//
// Bound: by bytes on paper (u, dt and y at falcon-mamba's prefill shape,
// (1,4096,8192) bf16, are ~200 MB: 0.06 ms at 3.35 TB/s), but in practice by
// the sequential dependence over L: each of the B*L*Di*N state updates needs
// one exp (537 M at that shape; every SM issues 16 a clock), and the grid has
// only B*Di/d_block blocks (32 at d_block = 256) to spread them over, each
// stepping through all of L in turn with 8 warps.  On an H100 (700 W) the
// kernel takes 3.7 ms there, seven times what those exps cost on 32 SMs: it
// is bound by the latency of each step's chain, not by the SFU's rate.
// Design: the TPU kernel carried the (d_block, N) state in VMEM across a
// sequential grid axis of time chunks; here one block per (batch, d-block)
// loops over all of L itself, one thread per channel holding its N (at most
// 16) states and its row of A in registers, zeroed once per (batch, d-block).
// Each chunk of `chunk` time steps stages u and dt ([chunk][d_block]) and B,
// C ([chunk][N]) in shared memory with coalesced loads; the steps then read
// them from there (B and C as broadcasts) and write y straight to device
// memory, one coalesced row a step.  Splitting N across lanes (more warps to
// hide that latency), an FMA-pipe exp and a chunked parallel scan over L are
// left to the PRs that make the scan fast.
//
// The tile is the caller's (the plan's): chunk, d_block (= the block's
// threads) and the shared-memory size come from kernels/geometry.py and the
// launcher checks them against its own arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;  // d_block: one thread per channel
constexpr int kMaxN = 16;         // states per channel in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

int smem_bytes_for(int chunk, int d_block, int N, int esize) {
  return (2 * chunk * d_block + 2 * chunk * N) * esize;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D, T* __restrict__ y,
                      int L, int Di, int N, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int db = blockDim.x;
  T* Us = reinterpret_cast<T*>(smem_raw);  // u  [chunk][d_block]
  T* Ts = Us + chunk * db;                  // dt [chunk][d_block]
  T* Bs = Ts + chunk * db;                  // B  [chunk][N]
  T* Cs = Bs + chunk * N;                   // C  [chunk][N]

  const int b = blockIdx.x, ch = threadIdx.x;
  const int d0 = blockIdx.y * db, dch = d0 + ch;
  const long long row0 = static_cast<long long>(b) * L;  // first time row of batch b
  const T* ub = u + row0 * Di + d0;
  const T* tb = dt + row0 * Di + d0;
  const T* bb = Bm + row0 * N;
  const T* cb = Cm + row0 * N;
  T* yb = y + row0 * Di + dch;

  float a[kMaxN], x[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) a[n] = n < N ? A[static_cast<long long>(dch) * N + n] : 0.f;
  for (int n = 0; n < kMaxN; ++n) x[n] = 0.f;  // the state starts at zero, once per (batch, d-block)
  const float dskip = D[dch];

  for (int t0 = 0; t0 < L; t0 += chunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int idx = ch; idx < chunk * db; idx += db) {  // thread ch loads column ch
      const long long off = static_cast<long long>(t0 + idx / db) * Di + idx % db;
      Us[idx] = ub[off];
      Ts[idx] = tb[off];
    }
    for (int idx = ch; idx < chunk * N; idx += db) {
      Bs[idx] = bb[static_cast<long long>(t0) * N + idx];
      Cs[idx] = cb[static_cast<long long>(t0) * N + idx];
    }
    __syncthreads();

    for (int t = 0; t < chunk; ++t) {
      const float uv = to_f32(Us[t * db + ch]), dv = to_f32(Ts[t * db + ch]);
      const float du = dv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          x[n] = fmaf(expf(dv * a[n]), x[n], du * to_f32(Bs[t * N + n]));
          acc = fmaf(x[n], to_f32(Cs[t * N + n]), acc);
        }
      }
      yb[static_cast<long long>(t0 + t) * Di] = from_f32<T>(fmaf(uv, dskip, acc));
    }
  }
}

template <typename T>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream, const void* u,
                   const void* dt, const float* A, const void* Bm, const void* Cm, const float* D,
                   void* y, int L, int Di, int N, int chunk) {
  cudaError_t e = cudaFuncSetAttribute(selective_scan_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  selective_scan_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), L, Di, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of u, dt, Bm, Cm and y; A and D are f32).
// chunk and d_block are the tile and smem_bytes the block's shared memory,
// all from kernels/geometry.py; a tile that does not divide (L, Di) or a size
// that disagrees with this file's arithmetic is refused.  Returns
// cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(const void* u, const void* dt, const void* A, const void* Bm,
                                     const void* Cm, const void* D, void* y, int B, int L, int Di,
                                     int N, int chunk, int d_block, int smem_bytes, int dtype,
                                     void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || N <= 0 || N > kMaxN || chunk <= 0 || d_block <= 0 ||
      d_block > kMaxThreads || L % chunk || Di % d_block || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes != smem_bytes_for(chunk, d_block, N, dtype == 1 ? 2 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, Di / d_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const cudaError_t e =
      dtype == 1 ? launch<bf16>(grid, d_block, smem_bytes, s, u, dt, Af, Bm, Cm, Df, y, L, Di, N, chunk)
                 : launch<float>(grid, d_block, smem_bytes, s, u, dt, Af, Bm, Cm, Df, y, L, Di, N, chunk);
  return static_cast<int>(e);
}

extern "C" const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
