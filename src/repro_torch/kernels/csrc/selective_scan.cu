// Mamba-1 selective scan for Hopper (sm_90a): a chunk-parallel scan over L.
//
// Replaces the Pallas TPU kernel `selective_scan` / `_scan_kernel` of
// src/repro/kernels/selective_scan.py:31-114:
//   x_t = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t,   y_t = <x_t, C_t> + D * u_t,
// u, dt (B,L,Di) and Bm, Cm (B,L,N) in the model's dtype, A (Di,N) and D (Di,)
// in f32; the state is f32 and starts at zero; y is cast to u's dtype.
//
// Bound.  By bytes on paper (u, dt and y at falcon-mamba's prefill shape,
// (1,4096,8192) bf16, are ~200 MB: 0.06 ms at 3.35 TB/s); in practice by the
// exps: every one of the B*L*Di*N state updates needs one exp (537 M at that
// shape), and an SM issues 16 a clock (~0.13 ms over 132 SMs).  A walk of
// all of L per channel, as the TPU kernel's sequential grid axis over time
// chunks does, fills only B*Di/d_block SMs and waits on each step's chain.
//
// Design: the plan's `chunk` is the unit of parallelism over L, in three
// launches on one stream (deterministic; no block waits on another):
//   1. chunk pass, grid (B, Di/d_block, L/chunk - 1), one thread a channel
//      with its N <= 16 states in registers: each chunk but the last is
//      scanned from a zero state; the thread writes the chunk's end state
//      h_c and sum(dt) over the chunk to the scratch;
//   2. carry pass, one thread a (b, n, channel): folds over the chunks in
//      order, carry <- exp(A * sum(dt)_c) * carry + h_c, overwriting h_c in
//      place with the state at the end of chunk c (the carry-in of c + 1);
//   3. output pass, grid (B, Di/d_block, L/chunk): each chunk scanned again
//      from its carry-in, writing y.  (One chunk, chunk == L: this pass
//      alone, from zero.)
// So the exps are taken twice (the recompute), and the passes move u and dt
// twice, y once and the scratch (B * L/chunk * Di * (N+1) f32, ~17 MB at
// chunk 128) three times.  The exps run on `ex2.approx.ftz` with A * log2(e)
// folded once a thread (as in csrc/flash_attention.cu).  The output's
// <h, C> is summed in four chains, and the kernel is held to 64 registers
// so that four 256-thread blocks share an SM: the SFU's exps then have
// warps enough to overlap (scripts/torch_kernel_variants.py times one
// chain at 68 registers, three blocks an SM).  B and C of a chunk
// are staged in shared memory as f32 (read as broadcasts); u and dt are
// read straight from device memory, one coalesced row a step.  A one-launch
// form with a decoupled look-back was not taken: it needs chunks to take
// tickets in order and to wait on their predecessors' carries, and the
// carry pass here costs a few percent of the whole.
//
// For the reverse scan of the gradient (ROADMAP A12) the same layout
// serves: the scratch after pass 2 holds each chunk's carry-in, so a
// backward can rerun any chunk's forward from it, run the adjoint
// recurrence backwards within the chunk from a zero adjoint, and fold the
// adjoint carries over the chunks in reverse order with the same
// exp(A * sum(dt)_c) decays.
//
// The tile is the caller's (the plan's): chunk, d_block (= the block's
// threads) and the shared-memory size come from kernels/geometry.py and the
// launcher checks them against its own arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;  // d_block: one thread per channel
constexpr int kMaxN = 16;         // states per channel in registers
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

int smem_bytes_for(int chunk, int N) { return 2 * chunk * N * static_cast<int>(sizeof(float)); }

// Scratch layout: states [B][nC][N][Di] f32 (chunk end states, then carries),
// then dtsum [B][nC][Di] f32.
__device__ __forceinline__ long long state_at(int b, int c, int n, int d, int nC, int N, int Di) {
  return ((static_cast<long long>(b) * nC + c) * N + n) * Di + d;
}

// Passes 1 (OUT = false) and 3 (OUT = true).  NF: N fixed at compile time
// (16, falcon-mamba's), or 0 for any N <= 16.
template <typename T, bool OUT, int NF>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers: 4 blocks of 256 an SM
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D, T* __restrict__ y,
                      float* __restrict__ states, float* __restrict__ dtsum, int L, int Di, int Nrt,
                      int chunk, int nC) {
  extern __shared__ __align__(16) float smem[];
  const int N = NF ? NF : Nrt;
  float* Bs = smem;              // B [chunk][N] f32
  float* Cs = smem + chunk * N;  // C [chunk][N] f32 (output pass)
  const int b = blockIdx.x, c = blockIdx.z;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * chunk;

  for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) {
    Bs[i] = to_f32(Bm[row0 * N + i]);
    if constexpr (OUT) Cs[i] = to_f32(Cm[row0 * N + i]);
  }
  float a2[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a2[n] = n < N ? A[static_cast<long long>(d) * N + n] * kLog2e : 0.f;
    // the carry-in of chunk c is the state at the end of chunk c - 1 (pass 2)
    h[n] = (OUT && c > 0 && n < N) ? states[state_at(b, c - 1, n, d, nC, N, Di)] : 0.f;
  }
  const float dskip = OUT ? D[d] : 0.f;
  __syncthreads();

  const T* up = u + row0 * Di + d;
  const T* tp = dt + row0 * Di + d;
  T* yp = y + row0 * Di + d;
  float sdt = 0.f;
#pragma unroll 4
  for (int t = 0; t < chunk; ++t) {
    const float dv = to_f32(tp[static_cast<long long>(t) * Di]);
    const float uv = to_f32(up[static_cast<long long>(t) * Di]);
    const float du = dv * uv;
    const float* bt = Bs + t * N;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one of N dependent FMAs
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < N) {
        h[n] = fmaf(ex2(dv * a2[n]), h[n], du * bt[n]);
        if constexpr (OUT) acc[n & 3] = fmaf(h[n], Cs[t * N + n], acc[n & 3]);
      }
    }
    if constexpr (OUT) {
      const float cx = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yp[static_cast<long long>(t) * Di] = from_f32<T>(fmaf(uv, dskip, cx));
    } else {
      sdt += dv;
    }
  }
  if constexpr (!OUT) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) states[state_at(b, c, n, d, nC, N, Di)] = h[n];
    dtsum[(static_cast<long long>(b) * nC + c) * Di + d] = sdt;
  }
}

// Pass 2: one thread a (b, n, channel), the chunks in order.  Slot c of
// `states` holds h_c (chunk c's end state from zero) and becomes the state
// at the end of chunk c.
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_carry_kernel(const float* __restrict__ A, float* __restrict__ states,
                            const float* __restrict__ dtsum, int Bsz, int Di, int N, int nC) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(Bsz) * N * Di) return;
  const int d = static_cast<int>(idx % Di);
  const int n = static_cast<int>((idx / Di) % N);
  const int b = static_cast<int>(idx / (static_cast<long long>(Di) * N));
  const float a2 = A[static_cast<long long>(d) * N + n] * kLog2e;
  float carry = 0.f;
  for (int c = 0; c < nC - 1; ++c) {
    const long long at = state_at(b, c, n, d, nC, N, Di);
    carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + c) * Di + d]), carry, states[at]);
    states[at] = carry;
  }
}

template <typename T, bool OUT, int NF>
cudaError_t pass(dim3 grid, int threads, int smem, cudaStream_t s, const void* u, const void* dt,
                 const float* A, const void* Bm, const void* Cm, const float* D, void* y,
                 float* states, float* dtsum, int L, int Di, int N, int chunk, int nC) {
  static int smem_set = 0;
  if (smem > smem_set) {  // above 48 KB only after this attribute
    const cudaError_t e = cudaFuncSetAttribute(selective_scan_kernel<T, OUT, NF>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  selective_scan_kernel<T, OUT, NF><<<grid, threads, smem, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), states, dtsum, L, Di, N, chunk, nC);
  return cudaGetLastError();
}

template <typename T, int NF>
cudaError_t scan(int Bsz, int L, int Di, int N, int chunk, int d_block, int smem, cudaStream_t s,
                 const void* u, const void* dt, const float* A, const void* Bm, const void* Cm,
                 const float* D, void* y, float* scratch) {
  const int nC = L / chunk;
  float* states = scratch;
  float* dtsum = scratch ? scratch + static_cast<long long>(Bsz) * nC * N * Di : nullptr;
  if (nC > 1) {
    cudaError_t e = pass<T, false, NF>(dim3(Bsz, Di / d_block, nC - 1), d_block, smem, s, u, dt, A,
                                       Bm, Cm, D, y, states, dtsum, L, Di, N, chunk, nC);
    if (e != cudaSuccess) return e;
    const long long total = static_cast<long long>(Bsz) * N * Di;
    selective_scan_carry_kernel<<<static_cast<unsigned>((total + kCarryThreads - 1) / kCarryThreads),
                                  kCarryThreads, 0, s>>>(A, states, dtsum, Bsz, Di, N, nC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return pass<T, true, NF>(dim3(Bsz, Di / d_block, nC), d_block, smem, s, u, dt, A, Bm, Cm, D, y,
                           states, dtsum, L, Di, N, chunk, nC);
}

template <typename T>
cudaError_t scan_dispatch(int Bsz, int L, int Di, int N, int chunk, int d_block, int smem,
                          cudaStream_t s, const void* u, const void* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D, void* y, float* scratch) {
  if (N == kMaxN)
    return scan<T, kMaxN>(Bsz, L, Di, N, chunk, d_block, smem, s, u, dt, A, Bm, Cm, D, y, scratch);
  return scan<T, 0>(Bsz, L, Di, N, chunk, d_block, smem, s, u, dt, A, Bm, Cm, D, y, scratch);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of u, dt, Bm, Cm and y; A and D are f32).
// chunk and d_block are the tile and smem_bytes the block's shared memory,
// all from kernels/geometry.py; a tile that does not divide (L, Di) or a size
// that disagrees with this file's arithmetic is refused.  scratch: f32, at
// least B * (L/chunk) * Di * (N + 1) floats, allocated by the wrapper (unused,
// and may be null, when chunk == L).  Launches three kernels (one when
// chunk == L) on `stream`; returns cudaGetLastError() after the last.
extern "C" int selective_scan_launch(const void* u, const void* dt, const void* A, const void* Bm,
                                     const void* Cm, const void* D, void* y, void* scratch, int B,
                                     int L, int Di, int N, int chunk, int d_block, int smem_bytes,
                                     int dtype, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || N <= 0 || N > kMaxN || chunk <= 0 || d_block <= 0 ||
      d_block > kMaxThreads || L % chunk || Di % d_block || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes != smem_bytes_for(chunk, N) || (L / chunk > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t e =
      dtype == 1
          ? scan_dispatch<bf16>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af, Bm, Cm, Df, y, sc)
          : scan_dispatch<float>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af, Bm, Cm, Df, y, sc);
  return static_cast<int>(e);
}

extern "C" const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
