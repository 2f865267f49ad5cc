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
// The backward (selective_scan_backward_launch), at the forward's tile.  With
// a_t = exp(dt_t A), the adjoint of the state is g_t = gy_t C_t + a_{t+1}
// g_{t+1}, and dC_t = sum_d gy_t h_t, dB_t = sum_d g_t dt_t u_t, du_t =
// sum_n g_t dt_t B_t + D gy_t, ddt_t = sum_n g_t (A a_t h_{t-1} + u_t B_t),
// dA = sum_{b,t} g_t dt_t a_t h_{t-1}, dD = sum_{b,t} gy_t u_t.  It reads
// the forward's scratch after pass 2 (each chunk's carry-in) and runs one
// thread a (channel, state): a block of 256 threads is 16 channels of 16
// state lanes and walks its d_block channels 16 at a time, so a thread's
// state is one float and the sums over n are shuffles within 16 lanes.
// Four launches (two when chunk == L), deterministic (no atomics):
//   1. chunk pass, grid (B, Di/d_block, L/chunk - 1): each chunk but the
//      first walks the adjoint back from zero, writing L_c = a_{t0} g_{t0}
//      at its first step t0 and sum(dt) over it;
//   2. carry pass, one thread a (b, n, channel): R_{c-1} = L_c +
//      exp(A sum(dt)_c) R_c from R_last = 0, over the chunks in reverse,
//      R_c written to slot c + 1;
//   3. output pass, grid (B, Di/d_block, L/chunk): each chunk's states are
//      recomputed from its carry-in, checkpointed every 16 steps in shared
//      memory (the recurrence is never inverted: a_t underflows to 0 at large
//      dt), and each 16-step span is recomputed into registers and walked
//      back from R_c, writing du and ddt; dB and dC are summed over the
//      block's channels through per-warp slots folded in a fixed order, and
//      written as one partial row a channel block; dA and dD as one partial
//      a chunk;
//   4. reduce pass: the partials summed over channel blocks (dB, dC) and
//      over batch and chunks (dA, dD).
// Bound: by bytes on paper (u, dt and gy read, du and ddt written: ~0.34 GB
// at (1,4096,8192,16) bf16, 0.10 ms); by the exps in practice, three a state
// update (passes 1 and 3's two walks), 0.128 ms a pass at that shape.
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

// ---------------------------------------------------------------------------
// Backward.  Thread layout: lane n (= threadIdx.x % 16) is state n, the
// block's 16 channels are threadIdx.x / 16; a state n >= N idles with zero
// inputs.  Scratch (f32): the adjoint carries [B][nC][N][Di] and sums of dt
// [B][nC][Di] (when nC > 1), then the partial dB and dC rows [B][L][nblk][N]
// each, then the partial dA [B][nC][N][Di] and dD [B][nC][Di].
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;
constexpr int kBwdLanes = 16;                    // state lanes a channel
constexpr int kBwdCh = kBwdThreads / kBwdLanes;  // channels a pass of the block
constexpr int kBwdStep = 16;                     // steps between checkpoints
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kReduceThreads = 256;

int bwd_smem_bytes_for(int chunk, int N) {
  const int ckpts = (chunk + kBwdStep - 1) / kBwdStep * kBwdThreads;
  return static_cast<int>(sizeof(float)) *
         (4 * chunk * N + 3 * chunk * kBwdCh + ckpts + 2 * kBwdWarps * kBwdStep * kBwdLanes);
}

int bwd_chunk_smem_bytes_for(int chunk, int N) {
  return static_cast<int>(sizeof(float)) * (chunk * N + 2 * chunk * kBwdCh);
}

// [chunk][16 channels] of a (B, L, Di) input from channel d0 on, as f32, zero
// past d_end: one load an element, where the 16 state lanes of a channel
// would each load it
template <typename T>
__device__ __forceinline__ void stage_channels(float* dst, const T* __restrict__ src, long long row0,
                                               int chunk, int Di, int d0, int d_end) {
  for (int i = threadIdx.x; i < chunk * kBwdCh; i += blockDim.x) {
    const int t = i / kBwdCh, d = d0 + i % kBwdCh;
    dst[i] = d < d_end ? to_f32(src[(row0 + t) * Di + d]) : 0.f;
  }
}

// Pass 1: chunk c = blockIdx.z + 1 from a zero adjoint.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
selective_scan_bwd_chunk_kernel(const T* __restrict__ dt, const float* __restrict__ A,
                                const T* __restrict__ Cm, const T* __restrict__ gy,
                                float* __restrict__ adj, float* __restrict__ dtsum, int L, int Di,
                                int N, int chunk, int nC, int d_block) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                     // C [chunk][N]
  float* dts = Cs + chunk * N;          // dt [chunk][16 channels]
  float* gys = dts + chunk * kBwdCh;    // gy [chunk][16 channels]
  const int b = blockIdx.x, c = blockIdx.z + 1;
  const int n = threadIdx.x % kBwdLanes, ch = threadIdx.x / kBwdLanes;
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * chunk;
  for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) Cs[i] = to_f32(Cm[row0 * N + i]);
  const int d_end = (blockIdx.y + 1) * d_block;
  for (int d0 = blockIdx.y * d_block; d0 < d_end; d0 += kBwdCh) {
    __syncthreads();  // the last group's reads are done
    stage_channels(dts, dt, row0, chunk, Di, d0, d_end);
    stage_channels(gys, gy, row0, chunk, Di, d0, d_end);
    __syncthreads();
    const int d = d0 + ch;
    const bool on = d < d_end, st = on && n < N;
    const float a2 = st ? A[static_cast<long long>(d) * N + n] * kLog2e : 0.f;
    float g = 0.f, sdt = 0.f;
#pragma unroll 8
    for (int t = chunk - 1; t >= 0; --t) {
      const float dv = dts[t * kBwdCh + ch];
      g = ex2(dv * a2) * fmaf(gys[t * kBwdCh + ch], n < N ? Cs[t * N + n] : 0.f, g);  // a_t g_t
      sdt += dv;
    }
    if (st) adj[state_at(b, c, n, d, nC, N, Di)] = g;
    if (on && n == 0) dtsum[(static_cast<long long>(b) * nC + c) * Di + d] = sdt;
  }
}

// Pass 2: one thread a (b, n, channel), the chunks in reverse.  Slot c holds
// L_c and becomes R_{c-1}, the adjoint carried into chunk c - 1's end.
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_bwd_carry_kernel(const float* __restrict__ A, float* __restrict__ adj,
                                const float* __restrict__ dtsum, int Bsz, int Di, int N, int nC) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(Bsz) * N * Di) return;
  const int d = static_cast<int>(idx % Di);
  const int n = static_cast<int>((idx / Di) % N);
  const int b = static_cast<int>(idx / (static_cast<long long>(Di) * N));
  const float a2 = A[static_cast<long long>(d) * N + n] * kLog2e;
  float carry = 0.f;  // R_{nC-1}
  for (int c = nC - 1; c >= 1; --c) {
    const long long at = state_at(b, c, n, d, nC, N, Di);
    carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + c) * Di + d]), carry, adj[at]);
    adj[at] = carry;
  }
}

// Pass 3: chunk c = blockIdx.z rerun from its carry-in and walked back.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const T* __restrict__ gy, const float* __restrict__ states,
                          const float* __restrict__ adj, T* __restrict__ du, T* __restrict__ ddt,
                          float* __restrict__ pdB, float* __restrict__ pdC, float* __restrict__ pdA,
                          float* __restrict__ pdD, int L, int Di, int N, int chunk, int nC,
                          int d_block) {
  extern __shared__ __align__(16) float smem[];
  const int nsub = (chunk + kBwdStep - 1) / kBwdStep;
  float* Bs = smem;                       // B [chunk][N]
  float* Cs = Bs + chunk * N;             // C [chunk][N]
  float* sB = Cs + chunk * N;             // dB of the chunk over the block's channels [chunk][N]
  float* sC = sB + chunk * N;             // dC, likewise
  float* us = sC + chunk * N;             // u, dt, gy of the 16 channels in hand [chunk][16]
  float* dts = us + chunk * kBwdCh;
  float* gys = dts + chunk * kBwdCh;
  float* ck = gys + chunk * kBwdCh;       // checkpoints [nsub][threads]
  float* slot = ck + nsub * kBwdThreads;  // per warp and step: [2][warps][kBwdStep][lanes]
  const int b = blockIdx.x, c = blockIdx.z, nblk = gridDim.y;
  const int n = threadIdx.x % kBwdLanes, ch = threadIdx.x / kBwdLanes, warp = threadIdx.x / 32;
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * chunk;
  for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) {
    Bs[i] = to_f32(Bm[row0 * N + i]);
    Cs[i] = to_f32(Cm[row0 * N + i]);
    sB[i] = sC[i] = 0.f;
  }

  const int d_end = (blockIdx.y + 1) * d_block;
  for (int d0 = blockIdx.y * d_block; d0 < d_end; d0 += kBwdCh) {
    __syncthreads();  // the last group's reads are done
    stage_channels(us, u, row0, chunk, Di, d0, d_end);
    stage_channels(dts, dt, row0, chunk, Di, d0, d_end);
    stage_channels(gys, gy, row0, chunk, Di, d0, d_end);
    __syncthreads();
    const int d = d0 + ch;
    const bool on = d < d_end, st = on && n < N;
    const float an = st ? A[static_cast<long long>(d) * N + n] : 0.f;
    const float a2 = an * kLog2e;
    const float dskip = on ? D[d] : 0.f;
    // B_t[n] times dt_t u_t: the state's input at step t (0 for an idle lane)
    auto input = [&](int t) {
      return n < N ? dts[t * kBwdCh + ch] * us[t * kBwdCh + ch] * Bs[t * N + n] : 0.f;
    };
    // the states from the carry-in (the state at the end of chunk c - 1),
    // a checkpoint every kBwdStep steps
    float h = (st && c > 0) ? states[state_at(b, c - 1, n, d, nC, N, Di)] : 0.f;
    for (int s = 0; s < nsub; ++s) {
      ck[s * kBwdThreads + threadIdx.x] = h;
      const int t0 = s * kBwdStep;
      if (chunk - t0 >= kBwdStep) {
#pragma unroll
        for (int t = t0; t < t0 + kBwdStep; ++t) h = fmaf(ex2(dts[t * kBwdCh + ch] * a2), h, input(t));
      } else {
        for (int t = t0; t < chunk; ++t) h = fmaf(ex2(dts[t * kBwdCh + ch] * a2), h, input(t));
      }
    }
    // the adjoint carried into the chunk's end, R_c (slot c + 1 after pass 2)
    float gnext = (st && c < nC - 1) ? adj[state_at(b, c + 1, n, d, nC, N, Di)] : 0.f;
    float dAacc = 0.f, dDacc = 0.f;
    for (int s = nsub - 1; s >= 0; --s) {
      const int t0 = s * kBwdStep, len = min(kBwdStep, chunk - t0);
      float hs[kBwdStep + 1], as[kBwdStep];  // states h_{t-1}, h_t and decays of the span
      hs[0] = ck[s * kBwdThreads + threadIdx.x];
      auto fwd = [&](int i) {
        as[i] = ex2(dts[(t0 + i) * kBwdCh + ch] * a2);
        hs[i + 1] = fmaf(as[i], hs[i], input(t0 + i));
      };
      auto back = [&](int i) {
        const int t = t0 + i;
        const float dv = dts[t * kBwdCh + ch], uv = us[t * kBwdCh + ch], gyv = gys[t * kBwdCh + ch];
        const float bn = n < N ? Bs[t * N + n] : 0.f;
        const float g = fmaf(gyv, n < N ? Cs[t * N + n] : 0.f, gnext);  // g_t
        // over the block's channels: the warp's two, then the warps' slots
        float vB = g * dv * uv, vC = gyv * hs[i + 1];
        vB += __shfl_xor_sync(0xffffffffu, vB, 16);
        vC += __shfl_xor_sync(0xffffffffu, vC, 16);
        if ((threadIdx.x & 16) == 0) {
          slot[(warp * kBwdStep + i) * kBwdLanes + n] = vB;
          slot[((kBwdWarps + warp) * kBwdStep + i) * kBwdLanes + n] = vC;
        }
        // over the states: du and ddt of the channel
        const float gb = g * bn;
        float s_du = gb * dv, s_dt = fmaf(g * an * as[i], hs[i], gb * uv);
#pragma unroll
        for (int off = kBwdLanes / 2; off; off >>= 1) {
          s_du += __shfl_xor_sync(0xffffffffu, s_du, off);
          s_dt += __shfl_xor_sync(0xffffffffu, s_dt, off);
        }
        if (on && n == 0) {
          du[(row0 + t) * Di + d] = from_f32<T>(fmaf(dskip, gyv, s_du));
          ddt[(row0 + t) * Di + d] = from_f32<T>(s_dt);
        }
        dAacc = fmaf(g * dv * as[i], hs[i], dAacc);
        dDacc = fmaf(gyv, uv, dDacc);
        gnext = as[i] * g;  // a_t g_t
      };
      if (len == kBwdStep) {  // a whole span: no guards, so steps overlap
#pragma unroll
        for (int i = 0; i < kBwdStep; ++i) fwd(i);
#pragma unroll
        for (int i = kBwdStep - 1; i >= 0; --i) back(i);
      } else {
#pragma unroll
        for (int i = 0; i < kBwdStep; ++i)
          if (i < len) fwd(i);
#pragma unroll
        for (int i = kBwdStep - 1; i >= 0; --i)
          if (i < len) back(i);
      }
      __syncthreads();
      {  // fold the warps' slots in order: thread (i, lane) owns step t0 + i, state lane
        const int i = threadIdx.x / kBwdLanes, nn = threadIdx.x % kBwdLanes;
        if (i < len && nn < N) {
          float sb = 0.f, sc = 0.f;
          for (int w = 0; w < kBwdWarps; ++w) {
            sb += slot[(w * kBwdStep + i) * kBwdLanes + nn];
            sc += slot[((kBwdWarps + w) * kBwdStep + i) * kBwdLanes + nn];
          }
          sB[(t0 + i) * N + nn] += sb;
          sC[(t0 + i) * N + nn] += sc;
        }
      }
      __syncthreads();
    }
    if (st) pdA[state_at(b, c, n, d, nC, N, Di)] = dAacc;
    if (on && n == 0) pdD[(static_cast<long long>(b) * nC + c) * Di + d] = dDacc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) {
    const long long at = ((row0 + i / N) * nblk + blockIdx.y) * N + i % N;
    pdB[at] = sB[i];
    pdC[at] = sC[i];
  }
}

// Pass 4: dB and dC over the channel blocks, dA and dD over batch and chunks.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(const float* __restrict__ pdB, const float* __restrict__ pdC,
                                 const float* __restrict__ pdA, const float* __restrict__ pdD,
                                 T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
                                 float* __restrict__ dD, int Bsz, int L, int Di, int N, int nC,
                                 int nblk) {
  const long long rows = static_cast<long long>(Bsz) * L * N, states_n = static_cast<long long>(N) * Di;
  const long long total = rows + states_n + Di;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (idx < rows) {
      const long long bt = idx / N;
      const int n = static_cast<int>(idx % N);
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < nblk; ++k) {
        sb += pdB[(bt * nblk + k) * N + n];
        sc += pdC[(bt * nblk + k) * N + n];
      }
      dB[idx] = from_f32<T>(sb);
      dC[idx] = from_f32<T>(sc);
    } else if (idx < rows + states_n) {
      const long long j = idx - rows;
      const int n = static_cast<int>(j / Di), d = static_cast<int>(j % Di);
      float sa = 0.f;
      for (int b = 0; b < Bsz; ++b)
        for (int c = 0; c < nC; ++c) sa += pdA[state_at(b, c, n, d, nC, N, Di)];
      dA[static_cast<long long>(d) * N + n] = sa;
    } else {
      const int d = static_cast<int>(idx - rows - states_n);
      float sd = 0.f;
      for (int b = 0; b < Bsz; ++b)
        for (int c = 0; c < nC; ++c) sd += pdD[(static_cast<long long>(b) * nC + c) * Di + d];
      dD[d] = sd;
    }
  }
}

template <typename T>
cudaError_t scan_backward(int Bsz, int L, int Di, int N, int chunk, int d_block, int smem,
                          cudaStream_t s, const void* u, const void* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D, const void* gy,
                          const float* states, float* scratch, void* du, void* ddt, float* dA,
                          void* dB, void* dC, float* dD) {
  const int nC = L / chunk, nblk = Di / d_block;
  const long long per_chunk = static_cast<long long>(Bsz) * nC * Di * (N + 1);
  float* adj = scratch;
  float* dtsum = adj + static_cast<long long>(Bsz) * nC * N * Di;
  float* pdB = scratch + (nC > 1 ? per_chunk : 0);
  float* pdC = pdB + static_cast<long long>(Bsz) * L * nblk * N;
  float* pdA = pdC + static_cast<long long>(Bsz) * L * nblk * N;
  float* pdD = pdA + static_cast<long long>(Bsz) * nC * N * Di;
  const T* Tu = static_cast<const T*>(u);
  const T* Tdt = static_cast<const T*>(dt);
  const T* TC = static_cast<const T*>(Cm);
  const T* Tgy = static_cast<const T*>(gy);
  cudaError_t e;
  if (nC > 1) {
    const int smem1 = bwd_chunk_smem_bytes_for(chunk, N);
    static int smem1_set = 0;
    if (smem1 > smem1_set) {
      e = cudaFuncSetAttribute(selective_scan_bwd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
      if (e != cudaSuccess) return e;
      smem1_set = smem1;
    }
    selective_scan_bwd_chunk_kernel<T><<<dim3(Bsz, nblk, nC - 1), kBwdThreads, smem1, s>>>(
        Tdt, A, TC, Tgy, adj, dtsum, L, Di, N, chunk, nC, d_block);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long total = static_cast<long long>(Bsz) * N * Di;
    selective_scan_bwd_carry_kernel<<<static_cast<unsigned>((total + kCarryThreads - 1) / kCarryThreads),
                                      kCarryThreads, 0, s>>>(A, adj, dtsum, Bsz, Di, N, nC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  static int smem_set = 0;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(selective_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  selective_scan_bwd_kernel<T><<<dim3(Bsz, nblk, nC), kBwdThreads, smem, s>>>(
      Tu, Tdt, A, static_cast<const T*>(Bm), TC, D, Tgy, states, adj, static_cast<T*>(du),
      static_cast<T*>(ddt), pdB, pdC, pdA, pdD, L, Di, N, chunk, nC, d_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(Bsz) * L * N + static_cast<long long>(N) * Di + Di;
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);  // grid-stride past that
  selective_scan_bwd_reduce_kernel<T><<<blocks, kReduceThreads, 0, s>>>(
      pdB, pdC, pdA, pdD, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD, Bsz, L, Di, N, nC, nblk);
  return cudaGetLastError();
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

// The backward at the forward's tile: dtype, chunk, d_block as the forward's
// (u, dt, Bm, Cm, gy, du, ddt, dBm, dCm in the model dtype; A, D, dA, dD
// f32).  states: the forward's scratch after its pass 2 (each chunk's
// carry-in; unused, and may be null, when chunk == L).  smem_bytes: the
// output pass's shared memory and scratch at least the floats
// kernels/geometry.py scan_backward_scratch_floats gives, both from the
// wrapper and checked here.  Launches four kernels (two when chunk == L) on
// `stream`; returns cudaGetLastError() after the last.
extern "C" int selective_scan_backward_launch(
    const void* u, const void* dt, const void* A, const void* Bm, const void* Cm, const void* D,
    const void* gy, const void* states, void* scratch, void* du, void* ddt, void* dA, void* dB,
    void* dC, void* dD, int B, int L, int Di, int N, int chunk, int d_block, int smem_bytes,
    int dtype, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || N <= 0 || N > kMaxN || chunk <= 0 || d_block <= 0 ||
      d_block > kMaxThreads || L % chunk || Di % d_block || (dtype != 0 && dtype != 1) ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes != bwd_smem_bytes_for(chunk, N) || smem_bytes > 232448 ||
      (L / chunk > 1 && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* st = static_cast<const float*>(states);
  float* sc = static_cast<float*>(scratch);
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  const cudaError_t e =
      dtype == 1 ? scan_backward<bf16>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af, Bm, Cm,
                                       Df, gy, st, sc, du, ddt, dAf, dB, dC, dDf)
                 : scan_backward<float>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af, Bm,
                                        Cm, Df, gy, st, sc, du, ddt, dAf, dB, dC, dDf);
  return static_cast<int>(e);
}
