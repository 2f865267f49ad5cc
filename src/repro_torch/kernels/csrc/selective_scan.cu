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
// the forward's scratch after pass 2 (each chunk's carry-in).  Four launches
// (two when chunk == L), deterministic (no atomics; every sum in a fixed
// order, so two calls give bit-equal gradients):
//   1. chunk pass, grid (B, Di/d_block, L/chunk - 1), a thread a channel
//      with its N states in registers: each chunk but the first walks the
//      adjoint back from zero, writing L_c = a_{t0} g_{t0} at its first step
//      t0 and sum(dt) over it;
//   2. carry pass, one thread a (b, n, channel): R_{c-1} = L_c +
//      exp(A sum(dt)_c) R_c from R_last = 0, over the chunks in reverse,
//      R_c written to slot c + 1;
//   3. output pass, grid (B, Di/d_block, L/chunk) of 256 threads: a thread
//      holds 4 of a channel's states, 64 channels in flight, the tile's
//      d_block channels 64 at a time.  Each chunk's states are rerun from
//      its carry-in (the recurrence is never inverted: a_t underflows to 0
//      at large dt), once over the chunk to keep each 64-step segment's
//      start, then a segment at a time, the last first: checkpointed every
//      4 steps in shared memory, each 4-step span rerun into registers
//      (states and decays) and walked back from R_c, writing du and ddt.
//      The sums over a channel's states (du, ddt) take four registers and
//      two shuffles; the sums over the block's channels (dB, dC) a
//      transposing warp reduction (7 shuffles leave each lane one (step,
//      state) sum of 8 channels), then one fold of the 8 warps' results in
//      order a span, into one partial row a channel block; dA and dD one
//      partial a chunk.  A span's dt, u and gy are loaded a span ahead by
//      the whole block into shared memory, du and ddt leave through the
//      same buffer a row at a time, and the walks load 8 steps ahead;
//   4. reduce pass: the partials summed over channel blocks (dB, dC) and
//      over batch and chunks (dA, dD).
// Bound: by operations, ~25 f32 operations a state update (0.200 ms at
// (1,4096,8192,16), bytes 0.10 ms); the SFU's exps, one a state update in
// pass 1 and two and a half in pass 3 at chunk 128 (the segment starts'
// walk, the checkpoint walk, the span rerun), take ~0.45 ms at that shape.
// What bounds this body is instruction count and latency at 16 warps an SM:
// 128 registers a thread hold two blocks an SM; one block an SM with the
// registers it would take is 39 % slower, and 8-step spans, which spill,
// 58 % (scripts/torch_kernel_variants.py, chunk 128).  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (that script, one call): 1.93 / 2.22 / 2.45 ms at
// chunk 64 / 128 / 256, where PR 20's body (a thread a (channel, state),
// 16 channels in flight, ten shuffles a state update) took 3.41 / 3.38 /
// 5.13.
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
constexpr float kLn2 = 0.6931471805599453f;

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
// Backward.  Scratch (f32): the adjoint carries [B][nC][N][Di] and sums of
// dt [B][nC][Di] (when nC > 1), then the partial dB and dC rows
// [B][L][nblk][N] each, then the partial dA [B][nC][N][Di] and dD [B][nC][Di].
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;                 // the output pass
constexpr int kBwdK = 4;                         // states a thread holds
constexpr int kBwdLanes = kMaxN / kBwdK;         // lanes a channel
constexpr int kBwdCh = kBwdThreads / kBwdLanes;  // channels in flight
constexpr int kBwdSpan = 4;                      // steps between checkpoints, rerun into registers
constexpr int kBwdCkpts = 16;                    // checkpoints a segment
constexpr int kBwdSeg = kBwdSpan * kBwdCkpts;    // steps a segment
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kReduceThreads = 256;
static_assert(kBwdWarps >= kBwdSpan, "the fold gives each warp's threads one step of a span");
static_assert(8 % kBwdSpan == 0, "a walk's 8-step blocks hold whole spans");
static_assert(kBwdSpan * kBwdCh % kBwdThreads == 0, "a span's rows spread evenly over the threads");

__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }

// The output pass: B and C of a segment (f32, 16 states a step), its
// checkpoints and the other segments' start states (a float4 a thread
// each), two buffers of the warps' per-step dB and dC sums over a span and
// three of a span's dt, u and gy (then du and ddt).
int bwd_smem_bytes_for(int chunk) {
  const int seg = chunk < kBwdSeg ? chunk : kBwdSeg, nseg = cdiv(chunk, kBwdSeg);
  return static_cast<int>(sizeof(float)) *
         (2 * seg * kMaxN + (cdiv(seg, kBwdSpan) + nseg - 1) * kBwdThreads * kBwdK +
          2 * kBwdWarps * kBwdSpan * 32 + 3 * 3 * kBwdSpan * kBwdCh);
}

// Pass 1: chunk c = blockIdx.z + 1 from a zero adjoint, one thread a channel
// with its N states in registers (the forward's chunk pass, walked back).
template <typename T, int NF>
__global__ void __launch_bounds__(kMaxThreads, 1)
selective_scan_bwd_chunk_kernel(const T* __restrict__ dt, const float* __restrict__ A,
                                const T* __restrict__ Cm, const T* __restrict__ gy,
                                float* __restrict__ adj, float* __restrict__ dtsum, int L, int Di,
                                int Nrt, int chunk, int nC) {
  extern __shared__ __align__(16) float smem[];
  const int N = NF ? NF : Nrt;
  float* Cs = smem;  // C [chunk][N] f32
  const int b = blockIdx.x, c = blockIdx.z + 1;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * chunk;
  for (int i = threadIdx.x; i < chunk * N; i += blockDim.x) Cs[i] = to_f32(Cm[row0 * N + i]);
  float a2[kMaxN], g[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a2[n] = n < N ? A[static_cast<long long>(d) * N + n] * kLog2e : 0.f;
    g[n] = 0.f;
  }
  __syncthreads();
  const T* tp = dt + row0 * Di + d;
  const T* gp = gy + row0 * Di + d;
  float sdt = 0.f;
#pragma unroll 4
  for (int t = chunk - 1; t >= 0; --t) {
    const float dv = to_f32(tp[static_cast<long long>(t) * Di]);
    const float gv = to_f32(gp[static_cast<long long>(t) * Di]);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) g[n] = ex2(dv * a2[n]) * fmaf(gv, Cs[t * N + n], g[n]);  // a_t g_t
    sdt += dv;
  }
#pragma unroll
  for (int n = 0; n < kMaxN; ++n)
    if (n < N) adj[state_at(b, c, n, d, nC, N, Di)] = g[n];
  dtsum[(static_cast<long long>(b) * nC + c) * Di + d] = sdt;
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

// Sums each of x's 8 values over the 8 lanes of the warp that share lane % 4
// (the warp's 8 channels) and leaves lane l holding value (l >> 2) of that
// sum: a transposing butterfly, 7 shuffles where 8 all-reduces take 24.
__device__ __forceinline__ float reduce_scatter8(const float (&x)[8], int lane) {
  float y[4], z[2];
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = (u16 ? x[j + 4] : x[j]) + __shfl_xor_sync(0xffffffffu, u16 ? x[j] : x[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    z[j] = (u8 ? y[j + 2] : y[j]) + __shfl_xor_sync(0xffffffffu, u8 ? y[j] : y[j + 2], 8);
  return (u4 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, u4 ? z[0] : z[1], 4);
}

// Pass 3: chunk c = blockIdx.z rerun from its carry-in and walked back.  A
// thread holds kBwdK states of one channel (lane q = threadIdx.x % 4: states
// 4q..4q+3, zero past N), 64 channels in flight, the block's d_block
// channels 64 at a time.  For each group the chunk is walked once from its
// carry-in to keep each 64-step segment's start state, then taken a segment
// at a time, the last first: the segment walked again from its start,
// checkpointed every 4 steps in shared memory, and each 4-step span rerun
// into registers (states and decays) and walked back from the adjoint
// carried in.  Loads run ahead of their use: a walk's u and dt 8 steps ahead
// in registers, a span's dt, u and gy one span ahead, spread over the block's
// threads and staged in shared memory; du and ddt leave through the same
// buffer, a row of channels at a time.
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
  constexpr int kIn = 3 * kBwdSpan * kBwdCh;  // a span's dt, u and gy of the channels in flight
  constexpr int kWalk = 8;                    // steps a walk loads ahead
  extern __shared__ __align__(16) float smem[];
  const int seg = min(chunk, kBwdSeg), nseg = cdiv(chunk, kBwdSeg);
  float* Bs = smem;                                               // the segment's B [seg][16]
  float* Cs = Bs + seg * kMaxN;                                   // and C
  float4* ck = reinterpret_cast<float4*>(Cs + seg * kMaxN);       // checkpoints [seg / 4][threads]
  float4* starts = ck + cdiv(seg, kBwdSpan) * kBwdThreads;        // segment start states [nseg - 1][threads]
  float* slot = reinterpret_cast<float*>(starts + (nseg - 1) * kBwdThreads);  // [2][warps][span][32]
  float* span_in = slot + 2 * kBwdWarps * kBwdSpan * 32;          // [3][dt | du, u | ddt, gy][span][channel]
  const int b = blockIdx.x, c = blockIdx.z, blk = blockIdx.y, nblk = gridDim.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, q = threadIdx.x % kBwdLanes;
  const int ch = threadIdx.x / kBwdLanes, n0 = q * kBwdK;  // the thread's channel slot and first state
  const long long row0 = static_cast<long long>(b) * L + static_cast<long long>(c) * chunk;
  // the (step, state, dB | dC) sum this thread folds: step t0 + warp of a
  // span, state fold_n, dB or dC by lane / 16 (reduce_scatter8's order)
  const int fold_n = (lane & 3) * kBwdK + ((lane >> 2) & 3);
  float* fold_dst = (lane >> 4) ? pdC : pdB;
  int span_no = 0;  // spans done by the block: picks the slot and input buffers

  const int d_lo = blk * d_block, d_hi = d_lo + d_block;
  for (int d0 = d_lo; d0 < d_hi; d0 += kBwdCh) {
    const int d = d0 + ch;
    const bool on = d < d_hi;
    float a2[kBwdK], gn[kBwdK], dAacc[kBwdK];
#pragma unroll
    for (int j = 0; j < kBwdK; ++j) {
      const bool st = on && n0 + j < N;
      a2[j] = st ? A[static_cast<long long>(d) * N + n0 + j] * kLog2e : 0.f;
      // the adjoint carried into the chunk's end, R_c (slot c + 1 after pass 2)
      gn[j] = (st && c < nC - 1) ? adj[state_at(b, c + 1, n0 + j, d, nC, N, Di)] : 0.f;
      dAacc[j] = 0.f;
    }
    const float dskip = on ? D[d] : 0.f;
    float dDacc = 0.f;
    // u and dt of this channel; an idle channel walks another's (its decay
    // is 1, and gy, hence its adjoint and every sum it enters, is 0)
    const T* up = u + row0 * Di + (on ? d : d_lo);
    const T* tp = dt + row0 * Di + (on ? d : d_lo);
    // B of the thread's states at step t: staged in shared memory within the
    // segment from t_b on, read from device memory before it
    auto b_at = [&](int t, int t_b) {
      if (t >= t_b) return *reinterpret_cast<const float4*>(Bs + (t - t_b) * kMaxN + n0);
      float v[kBwdK];
#pragma unroll
      for (int j = 0; j < kBwdK; ++j) v[j] = n0 + j < N ? to_f32(Bm[(row0 + t) * N + n0 + j]) : 0.f;
      return make_float4(v[0], v[1], v[2], v[3]);
    };
    // h_{t-1} -> h_t over [t_from, t_to), storing (unless dst is null) the
    // state before each step t_from + k * kBwdSpan in dst[k][thread]
    auto walk = [&](float (&h)[kBwdK], int t_from, int t_to, float4* dst, int t_b) {
      float wdt[kWalk], wu[kWalk];
      auto load = [&](float (&vd)[kWalk], float (&vu)[kWalk], int t) {
#pragma unroll
        for (int i = 0; i < kWalk; ++i) {
          const long long at = static_cast<long long>(min(t + i, t_to - 1)) * Di;
          vd[i] = to_f32(tp[at]);
          vu[i] = to_f32(up[at]);
        }
      };
      if (t_from < t_to) load(wdt, wu, t_from);
      for (int t = t_from; t < t_to; t += kWalk) {
        float ndt[kWalk], nu[kWalk];
        if (t + kWalk < t_to) load(ndt, nu, t + kWalk);
#pragma unroll
        for (int i = 0; i < kWalk; ++i) {
          if (t + i < t_to) {
            if (dst != nullptr && i % kBwdSpan == 0)
              dst[(t + i - t_from) / kBwdSpan * kBwdThreads + threadIdx.x] = make_float4(h[0], h[1], h[2], h[3]);
            const float x = wdt[i] * wu[i];
            const float4 b4 = b_at(t + i, t_b);
            const float bb[kBwdK] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int j = 0; j < kBwdK; ++j) h[j] = fmaf(ex2(wdt[i] * a2[j]), h[j], x * bb[j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kWalk; ++i) {
          wdt[i] = ndt[i];
          wu[i] = nu[i];
        }
      }
    };
    // a span's inputs, fetched by the whole block: element e = tid + k * threads
    // of [dt, u, gy][step][channel], 0 past the segment or the channels
    auto fetch = [&](float (&v)[kIn / kBwdThreads], int t0, int t_hi) {
#pragma unroll
      for (int k = 0; k < kIn / kBwdThreads; ++k) {
        const int e = threadIdx.x + k * kBwdThreads, arr = e / (kBwdSpan * kBwdCh);
        const int i = e / kBwdCh % kBwdSpan, cc = e % kBwdCh;
        const T* src = arr == 0 ? dt : arr == 1 ? u : gy;
        v[k] = (t0 + i < t_hi && d0 + cc < d_hi) ? to_f32(src[(row0 + t0 + i) * Di + d0 + cc]) : 0.f;
      }
    };
    auto stage = [&](const float (&v)[kIn / kBwdThreads], int buf) {
#pragma unroll
      for (int k = 0; k < kIn / kBwdThreads; ++k) span_in[buf * kIn + threadIdx.x + k * kBwdThreads] = v[k];
    };

    {  // the segments' start states, from the carry-in (the state at the end of chunk c - 1)
      float h[kBwdK];
#pragma unroll
      for (int j = 0; j < kBwdK; ++j)
        h[j] = (on && c > 0 && n0 + j < N) ? states[state_at(b, c - 1, n0 + j, d, nC, N, Di)] : 0.f;
      for (int sg = 1; sg < nseg; ++sg) {
        walk(h, (sg - 1) * kBwdSeg, sg * kBwdSeg, nullptr, chunk);  // B from device memory
        starts[(sg - 1) * kBwdThreads + threadIdx.x] = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    for (int sg = nseg - 1; sg >= 0; --sg) {
      const int t_lo = sg * kBwdSeg, t_hi = min(chunk, t_lo + kBwdSeg);
      const int spans = cdiv(t_hi - t_lo, kBwdSpan);
      float nxt[kIn / kBwdThreads];
      fetch(nxt, t_lo + (spans - 1) * kBwdSpan, t_hi);  // the segment's last span, under the walk
      for (int i = threadIdx.x; i < (t_hi - t_lo) * kMaxN; i += blockDim.x) {
        const int n = i % kMaxN;
        const long long at = (row0 + t_lo + i / kMaxN) * N + n;
        Bs[i] = n < N ? to_f32(Bm[at]) : 0.f;
        Cs[i] = n < N ? to_f32(Cm[at]) : 0.f;
      }
      stage(nxt, span_no % 3);
      __syncthreads();  // the segment's B and C, its first span's inputs
      float h[kBwdK];
      if (sg == 0) {
#pragma unroll
        for (int j = 0; j < kBwdK; ++j)
          h[j] = (on && c > 0 && n0 + j < N) ? states[state_at(b, c - 1, n0 + j, d, nC, N, Di)] : 0.f;
      } else {
        const float4 s4 = starts[(sg - 1) * kBwdThreads + threadIdx.x];
        h[0] = s4.x;
        h[1] = s4.y;
        h[2] = s4.z;
        h[3] = s4.w;
      }
      walk(h, t_lo, t_hi, ck, t_lo);
      for (int s = spans - 1; s >= 0; --s) {
        const int t0 = t_lo + s * kBwdSpan, len = min(kBwdSpan, t_hi - t0);
        if (s > 0) fetch(nxt, t0 - kBwdSpan, t_hi);  // the next span's, under this one
        // the fold's running sum over the block's earlier channel groups,
        // loaded now so that its latency passes under the span's walks
        const int fi = warp;
        const bool folds = fi < len && fold_n < N;
        float* fdst = fold_dst + ((row0 + t0 + fi) * nblk + blk) * N + fold_n;
        const float before = (folds && d0 != d_lo) ? *fdst : 0.f;
        float* in = span_in + (span_no % 3) * kIn;
        float sdt[kBwdSpan], su[kBwdSpan], sgy[kBwdSpan];
#pragma unroll
        for (int i = 0; i < kBwdSpan; ++i) {
          sdt[i] = in[i * kBwdCh + ch];
          su[i] = in[(kBwdSpan + i) * kBwdCh + ch];
          sgy[i] = in[(2 * kBwdSpan + i) * kBwdCh + ch];
        }
        float hs[kBwdSpan + 1][kBwdK], as[kBwdSpan][kBwdK];  // h_{t-1} (hs[i]), h_t (hs[i + 1]), a_t
        const float4 c4 = ck[s * kBwdThreads + threadIdx.x];
        hs[0][0] = c4.x;
        hs[0][1] = c4.y;
        hs[0][2] = c4.z;
        hs[0][3] = c4.w;
        float* sl = slot + (span_no & 1) * kBwdWarps * kBwdSpan * 32;
        const float* bs = Bs + (t0 - t_lo) * kMaxN + n0;
        const float* cs = Cs + (t0 - t_lo) * kMaxN + n0;
        auto fwd = [&](int i) {
          const float x = sdt[i] * su[i];
          const float4 b4 = *reinterpret_cast<const float4*>(bs + i * kMaxN);
          const float bb[kBwdK] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int j = 0; j < kBwdK; ++j) {
            as[i][j] = ex2(sdt[i] * a2[j]);
            hs[i + 1][j] = fmaf(as[i][j], hs[i][j], x * bb[j]);
          }
        };
        auto back = [&](int i) {
          const float dv = sdt[i], uv = su[i], gyv = sgy[i], dtu = dv * uv;
          const float4 b4 = *reinterpret_cast<const float4*>(bs + i * kMaxN);
          const float4 c4t = *reinterpret_cast<const float4*>(cs + i * kMaxN);
          const float bb[kBwdK] = {b4.x, b4.y, b4.z, b4.w}, cc[kBwdK] = {c4t.x, c4t.y, c4t.z, c4t.w};
          float x[2 * kBwdK], sgb = 0.f, sah = 0.f;
#pragma unroll
          for (int j = 0; j < kBwdK; ++j) {
            const float g = fmaf(gyv, cc[j], gn[j]);  // g_t
            const float ga = g * as[i][j], gah = ga * hs[i][j];
            x[j] = g * dtu;                     // dB_t over this channel
            x[kBwdK + j] = gyv * hs[i + 1][j];  // dC_t
            sgb = fmaf(g, bb[j], sgb);
            sah = fmaf(a2[j], gah, sah);        // A g a h_{t-1}, in log2(e) units
            dAacc[j] = fmaf(dv, gah, dAacc[j]);
            gn[j] = ga;  // a_t g_t
          }
          // du and ddt over the channel's 4 lanes: lanes 0, 1 end with du, 2, 3
          // with ddt; they take the places of dt and u in the span's buffer,
          // which the warp's lanes have all read (the shuffles hold them)
          const float pdu = dv * sgb, pdt = fmaf(uv, sgb, sah * kLn2);
          const bool hi = lane & 2;
          float r = (hi ? pdt : pdu) + __shfl_xor_sync(0xffffffffu, hi ? pdu : pdt, 2);
          r += __shfl_xor_sync(0xffffffffu, r, 1);
          if (q == 0) in[i * kBwdCh + ch] = fmaf(dskip, gyv, r);
          if (q == 2) in[(kBwdSpan + i) * kBwdCh + ch] = r;
          dDacc = fmaf(gyv, uv, dDacc);
          // dB and dC over the warp's 8 channels
          sl[(warp * kBwdSpan + i) * 32 + lane] = reduce_scatter8(x, lane);
        };
        if (len == kBwdSpan) {  // a whole span: no guards, so steps overlap
#pragma unroll
          for (int i = 0; i < kBwdSpan; ++i) fwd(i);
#pragma unroll
          for (int i = kBwdSpan - 1; i >= 0; --i) back(i);
        } else {
#pragma unroll
          for (int i = 0; i < kBwdSpan; ++i)
            if (i < len) fwd(i);
#pragma unroll
          for (int i = kBwdSpan - 1; i >= 0; --i)
            if (i < len) back(i);
        }
        if (s > 0) stage(nxt, (span_no + 1) % 3);
        __syncthreads();
        if (folds) {  // the warps' sums in order, then the channel groups' in order
          float v = before;
#pragma unroll
          for (int w = 0; w < kBwdWarps; ++w) v += sl[(w * kBwdSpan + fi) * 32 + lane];
          *fdst = v;
        }
#pragma unroll
        for (int k = 0; k < 2 * kBwdSpan * kBwdCh / kBwdThreads; ++k) {  // du, then ddt, a row at a time
          const int e = threadIdx.x + k * kBwdThreads, i = e / kBwdCh % kBwdSpan, cc = e % kBwdCh;
          if (i < len && d0 + cc < d_hi)
            (e < kBwdSpan * kBwdCh ? du : ddt)[(row0 + t0 + i) * Di + d0 + cc] = from_f32<T>(in[e]);
        }
        ++span_no;
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdK; ++j)
      if (on && n0 + j < N) pdA[state_at(b, c, n0 + j, d, nC, N, Di)] = dAacc[j];
    if (on && q == 0) pdD[(static_cast<long long>(b) * nC + c) * Di + d] = dDacc;
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

template <typename T, int NF>
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
    const int smem1 = chunk * N * static_cast<int>(sizeof(float));
    static int smem1_set = 0;
    if (smem1 > smem1_set) {  // above 48 KB only after this attribute
      e = cudaFuncSetAttribute(selective_scan_bwd_chunk_kernel<T, NF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
      if (e != cudaSuccess) return e;
      smem1_set = smem1;
    }
    selective_scan_bwd_chunk_kernel<T, NF><<<dim3(Bsz, nblk, nC - 1), d_block, smem1, s>>>(
        Tdt, A, TC, Tgy, adj, dtsum, L, Di, N, chunk, nC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long total = static_cast<long long>(Bsz) * N * Di;
    selective_scan_bwd_carry_kernel<<<static_cast<unsigned>((total + kCarryThreads - 1) / kCarryThreads),
                                      kCarryThreads, 0, s>>>(A, adj, dtsum, Bsz, Di, N, nC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  static const cudaError_t ready = [] {  // the output pass: two blocks an SM at every chunk it takes
    cudaError_t r = cudaFuncSetAttribute(selective_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(selective_scan_bwd_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    return r;
  }();
  if (ready != cudaSuccess) return ready;
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

template <typename T>
cudaError_t scan_backward_dispatch(int Bsz, int L, int Di, int N, int chunk, int d_block, int smem,
                                   cudaStream_t s, const void* u, const void* dt, const float* A,
                                   const void* Bm, const void* Cm, const float* D, const void* gy,
                                   const float* states, float* scratch, void* du, void* ddt, float* dA,
                                   void* dB, void* dC, float* dD) {
  if (N == kMaxN)
    return scan_backward<T, kMaxN>(Bsz, L, Di, N, chunk, d_block, smem, s, u, dt, A, Bm, Cm, D, gy, states,
                                   scratch, du, ddt, dA, dB, dC, dD);
  return scan_backward<T, 0>(Bsz, L, Di, N, chunk, d_block, smem, s, u, dt, A, Bm, Cm, D, gy, states,
                             scratch, du, ddt, dA, dB, dC, dD);
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
  if (smem_bytes != bwd_smem_bytes_for(chunk) || smem_bytes > 232448 ||
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
      dtype == 1 ? scan_backward_dispatch<bf16>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af,
                                                Bm, Cm, Df, gy, st, sc, du, ddt, dAf, dB, dC, dDf)
                 : scan_backward_dispatch<float>(B, L, Di, N, chunk, d_block, smem_bytes, s, u, dt, Af,
                                                 Bm, Cm, Df, gy, st, sc, du, ddt, dAf, dB, dC, dDf);
  return static_cast<int>(e);
}
