// Grouped (per-expert) GEMM for capacity-batched MoE on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_gemm` / `_kernel` of
// src/repro/kernels/moe_gemm.py:30-91:  x (E,C,d) . w (E,d,f) -> (E,C,f),
// accumulated in f32 over d, cast once to x's dtype.
//
// Bound: about even.  At the main path's prefill shape (granite-moe up/gate,
// (32,1280,1024) . (32,1024,512) bf16) the product is 42.9 GFLOP, 0.043 ms at
// 989 TFLOP/s, against 0.048 ms for its ~160 MB at 3.35 TB/s; at decode
// (C = 8 rows an expert) it is bound by reading the weights.  Design: grid
// (E, C/block_c, f/block_f); the TPU's sequential fourth grid axis over d
// becomes a loop inside the block, and the block_c x block_f f32
// accumulator stays in registers across it.
//
//  * bf16: a TMA -> wgmma pipeline (csrc/sm90.cuh).  d streams through a
//    ring of shared-memory stages 64 deep (one 128-byte swizzle row of
//    bf16): a stage holds the x slice of every consumer warpgroup (64 rows
//    x 64) and the w slice (64 x BN), 48 KB at the default tile.  The ring
//    holds one block_d step (block_d / 64 stages, at least 2), so block_d
//    sets how far the loads run ahead; the sum over d is taken 64 at a time
//    in order, which differs from per-step sums only in rounding.  One
//    thread of a producer warpgroup issues the TMA loads under a "full"
//    mbarrier per stage; block_c/64 consumer warpgroups each own 64 rows x
//    block_f columns and run wgmma m64nBNk16 (BN = 128 or 256, f32
//    accumulators in registers) on the stages that have arrived, keeping
//    one slice of products in flight while they free the stage before it.
//    The output leaves through the ring, which is free once the last slice
//    is multiplied: each warpgroup stages its rows in bf16 and writes them
//    out in 16-byte pieces (the accumulator fragment's own 4-byte stores,
//    8 rows a warp instruction, took about half the kernel's time).
//    setmaxnreg gives the producer 40 registers and the consumers 232.
//    3D tensor maps over (E, rows, cols) keep every box inside one expert
//    and zero-fill rows and columns past the tensor, so a tile below 64
//    rows (decode's block_c = 8) or off the instruction width (block_f =
//    96, 200) is computed padded and masked on store, never refused; a
//    block_f above BN is walked in BN-wide column chunks.  Decode keeps
//    this orientation (8 rows padded to 64) rather than computing out^T =
//    w^T x^T: the weights' bytes bound it and the padded products cost
//    ~2 us at peak, hidden under the weight stream.  The blocks run column
//    block fastest, so the blocks that share an x tile or a w panel meet in
//    L2.  Either operand may be given transposed (x stored (E,d,C), w
//    stored (E,f,d)): the tensor map reads it as stored and the wgmma
//    descriptor's transpose bit reads it as the other major, so the
//    backward's dx = dy.w^T and dw = x^T.dy copy nothing.
//  * f32: true f32 FMAs on the CUDA cores (no TF32), one thread per 8 x 8
//    outputs, each block_d step staged 16 rows of d at a time.  It takes
//    contiguous operands only: the wrapper copies a transposed one.
//
// The tile is the caller's (the plan's): the wrapper passes block_c,
// block_f, block_d, the thread count and the shared-memory size
// (kernels/geometry.py), and the launcher checks them against its own
// arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlice = 64;          // bf16: depth of one ring stage (128 bytes)
constexpr int kWgRows = 64;         // bf16: output rows of one consumer warpgroup (wgmma M)
constexpr int kMaxConsumers = 2;    // bf16: block_c <= 128
constexpr int kBf16Threads = 128 * (kMaxConsumers + 1);
constexpr int kBf16Regs = 168;      // 65,536 / 384 threads, rounded down to 8
constexpr int kProducerRegs = 40;   // 128 * 40 + 256 * 232 = 384 * 168
constexpr int kConsumerRegs = 232;
constexpr int kBox = kWgRows * kSlice * 2;  // bytes of one 64 x 64 bf16 box
constexpr int kMaxThreads = 512;    // f32
constexpr int kMicro = 8;           // f32: each thread owns kMicro x kMicro outputs
constexpr int kSlab = 16;           // f32: rows of d staged at a time
constexpr int kSmemPerBlock = 232448;

__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The block's threads and shared memory, as kernels/geometry.py computes them.
__host__ __device__ __forceinline__ int bf16_consumers(int block_c) { return cdiv(block_c, kWgRows); }
__host__ __device__ __forceinline__ int bf16_bn(int block_f) { return block_f <= 128 ? 128 : 256; }
__host__ __device__ __forceinline__ int bf16_stages(int block_d) {
  return block_d > kSlice ? cdiv(block_d, kSlice) : 2;  // one block_d step, at least 2
}
int bf16_threads(int block_c) { return 128 * (bf16_consumers(block_c) + 1); }
int bf16_smem(int block_c, int block_f, int block_d) {
  const int stage = (bf16_consumers(block_c) * kWgRows + bf16_bn(block_f)) * kSlice * 2;
  // alignment slack, the ring, two mbarriers a stage and one for the output
  return 1024 + bf16_stages(block_d) * (stage + 16) + 8;
}
int f32_threads(int block_c, int block_f) { return cdiv(block_c, kMicro) * cdiv(block_f, kMicro); }
int f32_smem(int block_c, int block_f) {
  return (cdiv(block_c, kMicro) * kMicro * (kSlab + 1) + kSlab * cdiv(block_f, kMicro) * kMicro) * 4;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA -> wgmma.  The logical product is x (E,C,d) .
// w (E,d,f); TA: x is stored (E,d,C), an MN-major A (the plain x is
// K-major); TB: w is stored (E,f,d), a K-major B (the plain w is
// MN-major).  Shared memory: the ring, each stage [consumers x 64 x 64 of
// x][BN x 64 of w], then its barriers.
// ---------------------------------------------------------------------------
template <int BN, int TA, int TB>
__global__ void __launch_bounds__(kBf16Threads, 1)
moe_gemm_bf16(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              bf16* __restrict__ out, int C, int d, int f, int block_c, int block_f, int block_d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = sm90::align1024(smem_raw);
  const int consumers = blockDim.x / 128 - 1;
  const int stages = bf16_stages(block_d);
  const int a_bytes = consumers * kBox;
  const int stage_bytes = a_bytes + BN * kSlice * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* staged = empty + stages;  // a column chunk's output has left the ring

  // block -> (expert, row block, column block), column blocks fastest
  const int n_f = gridDim.z, n_c = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + n_c * blockIdx.z);
  const int fb = lin % n_f, cb = (lin / n_f) % n_c, e = lin / (n_f * n_c);
  const int c0 = cb * block_c, f0 = fb * block_f;
  const int n_slices = cdiv(d, kSlice);
  const int n_chunks = cdiv(block_f, BN);
  // wgmma's transpose bits, set for an MN-major operand (M or N contiguous:
  // a transposed x, the plain (E,d,f) w); they choose the descriptor too
  constexpr int kTnspA = TA;
  constexpr int kTnspB = TB ? 0 : 1;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch_map(&xmap);
    sm90::tma_prefetch_map(&wmap);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * consumers);  // one arrival per consumer warp
    }
    sm90::mbar_init(staged, 4 * consumers);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int n0 = f0 + ch * BN;
        if (ch > 0) sm90::mbar_wait(staged, (ch - 1) & 1);  // the ring held the last chunk's output
        for (int s = 0; s < n_slices; ++s) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = ring + stage * stage_bytes;
          unsigned char* b = a + a_bytes;
          sm90::mbar_arrive_expect_tx(&full[stage], stage_bytes);
          const int k0 = s * kSlice;
          for (int w = 0; w < consumers; ++w) {
            if (TA) sm90::tma_load_3d(a + w * kBox, &xmap, &full[stage], c0 + w * kWgRows, k0, e);
            else sm90::tma_load_3d(a + w * kBox, &xmap, &full[stage], k0, c0 + w * kWgRows, e);
          }
          if (TB) {
            sm90::tma_load_3d(b, &wmap, &full[stage], k0, n0, e);
          } else {
            for (int j = 0; j < BN / 64; ++j)
              sm90::tma_load_3d(b + j * kBox, &wmap, &full[stage], n0 + j * 64, k0, e);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups: 64 rows each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int row = cw * kWgRows + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and row + 8
    const int col2 = 2 * (lane % 4);
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
      int held = -1;  // the stage whose products may still be in flight
      for (int s = 0; s < n_slices; ++s) {
        sm90::mbar_wait(&full[stage], phase);
        const unsigned char* a = ring + stage * stage_bytes + cw * kBox;
        const unsigned char* b = ring + stage * stage_bytes + a_bytes;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          // K-major: 16 columns = 32 bytes along the row; MN-major: 16 rows of 128 bytes
          const uint64_t da = kTnspA ? sm90::make_desc(a + kk * 2048, kBox, 1024, 1)
                                     : sm90::make_desc(a + kk * 32, 16, 1024, 1);
          const uint64_t db = kTnspB ? sm90::make_desc(b + kk * 2048, kBox, 1024, 1)
                                     : sm90::make_desc(b + kk * 32, 16, 1024, 1);
          sm90::wgmma_ss<kTnspA, kTnspB>(acc, da, db, (s > 0 || kk > 0) ? 1 : 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the slice before this one is multiplied: free its stage
        if (held >= 0) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[held]);
        }
        held = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[held]);

      // Epilogue through the ring, which no warpgroup reads any more: each
      // warpgroup stages its 64 x BN rows in bf16 (rows padded by 16 bytes,
      // so the fragment writes are free of bank conflicts), then writes them
      // out row by row in 16-byte pieces, masked to the block's tile.
      constexpr int kPitch = BN + 8;
      sm90::named_barrier_sync(1, 128 * consumers);
      bf16* tile = reinterpret_cast<bf16*>(ring) + cw * kWgRows * kPitch;
      const int r = row - cw * kWgRows;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(tile + r * kPitch + j * 8 + col2) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(tile + (r + 8) * kPitch + j * 8 + col2) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      sm90::named_barrier_sync(2 + cw, 128);
      for (int i = threadIdx.x % 128; i < kWgRows * (BN / 8); i += 128) {
        const int rr = cw * kWgRows + i / (BN / 8), col = ch * BN + i % (BN / 8) * 8;
        if (rr < block_c && col < block_f)  // block_f is a multiple of 8
          *reinterpret_cast<uint4*>(out + (static_cast<long long>(e) * C + c0 + rr) * f + f0 + col) =
              *reinterpret_cast<const uint4*>(tile + (rr - cw * kWgRows) * kPitch + i % (BN / 8) * 8);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(staged);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: true f32 FMAs.  Thread (ty, tx) owns rows ty + i*ny and columns
// tx + j*nx (i, j < 8) of the tile, so a warp reads neighbouring columns of
// the staged w slab.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads)
moe_gemm_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
             int C, int d, int f, int block_c, int block_f, int block_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ny = cdiv(block_c, kMicro), nx = cdiv(block_f, kMicro);
  const int rows = ny * kMicro, cols = nx * kMicro;
  float* Xs = reinterpret_cast<float*>(smem_raw);  // [rows][kSlab + 1]
  float* Ws = Xs + rows * (kSlab + 1);              // [kSlab][cols]

  const int e = blockIdx.x;
  const int c0 = blockIdx.y * block_c, f0 = blockIdx.z * block_f;
  const float* xe = x + (static_cast<long long>(e) * C + c0) * d;
  const float* we = w + static_cast<long long>(e) * d * f + f0;
  const int tx = threadIdx.x % nx, ty = threadIdx.x / nx;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += block_d) {
    for (int s0 = 0; s0 < block_d; s0 += kSlab) {
      const int kn = min(kSlab, block_d - s0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < rows * kSlab; idx += blockDim.x) {
        const int r = idx / kSlab, k = idx % kSlab;
        Xs[r * (kSlab + 1) + k] =
            (r < block_c && k < kn) ? xe[static_cast<long long>(r) * d + d0 + s0 + k] : 0.f;
      }
      for (int idx = threadIdx.x; idx < kSlab * cols; idx += blockDim.x) {
        const int k = idx / cols, c = idx % cols;
        Ws[k * cols + c] =
            (k < kn && c < block_f) ? we[static_cast<long long>(d0 + s0 + k) * f + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSlab; ++k) {  // rows past kn are zero: they add exactly 0
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = Xs[(ty + i * ny) * (kSlab + 1) + k];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = Ws[k * cols + tx + j * nx];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty + i * ny;
    if (r >= block_c) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = tx + j * nx;
      if (c < block_f) out[(static_cast<long long>(e) * C + c0 + r) * f + f0 + c] = acc[i][j];
    }
  }
}

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                       const void* x, const void* w, void* out, int C, int d, int f, int block_c,
                       int block_f, int block_d) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                          static_cast<float*>(out), C, d, f, block_c, block_f,
                                          block_d);
  return cudaGetLastError();
}

template <int BN, int TA, int TB>
cudaError_t launch_bf16(dim3 grid, int threads, int smem, cudaStream_t stream,
                        const CUtensorMap& xmap, const CUtensorMap& wmap, void* out, int C, int d,
                        int f, int block_c, int block_f, int block_d) {
  const auto kernel = moe_gemm_bf16<BN, TA, TB>;
  static const cudaError_t ready = [&] {  // once per instantiation
    const cudaError_t e = sm90::check_registers(kernel, kBf16Regs);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemPerBlock);
  }();
  if (ready != cudaSuccess) return ready;
  kernel<<<grid, threads, smem, stream>>>(xmap, wmap, static_cast<bf16*>(out), C, d, f, block_c,
                                          block_f, block_d);
  return cudaGetLastError();
}

using Bf16Launch = cudaError_t (*)(dim3, int, int, cudaStream_t, const CUtensorMap&,
                                   const CUtensorMap&, void*, int, int, int, int, int, int);

Bf16Launch pick_bf16(int bn, int x_t, int w_t) {
#define REPRO_MOE_PICK(BN)                                                       \
  if (bn == BN) {                                                                \
    if (x_t) return w_t ? launch_bf16<BN, 1, 1> : launch_bf16<BN, 1, 0>;       \
    return w_t ? launch_bf16<BN, 0, 1> : launch_bf16<BN, 0, 0>;                \
  }
  REPRO_MOE_PICK(128)
  REPRO_MOE_PICK(256)
#undef REPRO_MOE_PICK
  return nullptr;
}

}  // namespace

// The logical product is x (E,C,d) . w (E,d,f) -> out (E,C,f), out
// contiguous.  x_t: x is stored (E,d,C); w_t: w is stored (E,f,d); both
// bf16 only (the f32 kernel takes contiguous (E,C,d) and (E,d,f)).
// dtype: 0 = float32, 1 = bfloat16.  block_c/block_f/block_d are the tile,
// threads and smem_bytes the block's size, all from kernels/geometry.py; a
// tile that does not divide (C, f, d) or a size that disagrees with this
// file's arithmetic is refused.  Returns cudaGetLastError() after the launch.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int E, int C, int d,
                               int f, int block_c, int block_f, int block_d, int threads,
                               int smem_bytes, int dtype, int x_t, int w_t, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || block_c <= 0 || block_f <= 0 || block_d <= 0 ||
      C % block_c || f % block_f || d % block_d)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(E, C / block_c, f / block_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d % 8 || f % 8 || (x_t && C % 8) || block_d % 8 || block_f % 8 ||
        bf16_consumers(block_c) > kMaxConsumers || threads != bf16_threads(block_c) ||
        smem_bytes != bf16_smem(block_c, block_f, block_d) || smem_bytes > kSmemPerBlock)
      return static_cast<int>(cudaErrorInvalidValue);
    const int bn = bf16_bn(block_f);
    CUtensorMap xmap, wmap;
    cudaError_t e = x_t ? sm90::encode_bf16_3d(&xmap, x, C, d, E, 64, 64)   // boxes 64 C x 64 d
                        : sm90::encode_bf16_3d(&xmap, x, d, C, E, 64, 64);  // boxes 64 d x 64 C
    if (e == cudaSuccess)
      e = w_t ? sm90::encode_bf16_3d(&wmap, w, d, f, E, 64, bn)    // boxes 64 d x BN f
              : sm90::encode_bf16_3d(&wmap, w, f, d, E, 64, 64);   // boxes 64 f x 64 d
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(pick_bf16(bn, x_t != 0, w_t != 0)(
        grid, threads, smem_bytes, s, xmap, wmap, out, C, d, f, block_c, block_f, block_d));
  }
  if (dtype == 0) {
    if (x_t || w_t || threads != f32_threads(block_c, block_f) ||
        smem_bytes != f32_smem(block_c, block_f) || threads > kMaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_f32(moe_gemm_f32, grid, threads, smem_bytes, s, x, w, out, C,
                                       d, f, block_c, block_f, block_d));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
