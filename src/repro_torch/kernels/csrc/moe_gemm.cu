// Grouped (per-expert) GEMM for capacity-batched MoE on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_gemm` / `_kernel` of
// src/repro/kernels/moe_gemm.py:30-91:  x (E,C,d) . w (E,d,f) -> (E,C,f),
// accumulated in f32 over d in block_d steps, cast once to x's dtype.
//
// Bound: about even.  At the main path's prefill shape (granite-moe up/gate,
// (32,1280,1024) . (32,1024,512) bf16) the product is 42.9 GFLOP, 0.043 ms at
// 989 TFLOP/s, against 0.048 ms for its ~160 MB at 3.35 TB/s; at decode
// (C = 8 rows an expert) it is bound by reading the weights.  Design: grid
// (E, C/block_c, f/block_f); the TPU's sequential fourth grid axis over d
// becomes a loop inside the block, and the block_c x block_f f32
// accumulator stays in registers across it.
//
//  * bf16: each block_d step copies the x tile [block_c][block_d] and the w
//    tile [block_d][block_f] whole into shared memory with cp.async (16-byte
//    copies, zero-filled where the tile is padded up to the warp tile), rows
//    padded by 16 bytes so the ldmatrix fragment loads are free of bank
//    conflicts.  One warp owns a 32 x 64 piece of the output: two m16 row
//    blocks by eight n8 column blocks of mma.sync m16n8k16 (bf16 in, f32
//    accumulate; every bf16 x bf16 product is exact in f32, as in the Pallas
//    kernel's f32 dot).  The loads of a step are not overlapped with its
//    products (one stage: the default tile's 202,752 bytes leave no room
//    for a second); a wgmma/TMA pipeline is later work.
//  * f32: true f32 FMAs on the CUDA cores (no TF32), one thread per 8 x 8
//    outputs, each block_d step staged 16 rows of d at a time.
//
// The tile is the caller's (the plan's): the wrapper passes block_c,
// block_f, block_d, the thread count and the shared-memory size
// (kernels/geometry.py), and the launcher checks them against its own
// arithmetic.  A tile smaller than a warp tile (decode's block_c = 8) is
// padded inside the kernel and masked on store, never changed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;          // bf16 elements of padding per staged row
constexpr int kWarpRows = 32;    // bf16: output rows of one warp
constexpr int kWarpCols = 64;    // bf16: output columns of one warp
constexpr int kMaxThreads = 512;
constexpr int kMicro = 8;        // f32: each thread owns kMicro x kMicro outputs
constexpr int kSlab = 16;        // f32: rows of d staged at a time

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8x8 b16 matrices; lane l names a row of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The block's threads and shared memory, as kernels/geometry.py computes them.
int bf16_threads(int block_c, int block_f) {
  return 32 * (round_up(block_c, kWarpRows) / kWarpRows) * (round_up(block_f, kWarpCols) / kWarpCols);
}
int bf16_smem(int block_c, int block_f, int block_d) {
  const int bc = round_up(block_c, kWarpRows), bf = round_up(block_f, kWarpCols);
  const int bd = round_up(block_d, 16);
  return (bc * (bd + kPad) + bd * (bf + kPad)) * 2;
}
int f32_threads(int block_c, int block_f) { return cdiv(block_c, kMicro) * cdiv(block_f, kMicro); }
int f32_smem(int block_c, int block_f) {
  return (cdiv(block_c, kMicro) * kMicro * (kSlab + 1) + kSlab * cdiv(block_f, kMicro) * kMicro) * 4;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.  Fragment layouts of mma.m16n8k16 (g = lane/4, t = lane%4):
//   A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8.., n = g)
//   C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// A comes from the row-major x tile by ldmatrix, B from the row-major
// [k][n] w tile by ldmatrix.trans.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxThreads)
moe_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
              int C, int d, int f, int block_c, int block_f, int block_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bc_pad = round_up(block_c, kWarpRows);
  const int bf_pad = round_up(block_f, kWarpCols);
  const int bd_pad = round_up(block_d, 16);
  const int xs_stride = bd_pad + kPad, ws_stride = bf_pad + kPad;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [bc_pad][bd_pad + kPad]
  bf16* Ws = Xs + bc_pad * xs_stride;             // [bd_pad][bf_pad + kPad]

  const int e = blockIdx.x;
  const int c0 = blockIdx.y * block_c, f0 = blockIdx.z * block_f;
  const bf16* xe = x + (static_cast<long long>(e) * C + c0) * d;  // row c0 of expert e
  const bf16* we = w + static_cast<long long>(e) * d * f + f0;     // column f0 of expert e

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int warps_m = bc_pad / kWarpRows;
  const int wr = (warp % warps_m) * kWarpRows, wc = (warp / warps_m) * kWarpCols;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

  const int xv = bd_pad / 8, wv = bf_pad / 8;  // 16-byte vectors per staged row
  for (int d0 = 0; d0 < d; d0 += block_d) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int idx = threadIdx.x; idx < bc_pad * xv; idx += blockDim.x) {
      const int r = idx / xv, c = (idx % xv) * 8;
      const bool ok = r < block_c && c < block_d;
      cp_async16(Xs + r * xs_stride + c, ok ? xe + static_cast<long long>(r) * d + d0 + c : x, ok);
    }
    for (int idx = threadIdx.x; idx < bd_pad * wv; idx += blockDim.x) {
      const int r = idx / wv, c = (idx % wv) * 8;
      const bool ok = r < block_d && c < block_f;
      cp_async16(Ws + r * ws_stride + c, ok ? we + static_cast<long long>(d0 + r) * f + c : w, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int k0 = 0; k0 < bd_pad; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], Xs + (wr + mi * 16 + (lane & 15)) * xs_stride + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];  // b0, b1 of column block 2nj, then of 2nj + 1
        ldmatrix_x4_trans(b, Ws + (k0 + (lane & 15)) * ws_stride + wc + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int ra = wr + mi * 16 + g, rb = ra + 8;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = wc + n * 8 + 2 * t4;  // even; block_f is a multiple of 8
      if (col >= block_f) continue;
      if (ra < block_c)
        *reinterpret_cast<uint32_t*>(out + (static_cast<long long>(e) * C + c0 + ra) * f + f0 + col) =
            pack_bf16(acc[mi][n][0], acc[mi][n][1]);
      if (rb < block_c)
        *reinterpret_cast<uint32_t*>(out + (static_cast<long long>(e) * C + c0 + rb) * f + f0 + col) =
            pack_bf16(acc[mi][n][2], acc[mi][n][3]);
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

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                   const void* x, const void* w, void* out, int C, int d, int f, int block_c,
                   int block_f, int block_d) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          static_cast<T*>(out), C, d, f, block_c, block_f,
                                          block_d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  block_c/block_f/block_d are the tile,
// threads and smem_bytes the block's size, all from kernels/geometry.py; a
// tile that does not divide (C, f, d) or a size that disagrees with this
// file's arithmetic is refused.  Returns cudaGetLastError() after the launch.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int E, int C, int d,
                               int f, int block_c, int block_f, int block_d, int threads,
                               int smem_bytes, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || block_c <= 0 || block_f <= 0 || block_d <= 0 ||
      C % block_c || f % block_f || d % block_d)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(E, C / block_c, f / block_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d % 8 || f % 8 || block_d % 8 || block_f % 8 || threads != bf16_threads(block_c, block_f) ||
        smem_bytes != bf16_smem(block_c, block_f, block_d) || threads > kMaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<bf16>(moe_gemm_bf16, grid, threads, smem_bytes, s, x, w, out,
                                         C, d, f, block_c, block_f, block_d));
  }
  if (dtype == 0) {
    if (threads != f32_threads(block_c, block_f) || smem_bytes != f32_smem(block_c, block_f) ||
        threads > kMaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<float>(moe_gemm_f32, grid, threads, smem_bytes, s, x, w, out,
                                          C, d, f, block_c, block_f, block_d));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
