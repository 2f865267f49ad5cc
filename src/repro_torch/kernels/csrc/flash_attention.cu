// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:29-153.  q (B,Hq,Sq,D), k and v
// (B,Hkv,Skv,D), all contiguous; q-head h reads kv-head h / (Hq/Hkv); the
// queries sit at the last Sq positions of the Skv keys; kv tiles wholly above
// the causal diagonal are never visited; a row that sees no key gives 0.
//
// Bound: operations at the main path's shapes (a causal 4096-token prefill
// does ~2.2 k operations per byte of q, k, v and o).  Design: one block per
// (query tile, head, batch); the TPU's sequential kv grid axis becomes a
// loop inside the block, bounded by the causal diagonal; each kv tile of
// `block_kv` keys is staged in shared memory and every query row keeps its
// running max, sum and f32 accumulator in registers (online softmax).
//
//  * bf16: one warp per 16 query rows; both products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), 64 keys per softmax step.
//    K is staged row-major and V transposed, rows padded by 16 bytes, so the
//    fragment loads are free of bank conflicts.  P is rounded to bf16 for the
//    second product (the TPU kernel kept it in f32); chip_smoke.py holds it to
//    5e-2 per element and 1e-2 in norm relative to the plain version's output.
//  * f32: one thread per query row in true f32 on the CUDA cores (no TF32),
//    16 keys per softmax step, for the 2e-5 tolerance of the f32 tests.
//
// The tile is the caller's (the plan's): the wrapper passes block_q,
// block_kv, the padded key rows, the thread count and the shared-memory size
// (kernels/geometry.py); a ragged sequence is masked here, never padded in
// device memory.  wgmma/TMA and a producer warp are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;         // bf16 elements of padding per staged row
constexpr int kStepBf16 = 64;   // keys per online-softmax step (bf16)
constexpr int kStepF32 = 16;    // keys per online-softmax step (f32)
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Bf16Bounds { static constexpr int kThreads = D > 64 ? 256 : 512; };
constexpr int kThreadsF32 = 256;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Number of kv tiles a query tile visits: all of them, or (causal) those
// whose first key is at or before the tile's last query position.
__device__ __forceinline__ int kv_tiles(int Skv, int block_kv, int causal, int last_qpos) {
  const int n = (Skv + block_kv - 1) / block_kv;
  if (!causal) return n;
  return last_qpos < 0 ? 0 : min(n, last_qpos / block_kv + 1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.  Fragment layouts of mma.m16n8k16 (g = lane/4, t = lane%4):
//   A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (k = 2t..2t+1, n = g), (k = 2t+8.., n = g)
//   C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Bf16Bounds<D>::kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hkv, int Sq,
               int Skv, int block_q, int block_kv, int kv_pad, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ks_stride = D + kPad;
  const int vt_stride = kv_pad + kPad;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kv_pad][D + kPad]
  bf16* Vt = Ks + kv_pad * ks_stride;             // [D][kv_pad + kPad]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_off = Skv - Sq;
  const int q0 = blockIdx.x * block_q;
  const int q_end = min(q0 + block_q, Sq);
  const int r0 = q0 + warp * 16;  // first query row of this warp
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool va = ra < q_end, vb = rb < q_end;
  const bool warp_live = r0 < q_end;

  const bf16* qb = q + static_cast<long long>(b * Hq + h) * Sq * D;
  const bf16* kb = k + static_cast<long long>(b * Hkv + hk) * Skv * D;
  const bf16* vbase = v + static_cast<long long>(b * Hkv + hk) * Skv * D;
  bf16* ob = o + static_cast<long long>(b * Hq + h) * Sq * D;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = va ? ld32(qb + static_cast<long long>(ra) * D + c) : 0u;
    qf[kk][1] = vb ? ld32(qb + static_cast<long long>(rb) * D + c) : 0u;
    qf[kk][2] = va ? ld32(qb + static_cast<long long>(ra) * D + c + 8) : 0u;
    qf[kk][3] = vb ? ld32(qb + static_cast<long long>(rb) * D + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // log2 domain
  const float sl2 = scale * kLog2e;

  const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * block_kv;
    const int kv_n = min(block_kv, Skv - kv0);  // keys of this tile that exist
    __syncthreads();                           // the previous tile is consumed
    constexpr int VPR = D / 8;                 // 16-byte vectors per row
    for (int idx = threadIdx.x; idx < kv_pad * VPR; idx += blockDim.x) {
      const int j = idx / VPR, c = (idx % VPR) * 8;
      uint4 kvec = make_uint4(0u, 0u, 0u, 0u), vvec = kvec;
      if (j < kv_n) {
        const long long off = static_cast<long long>(kv0 + j) * D + c;
        kvec = *reinterpret_cast<const uint4*>(kb + off);
        vvec = *reinterpret_cast<const uint4*>(vbase + off);
      }
      *reinterpret_cast<uint4*>(Ks + j * ks_stride + c) = kvec;
      const bf16* ve = reinterpret_cast<const bf16*>(&vvec);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * vt_stride + j] = ve[e];
    }
    __syncthreads();
    if (!warp_live) continue;

    for (int c0 = 0; c0 < kv_n; c0 += kStepBf16) {
      const int key0 = kv0 + c0;
      if (causal && key0 > q_off + r0 + 15) break;  // every key right of every row

      float s[kStepBf16 / 8][4];
#pragma unroll
      for (int n = 0; n < kStepBf16 / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* kr = Ks + (c0 + n * 8 + g) * ks_stride + kk * 16 + 2 * t4;
          mma_bf16(s[n], qf[kk], ld32(kr), ld32(kr + 8));
        }
      }

      const bool masked = (c0 + kStepBf16 > kv_n) ||
                          (causal && key0 + kStepBf16 - 1 > q_off + r0);
#pragma unroll
      for (int n = 0; n < kStepBf16 / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (masked) {
            const int j = c0 + n * 8 + 2 * t4 + (e & 1);  // key within the tile
            const int row = e < 2 ? ra : rb;
            if (j >= kv_n || (causal && kv0 + j > q_off + row)) x = -INFINITY;
          }
          s[n][e] = x;
        }
      }

      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int n = 0; n < kStepBf16 / 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      // a row that has seen no key yet keeps max -inf: exponentiate against 0
      const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
      const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
      const float alpha_a = exp2f(m_a - base_a), alpha_b = exp2f(m_b - base_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      uint32_t pf[kStepBf16 / 16][4];
#pragma unroll
      for (int n = 0; n < kStepBf16 / 8; ++n) {
        const float p0 = exp2f(s[n][0] - base_a), p1 = exp2f(s[n][1] - base_a);
        const float p2 = exp2f(s[n][2] - base_b), p3 = exp2f(s[n][3] - base_b);
        l_a += p0 + p1;
        l_b += p2 + p3;
        // the C layout of key columns 8n..8n+7 is half of the A layout of
        // the 16-key step n/2
        pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

#pragma unroll
      for (int kk = 0; kk < kStepBf16 / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* vr = Vt + (n * 8 + g) * vt_stride + c0 + kk * 16 + 2 * t4;
          mma_bf16(acc[n], pf[kk], ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);  // a row that saw no key -> 0
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (va)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(ra) * D + c) =
          pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (vb)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(rb) * D + c) =
          pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32: one thread per query row, true f32 FMAs.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv, int Sq,
              int Skv, int block_q, int block_kv, int kv_pad, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kv_pad][D]
  float* Vs = Ks + kv_pad * D;                       // [kv_pad][D]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_off = Skv - Sq;
  const int q0 = blockIdx.x * block_q;
  const int q_end = min(q0 + block_q, Sq);
  const int row = q0 + threadIdx.x;
  const bool valid = row < q_end;
  const int qpos = q_off + row;

  const float* kb = k + static_cast<long long>(b * Hkv + hk) * Skv * D;
  const float* vbase = v + static_cast<long long>(b * Hkv + hk) * Skv * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid)
      x = *reinterpret_cast<const float4*>(q + (static_cast<long long>(b * Hq + h) * Sq + row) * D + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * block_kv;
    const int kv_n = min(block_kv, Skv - kv0);
    __syncthreads();
    constexpr int VPR = D / 4;
    for (int idx = threadIdx.x; idx < kv_pad * VPR; idx += blockDim.x) {
      const int j = idx / VPR, c = (idx % VPR) * 4;
      float4 kvec = make_float4(0.f, 0.f, 0.f, 0.f), vvec = kvec;
      if (j < kv_n) {
        const long long off = static_cast<long long>(kv0 + j) * D + c;
        kvec = *reinterpret_cast<const float4*>(kb + off);
        vvec = *reinterpret_cast<const float4*>(vbase + off);
      }
      *reinterpret_cast<float4*>(Ks + j * D + c) = kvec;
      *reinterpret_cast<float4*>(Vs + j * D + c) = vvec;
    }
    __syncthreads();
    if (!valid) continue;

    for (int c0 = 0; c0 < kv_n; c0 += kStepF32) {
      if (causal && kv0 + c0 > qpos) break;
      float s[kStepF32];
#pragma unroll
      for (int j = 0; j < kStepF32; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int j = 0; j < kStepF32; ++j) {
          const float4 kv4 = *reinterpret_cast<const float4*>(Ks + (c0 + j) * D + d);
          s[j] = fmaf(qr[d], kv4.x, s[j]);
          s[j] = fmaf(qr[d + 1], kv4.y, s[j]);
          s[j] = fmaf(qr[d + 2], kv4.z, s[j]);
          s[j] = fmaf(qr[d + 3], kv4.w, s[j]);
        }
      }
      float mx = m;
#pragma unroll
      for (int j = 0; j < kStepF32; ++j) {
        const int key = kv0 + c0 + j;
        const bool ok = (c0 + j < kv_n) && (!causal || key <= qpos);
        s[j] = ok ? s[j] * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = expf(m - base);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kStepF32; ++j) {
        const float p = expf(s[j] - base);
        s[j] = p;
        l += p;
      }
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int j = 0; j < kStepF32; ++j) {
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + (c0 + j) * D + d);
          acc[d] = fmaf(s[j], v4.x, acc[d]);
          acc[d + 1] = fmaf(s[j], v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], v4.w, acc[d + 3]);
        }
      }
    }
  }

  if (!valid) return;
  const float lv = l == 0.f ? 1.f : l;  // a row that saw no key -> 0
  float* orow = o + (static_cast<long long>(b * Hq + h) * Sq + row) * D;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(acc[d] / lv, acc[d + 1] / lv, acc[d + 2] / lv, acc[d + 3] / lv);
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* o, int Hq, int Hkv,
                   int Sq, int Skv, int block_q, int block_kv, int kv_pad, int causal,
                   float scale) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, block_q, block_kv, kv_pad, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  block_q/block_kv are the tile, kv_pad
// the staged key rows, threads and smem_bytes the block's size: all from
// kernels/geometry.py.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      int block_q, int block_kv, int kv_pad, int threads,
                                      int smem_bytes, int causal, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 || block_q <= 0 ||
      block_kv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + block_q - 1) / block_q, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FLASH_CASE(DIM)                                                               \
  case DIM:                                                                                 \
    e = dtype == 1 ? launch<bf16>(flash_fwd_bf16<DIM>, grid, threads, smem_bytes, s, q, k, \
                                  v, o, Hq, Hkv, Sq, Skv, block_q, block_kv, kv_pad,        \
                                  causal, scale)                                            \
                   : launch<float>(flash_fwd_f32<DIM>, grid, threads, smem_bytes, s, q, k, \
                                   v, o, Hq, Hkv, Sq, Skv, block_q, block_kv, kv_pad,       \
                                   causal, scale);                                          \
    break;
  if (dtype == 0 || dtype == 1) {
    switch (D) {
      REPRO_FLASH_CASE(16)
      REPRO_FLASH_CASE(32)
      REPRO_FLASH_CASE(64)
      REPRO_FLASH_CASE(128)
      default:
        break;
    }
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
