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
// loop inside the block, bounded by the causal diagonal, and every query row
// keeps its running max, sum and f32 accumulator in registers (online
// softmax).
//
//  * bf16: a TMA -> wgmma pipeline (csrc/sm90.cuh).  One thread of a
//    producer warpgroup loads the block's Q once, then K and V 64 keys at a
//    time into a ring of stages (block_kv / 64 of them, at least 2: one kv
//    tile in flight) under a "full" mbarrier per stage; it stops at the
//    causal diagonal of the block's last row and at the end of the keys.
//    block_q / 64 consumer warpgroups own 64 query rows each: S = Q.K^T is
//    wgmma m64n64k16 with both operands in shared memory (K as stored,
//    [keys][D], is the K-major B operand); the online softmax runs on the
//    accumulator fragment with quad shuffles, the scale folded into one FMA
//    before each exp2 (ex2.approx.ftz on the SFU); P is rounded to bf16 in
//    registers, where the accumulator fragment is the A fragment, and
//    O += P.V is wgmma m64nDk16 with A from registers and V read [keys][D]
//    as stored through the descriptor's transpose bit.  A warpgroup masks
//    only the 64-key steps that cross its rows' diagonal or the end of the
//    keys, skips the steps right of its last row, and frees each stage on
//    its "empty" mbarrier.  Tiles are TMA's swizzled rows of min(2D, 128)
//    bytes; 3D tensor maps over (D, S, B*H) zero-fill rows past the
//    sequence without crossing into the next head.  setmaxnreg moves the
//    producer's registers to the consumers (24 -> 112 at head_dim <= 64,
//    block_q <= 256; 40 -> 232 at head_dim 128 and 160, block_q <= 128).  P is
//    rounded to bf16 for the second product (the TPU kernel kept it in
//    f32); chip_smoke.py holds it to 5e-2 per element and 1e-2 in norm
//    relative to the plain version's output.
//  * head_dim 160 (stablelm-12b), bf16: the tile is stored at its true
//    width in five 32-element chunks under the 64-byte swizzle, not padded to
//    192.  O += P.V reads V MN-major, and a wgmma's N must then be whole
//    swizzle chunks: 64 elements at the 128-byte swizzle, which 160 is not a
//    multiple of, but 32 at the 64-byte one, so P.V is one m64n160k16 and
//    Q.K^T ten k-steps, with no padded column to zero-fill, compute or keep
//    out of the store.  A 64-row tile is 20,480 bytes (24,576 padded), so
//    (128, 256) fits a block (205,896 bytes; 238,664 padded would not).  The
//    O accumulator is 80 f32 a thread, within the consumers' 232 registers.
//    Bound: operations, as at 128 (4 S^2/2 D Hq: 0.174 ms at
//    (1,32,8,4096,4096,160) on the bf16 tensor cores' 989 TFLOP/s).
//  * f32: one thread per query row in true f32 on the CUDA cores (no TF32),
//    16 keys per softmax step, for the 2e-5 tolerance of the f32 tests.  At
//    head_dim 160 a row's query and accumulator (320 floats) would not fit a
//    thread's 255 registers, so two threads share a row, 80 columns each;
//    their partial scores meet by one shuffle, and both run the row's
//    softmax.
//
// lse: where the caller passes it (training: the backward kernel,
// csrc/flash_attention_backward.cu, reads it), each row's log-sum-exp of its
// scaled scores, m + log(l) in natural-log units, (B,Hq,Sq) f32, written in
// the epilogue from the running max and sum the rows already hold; -inf for
// a row that sees no key.  Serving passes null and writes nothing more.
//
// The tile is the caller's (the plan's): the wrapper passes block_q,
// block_kv, the key rows the ring holds, the thread count and the
// shared-memory size (kernels/geometry.py), and the launcher checks them
// against its own arithmetic; a ragged sequence is masked here, never
// padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSub = 64;        // bf16: keys per ring stage and online-softmax step
constexpr int kWgRows = 64;     // bf16: query rows of one consumer warpgroup
constexpr int kStepF32 = 16;    // f32: keys per online-softmax step
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreadsF32 = 256;
constexpr int kSmemPerBlock = 232448;

// The bf16 kernel's shape at head_dim D.
template <int D>
struct Bf16 {
  static constexpr int kMaxConsumers = D > 64 ? 2 : 4;   // block_q <= 128 or 256
  static constexpr int kThreads = 128 * (kMaxConsumers + 1);
  static constexpr int kRegs = D > 64 ? 168 : 96;        // 65,536 / kThreads, rounded down to 8
  static constexpr int kProducerRegs = D > 64 ? 40 : 24;
  static constexpr int kConsumerRegs = D > 64 ? 232 : 112;
  // bytes of a swizzled row chunk: 128 where D is whole 64-element chunks,
  // else 64 (D = 32, 160) or 32 (D = 16)
  static constexpr int kSpan = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int kW = kSpan / 2;                   // head-dim elements of a row chunk
  static constexpr int kTile = kSub * D * 2;             // bytes of 64 rows of Q, K or V
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kMaxConsumers <= kRegs * kThreads,
                "setmaxnreg asks for more registers than the block holds");
};

__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return cdiv(x, m) * m; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU, flushing subnormal results to 0 (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// The blocks' threads, ring and shared memory, as kernels/geometry.py
// computes them.
int bf16_consumers(int block_q) { return cdiv(block_q, kWgRows); }
int bf16_threads(int block_q) { return 128 * (bf16_consumers(block_q) + 1); }
int bf16_kv_pad(int block_kv) { return kSub * (block_kv > kSub ? cdiv(block_kv, kSub) : 2); }
int bf16_smem(int block_q, int block_kv, int D) {
  const int tile = kSub * D * 2, stages = bf16_kv_pad(block_kv) / kSub;
  // alignment slack, Q, the ring of K and V, the Q barrier and two a stage
  return 1024 + bf16_consumers(block_q) * tile + stages * 2 * tile + 8 * (1 + 2 * stages);
}
// f32: threads a query row (two at head_dim 160, see the header)
__host__ __device__ constexpr int f32_lanes(int D) { return D > 128 ? 2 : 1; }
int f32_kv_pad(int block_kv) { return round_up(block_kv, kStepF32); }
int f32_smem(int block_kv, int D) { return 2 * f32_kv_pad(block_kv) * D * 4; }

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA -> wgmma.  Shared memory: Q of every consumer
// warpgroup, then the ring (each stage K then V, 64 keys), then barriers.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Bf16<D>::kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int block_q, int block_kv,
               int kv_pad, int causal, float scale) {
  using K = Bf16<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = sm90::align1024(smem_raw);
  const int consumers = blockDim.x / 128 - 1;
  const int stages = kv_pad / kSub;
  unsigned char* ring = qs + consumers * K::kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + stages * 2 * K::kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + stages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_off = Skv - Sq;
  const int q0 = blockIdx.x * block_q;
  const int q_end = min(q0 + block_q, Sq);
  const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);
  // keys the block reads: its kv tiles, up to the last row's diagonal
  const int kv_end = min(min(Skv, n_tiles * block_kv), causal ? max(q_off + q_end, 0) : Skv);
  const int n_sub = cdiv(kv_end, kSub);

  if (threadIdx.x == 0) {
    sm90::tma_prefetch_map(&qmap);
    sm90::tma_prefetch_map(&kmap);
    sm90::tma_prefetch_map(&vmap);
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * consumers);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<K::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, consumers * K::kTile);
      for (int w = 0; w < consumers; ++w)
        for (int c = 0; c < D / K::kW; ++c)
          sm90::tma_load_3d(qs + w * K::kTile + c * kSub * K::kSpan, &qmap, q_full, c * K::kW,
                            q0 + w * kWgRows, b * Hq + h);
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < n_sub; ++s) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* ks = ring + stage * 2 * K::kTile;
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * K::kTile);
        for (int c = 0; c < D / K::kW; ++c) {
          sm90::tma_load_3d(ks + c * kSub * K::kSpan, &kmap, &full[stage], c * K::kW, s * kSub,
                            b * Hkv + hk);
          sm90::tma_load_3d(ks + K::kTile + c * kSub * K::kSpan, &vmap, &full[stage], c * K::kW,
                            s * kSub, b * Hkv + hk);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    sm90::setmaxnreg_inc<K::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int w0 = q0 + cw * kWgRows;  // first query row of this warpgroup
    const int ra = w0 + (threadIdx.x / 32) % 4 * 16 + g, rb = ra + 8;
    const int w_last = min(w0 + kWgRows, q_end) - 1;  // its last row that is the block's
    const int w_kv_end = w_last < w0 ? 0 : causal ? min(kv_end, q_off + w_last + 1) : kv_end;
    const unsigned char* qw = qs + cw * K::kTile;
    constexpr uint32_t swz = sm90::swizzle_code(K::kSpan);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max (of the scaled scores, log2 domain) and sum of rows ra and rb
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const float sl2 = scale * kLog2e;

    sm90::mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < n_sub; ++s) {
      sm90::mbar_wait(&full[stage], phase);
      const int key0 = s * kSub;
      if (key0 < w_kv_end) {  // steps right of this warpgroup's rows are skipped
        const unsigned char* ks = ring + stage * 2 * K::kTile;
        const unsigned char* vs = ks + K::kTile;
        float sc[kSub / 2];  // S: 64 rows x 64 keys
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = kk * 16 / K::kW * kSub * K::kSpan + kk * 16 % K::kW * 2;
          sm90::wgmma_ss<0, 0>(sc, sm90::make_desc(qw + off, 16, 8 * K::kSpan, swz),
                               sm90::make_desc(ks + off, 16, 8 * K::kSpan, swz), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);

        const bool masked = key0 + kSub > Skv || (causal && key0 + kSub - 1 > q_off + w0);
        if (masked) {
#pragma unroll
          for (int i = 0; i < kSub / 2; ++i) {
            const int key = key0 + i / 4 * 8 + 2 * t4 + (i & 1);
            const int row = (i & 2) ? rb : ra;
            if (key >= Skv || (causal && key > q_off + row)) sc[i] = -INFINITY;
          }
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx_a = fmaxf(m_a, quad_max(mx_a) * sl2);
        mx_b = fmaxf(m_b, quad_max(mx_b) * sl2);
        // a row that has seen no key yet keeps max -inf: exponentiate against 0
        const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
        const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
        const float alpha_a = fast_exp2(m_a - base_a), alpha_b = fast_exp2(m_b - base_b);
        m_a = mx_a;
        m_b = mx_b;
        l_a *= alpha_a;
        l_b *= alpha_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= alpha_a;
          acc[4 * j + 1] *= alpha_a;
          acc[4 * j + 2] *= alpha_b;
          acc[4 * j + 3] *= alpha_b;
        }

        // P in bf16: the accumulator fragment of keys 16kk..16kk+15 is the
        // A fragment of k-step kk
        uint32_t pa[kSub / 16][4];
#pragma unroll
        for (int i = 0; i < kSub / 2; i += 2) {
          const float nb = (i & 2) ? -base_b : -base_a;
          const float p0 = fast_exp2(fmaf(sc[i], sl2, nb)), p1 = fast_exp2(fmaf(sc[i + 1], sl2, nb));
          if (i & 2) l_b += p0 + p1;
          else l_a += p0 + p1;
          pa[i / 8][i % 8 / 2] = pack_bf16(p0, p1);
        }

        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)  // V is MN-major: a k-step is 16 rows
          sm90::wgmma_rs<1>(acc, pa[kk],
                            sm90::make_desc(vs + kk * 16 * K::kSpan, kSub * K::kSpan,
                                            8 * K::kSpan, swz),
                            1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);  // a row that saw no key -> 0
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
    if (lse != nullptr && t4 == 0) {  // m is in log2 units: lse = (m + log2 l) ln 2
      float* lb = lse + static_cast<long long>(b * Hq + h) * Sq;
      if (ra < q_end) lb[ra] = l_a == 0.f ? -INFINITY : (m_a + log2f(l_a)) * kLn2;
      if (rb < q_end) lb[rb] = l_b == 0.f ? -INFINITY : (m_b + log2f(l_b)) * kLn2;
    }
    bf16* ob = o + static_cast<long long>(b * Hq + h) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (ra < q_end)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(ra) * D + c) =
            pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (rb < q_end)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(rb) * D + c) =
            pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: one thread per query row, true f32 FMAs.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int Hq,
              int Hkv, int Sq, int Skv, int block_q, int block_kv, int kv_pad, int causal,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kv_pad][D]
  float* Vs = Ks + kv_pad * D;                       // [kv_pad][D]

  constexpr int kLanes = f32_lanes(D), kDL = D / kLanes;  // threads a row, columns a thread
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_off = Skv - Sq;
  const int q0 = blockIdx.x * block_q;
  const int q_end = min(q0 + block_q, Sq);
  const int row = q0 + threadIdx.x / kLanes;
  const int col0 = threadIdx.x % kLanes * kDL;  // this thread's first column
  const bool valid = row < q_end;
  const int qpos = q_off + row;
  // the two threads of a row (neighbouring lanes), for the shuffle of scores
  const unsigned pair = 3u << (threadIdx.x % 32 & ~1);

  const float* kb = k + static_cast<long long>(b * Hkv + hk) * Skv * D;
  const float* vbase = v + static_cast<long long>(b * Hkv + hk) * Skv * D;

  float qr[kDL], acc[kDL];
#pragma unroll
  for (int d = 0; d < kDL; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid)
      x = *reinterpret_cast<const float4*>(q + (static_cast<long long>(b * Hq + h) * Sq + row) * D +
                                           col0 + d);
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
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int j = 0; j < kStepF32; ++j) {
          const float4 kv4 = *reinterpret_cast<const float4*>(Ks + (c0 + j) * D + col0 + d);
          s[j] = fmaf(qr[d], kv4.x, s[j]);
          s[j] = fmaf(qr[d + 1], kv4.y, s[j]);
          s[j] = fmaf(qr[d + 2], kv4.z, s[j]);
          s[j] = fmaf(qr[d + 3], kv4.w, s[j]);
        }
      }
      if (kLanes == 2) {  // the row's other 80 columns
#pragma unroll
        for (int j = 0; j < kStepF32; ++j) s[j] += __shfl_xor_sync(pair, s[j], 1);
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
      for (int d = 0; d < kDL; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kStepF32; ++j) {
        const float p = expf(s[j] - base);
        s[j] = p;
        l += p;
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int j = 0; j < kStepF32; ++j) {
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + (c0 + j) * D + col0 + d);
          acc[d] = fmaf(s[j], v4.x, acc[d]);
          acc[d + 1] = fmaf(s[j], v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], v4.w, acc[d + 3]);
        }
      }
    }
  }

  if (!valid) return;
  if (lse != nullptr && col0 == 0)
    lse[static_cast<long long>(b * Hq + h) * Sq + row] = l == 0.f ? -INFINITY : m + logf(l);
  const float lv = l == 0.f ? 1.f : l;  // a row that saw no key -> 0
  float* orow = o + (static_cast<long long>(b * Hq + h) * Sq + row) * D + col0;
#pragma unroll
  for (int d = 0; d < kDL; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(acc[d] / lv, acc[d + 1] / lv, acc[d + 2] / lv, acc[d + 3] / lv);
}

template <int D>
cudaError_t launch_f32(dim3 grid, int threads, int smem, cudaStream_t stream, const void* q,
                       const void* k, const void* v, void* o, float* lse, int Hq, int Hkv, int Sq,
                       int Skv,
                       int block_q, int block_kv, int kv_pad, int causal, float scale) {
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<D><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Hq, Hkv, Sq, Skv, block_q, block_kv, kv_pad, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(dim3 grid, int threads, int smem, cudaStream_t stream, const void* q,
                        const void* k, const void* v, void* o, float* lse, int B, int Hq, int Hkv,
                        int Sq, int Skv, int block_q, int block_kv, int kv_pad, int causal,
                        float scale) {
  using K = Bf16<D>;
  if (bf16_consumers(block_q) > K::kMaxConsumers) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;  // boxes of 64 rows x one swizzled row chunk
  cudaError_t e = sm90::encode_bf16_3d(&qmap, q, D, Sq, static_cast<uint64_t>(B) * Hq, K::kW, kSub);
  if (e == cudaSuccess)
    e = sm90::encode_bf16_3d(&kmap, k, D, Skv, static_cast<uint64_t>(B) * Hkv, K::kW, kSub);
  if (e == cudaSuccess)
    e = sm90::encode_bf16_3d(&vmap, v, D, Skv, static_cast<uint64_t>(B) * Hkv, K::kW, kSub);
  if (e != cudaSuccess) return e;
  static const cudaError_t ready = [] {  // once per head_dim
    const cudaError_t r = sm90::check_registers(flash_fwd_bf16<D>, K::kRegs);
    if (r != cudaSuccess) return r;
    return cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemPerBlock);
  }();
  if (ready != cudaSuccess) return ready;
  flash_fwd_bf16<D><<<grid, threads, smem, stream>>>(qmap, kmap, vmap, static_cast<bf16*>(o), lse,
                                                     Hq, Hkv, Sq, Skv, block_q, block_kv, kv_pad,
                                                     causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: null, or (B,Hq,Sq) f32 to hold each
// row's log-sum-exp (for the backward).  block_q/block_kv are the tile, kv_pad
// the key rows staged at a time, threads and smem_bytes the block's size:
// all from kernels/geometry.py; a size that disagrees with this file's
// arithmetic is refused.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      int block_q, int block_kv, int kv_pad, int threads,
                                      int smem_bytes, int causal, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 || block_q <= 0 ||
      block_kv <= 0 || smem_bytes > kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 ? (threads != bf16_threads(block_q) || kv_pad != bf16_kv_pad(block_kv) ||
                    smem_bytes != bf16_smem(block_q, block_kv, D))
                 : (dtype != 0 || threads != block_q * f32_lanes(D) || threads > kThreadsF32 ||
                    kv_pad != f32_kv_pad(block_kv) || smem_bytes != f32_smem(block_kv, D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + block_q - 1) / block_q, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FLASH_CASE(DIM)                                                               \
  case DIM:                                                                                 \
    e = dtype == 1 ? launch_bf16<DIM>(grid, threads, smem_bytes, s, q, k, v, o, lf, B, Hq,  \
                                      Hkv, Sq, Skv, block_q, block_kv, kv_pad, causal,      \
                                      scale)                                                \
                   : launch_f32<DIM>(grid, threads, smem_bytes, s, q, k, v, o, lf, Hq, Hkv, \
                                     Sq, Skv, block_q, block_kv, kv_pad, causal, scale);    \
    break;
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(160)
    default:
      break;
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
