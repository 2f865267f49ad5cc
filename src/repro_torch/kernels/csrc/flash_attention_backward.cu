// Causal GQA flash-attention backward for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel `flash_attention` / `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:29-153, which is forward-only (the JAX
// package takes its gradient with jax.vjp of `ref.attention`, and this
// kernel is held to that).  q (B,Hq,Sq,D), k and v (B,Hkv,Skv,D), dout
// (B,Hq,Sq,D), all contiguous, and lse (B,Hq,Sq) f32: each row's log-sum-exp
// of its scaled scores in natural-log units, which the forward kernel
// (csrc/flash_attention.cu) writes when asked.  q-head h reads kv-head
// h / (Hq/Hkv); the queries sit at the last Sq positions of the Skv keys;
// scale is D**-0.5.  With P = exp(scale * q k^T - lse), dP = dout v^T and
// Delta = rowsum(P * dP):  dv = P^T dout,  dS = P * (dP - Delta),
// dq = scale * dS k,  dk = scale * dS^T q, the group's q-heads summed into
// their kv-head.  A row that sees no key (lse = -inf) gives no gradient.
// Delta is summed from the P and dP the kernel itself computes, not taken
// as rowsum(dout * o) from the bf16 output: o rounded to bf16 (and P rounded
// to bf16 in the forward's second product) moves Delta by ~2^-9 of dP, and
// on a row whose softmax is near one-hot dP - Delta is smaller than that
// (a row error of 0.996 when it was tried).
//
// Bound: operations.  The five products do 10 * D operations a visible
// (query, key) pair a q-head: at (1,16,8,4096,4096,64) causal 85.9 GFLOP,
// 0.087 ms at 989 TFLOP/s bf16.  This design runs nine (below), 0.156 ms
// at that rate.
//
// Design (FlashAttention-2's split of the work, FlashAttention-3's pipeline),
// two launches on one stream, no atomics, so two calls give bit-equal
// gradients:
//   1. the dQ kernel, a block a 128-row q tile of a q head (two consumer
//      warpgroups of 64 rows), walks the kv tiles up to the causal diagonal
//      twice: walk 1 takes S = Q.K^T and dP = dO.V^T and sums Delta =
//      rowsum(P * dP) on the accumulator fragment (quad shuffles), then
//      writes Delta and lse in log2 units to a scratch padded to 64 rows a
//      head (+inf and 0 past Sq); walk 2 takes S and dP again, dS = P (dP -
//      Delta) and dQ += dS.K;
//   2. the dK/dV kernel, a block a 128-key tile of a kv head (two consumer
//      warpgroups of 64 keys), holds K and V and walks the group's q-heads
//      and their q tiles from the causal diagonal down: S^T = K.Q^T and
//      dP^T = V.dO^T, P^T and dS^T = P^T (dP^T - Delta) with lse and Delta a
//      column each, then dV += P^T.dO and dK += dS^T.Q; the group's sum
//      stays in registers and each output element has one writer.
//   Nine products in all against the minimum five: the price of Delta from
//   P and dP and of dQ without atomics.
//  * bf16: both kernels are TMA -> wgmma pipelines on csrc/sm90.cuh, shaped
//    as the forward: one producer warpgroup (one thread issues every load)
//    loads the block's own rows once (Q and dO, or K and V) and streams the
//    other side through a ring of four stages under full / empty mbarriers
//    (dQ: K and V 64 keys a stage; dK/dV: Q, dO and, by a bulk copy, their
//    rows' lse and Delta from the scratch); setmaxnreg moves its registers to
//    the two consumers (40 -> 232) (not at head_dim 160's one-consumer dK/dV
//    block, below).  Products with both operands as stored
//    are wgmma_ss (K-major: K, Q, V and dO rows over the head dimension);
//    the products over rows take P, P^T, dS or dS^T from registers, where
//    the accumulator fragment is the A fragment (rounded to bf16, as the
//    forward rounds P), and read dO, Q or K [rows][D] as stored through the
//    descriptor's transpose bit (wgmma_rs).  3D tensor maps over (D, S,
//    B*H) zero-fill rows past the sequence without crossing into the next
//    head.  A warpgroup skips the tiles wholly beyond its diagonal and masks
//    only the tiles that cross it.  The causally heavy tiles launch first:
//    the tile index is the grid's slowest axis, reversed for the dQ kernel
//    (its last q tiles see the most keys).  At head_dim 128 the dK/dV ring
//    stages 16 q rows, so that dK and dV (64 registers each), S^T and dP^T
//    fit the 168 registers ptxas allocates a thread (the launch bound's
//    share: a consumer's setmaxnreg does not raise what it compiles for).
//  * head_dim 160 (stablelm-12b), bf16: tiles at their true width in five
//    32-element chunks under the 64-byte swizzle, as the forward's (a wgmma
//    N over an MN-major operand must be whole swizzle chunks, and 160 is no
//    multiple of the 128-byte swizzle's 64); dV += P^T.dO, dK += dS^T.Q and
//    dQ += dS.K are each one m64n160k16 a k-step.  Registers decide the
//    rest.  A dK/dV thread holds dK and dV at 80 floats each: 160 before
//    S^T and dP^T (8 + 8 at 16 q rows a stage), over the 168 a thread
//    compiles for at 384 threads.  So the dK/dV block at 160 is one
//    consumer warpgroup of 64 keys and the producer (256 threads, launch
//    bound (256, 1): ptxas may take up to 255 registers, and no setmaxnreg
//    is needed) -- option (a) of three: (b) dV and dK in two passes over
//    the q tiles would add an S^T product a tile, and (c) alone does not
//    bring the 160 floats under 168.  The dQ kernel keeps its two consumers
//    at 168 registers and narrows its stage to 32 keys (c): dQ is 80 floats,
//    S and dP of 64 keys would be 32 + 32 more with nothing left to address,
//    at 32 keys they are 16 + 16 (m64n32k16 for S and dP).  Shared memory:
//    dK/dV 83,528 bytes, dQ 164,936; the price is K and V read by twice as
//    many dK/dV blocks' q-tile walks and twice as many dQ stages.
//  * f32: true f32 on the CUDA cores (no TF32), a thread a key (dK/dV) or a
//    query row (dQ), the other side staged 16 rows at a time; at head_dim
//    160 two neighbouring threads a key or row, 80 columns each (a thread's
//    dK and dV, 320 floats, would not fit 255 registers), as the forward's
//    f32 kernel: their partial dot products meet by one shuffle, both take
//    P and dS, each accumulates its own columns.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, in one call of
// scripts/torch_kernel_variants.py: 0.421 ms at (1,16,8,4096,4096,64) (the
// five products' minimum work at 204 TFLOP/s), against PR 20's mma.sync
// body's 0.950 and SDPA's backward alone 0.39.
// What bounds it now: each consumer waits on its own products (no overlap
// of one tile's softmax with the next tile's wgmma inside a warpgroup), and
// the dQ kernel computes S and dP twice.
//
// The tiles are the kernel's own (kernels/geometry.py flash_backward_tiles:
// the plan tunes only the forward's); the launcher checks the wrapper's
// tiles, threads and shared memory against its own arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;         // bf16: rows of a consumer warpgroup (keys in dK/dV, queries in dQ); keys a dQ stage
constexpr int kConsumers = 2;     // bf16: consumer warpgroups a block
constexpr int kBlockRows = kRows * kConsumers;        // keys (dK/dV) or query rows (dQ) a block
constexpr int kThreadsBf16 = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kRegs = 168;        // 65,536 / 384, rounded down to 8: the launch bound's share
constexpr int kProducerRegs = 40;  // its loop over q-heads and tiles needs more than 24
constexpr int kConsumerRegs = 232;
constexpr int kStages = 4;        // bf16: ring stages
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= kRegs * kThreadsBf16,
              "setmaxnreg asks for more registers than the block holds");
constexpr int kThreadsF32 = 64;   // f32: rows a block (a thread a row, two at head_dim 160)
constexpr int kStagedF32 = 16;    // f32: rows of the other side staged at a time
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemDefault = 48 * 1024;

__host__ __device__ constexpr int q_rows_bf16(int D) { return D <= 64 ? 64 : 16; }
// dQ: keys a ring stage; 32 at head_dim 160, where dQ (80 floats a thread)
// beside S and dP of 64 keys (32 + 32) would not fit 168 registers
__host__ __device__ constexpr int dq_keys_bf16(int D) { return D <= 128 ? kRows : 32; }
// dK/dV: consumer warpgroups a block; one at head_dim 160, where dK and dV
// alone are 160 floats a thread (see the header)
__host__ __device__ constexpr int dkdv_consumers(int D) { return D <= 128 ? kConsumers : 1; }
__host__ __device__ constexpr int dkdv_threads_bf16(int D) { return 128 * (dkdv_consumers(D) + 1); }
// f32: threads a row (two at head_dim 160: a row's dK and dV, or dQ, in
// 80-column halves)
__host__ __device__ constexpr int f32_lanes(int D) { return D > 128 ? 2 : 1; }
__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ __forceinline__ int pad_rows(int S) { return cdiv(S, kRows) * kRows; }

// The bf16 kernels' tiles at head_dim D.
template <int D>
struct Bwd {
  // bytes of a swizzled row chunk: 128 where D is whole 64-element chunks,
  // else 64 (D = 32, 160) or 32 (D = 16)
  static constexpr int kSpan = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int kW = kSpan / 2;                 // head-dim elements of a row chunk
  static constexpr int kBQ = q_rows_bf16(D);           // dK/dV: q rows a ring stage
  static constexpr int kQC = dq_keys_bf16(D);          // dQ: keys a ring stage
  static constexpr int kKvConsumers = dkdv_consumers(D);
  static constexpr int kKvThreads = dkdv_threads_bf16(D);
  static constexpr int kTile = kRows * D * 2;          // bytes of 64 rows
  static constexpr int kQTile = kBQ * D * 2;           // bytes of a dK/dV stage's Q (or dO)
  static constexpr int kKTile = kQC * D * 2;           // bytes of a dQ stage's K (or V)
};

// the blocks' shared memory, as kernels/geometry.py computes it: alignment
// slack, the block's own rows, the ring and three barriers a stage's worth
// (one for the own rows, full and empty a stage)
int smem_dkdv_bf16(int D) {
  const int bq = q_rows_bf16(D);
  return 1024 + 2 * kRows * dkdv_consumers(D) * D * 2 + kStages * (2 * bq * D * 2 + 2 * bq * 4) +
         8 * (1 + 2 * kStages);
}
int smem_dq_bf16(int D) {
  return 1024 + 2 * kBlockRows * D * 2 + kStages * 2 * dq_keys_bf16(D) * D * 2 + 8 * (1 + 2 * kStages);
}
int smem_dq_f32(int D) { return 2 * kThreadsF32 * (D + 1) * 4 + 2 * kStagedF32 * D * 4; }
int smem_dkdv_f32(int D) { return smem_dq_f32(D) + 2 * kStagedF32 * 4; }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of k-step kk (16 head-dim elements) in a K-major tile of
// `rows` rows, stored as row chunks of kW elements (each rows x kSpan bytes).
template <int D>
__device__ __forceinline__ int kstep(int kk, int rows) {
  using K = Bwd<D>;
  return kk * 16 / K::kW * rows * K::kSpan + kk * 16 % K::kW * 2;
}

// d (64 x N) = A . B^T over the head dimension, both K-major tiles in shared
// memory: A of 64 rows, B of N = 2 * R rows (R: the accumulator's floats).
template <int D, int R>
__device__ __forceinline__ void product_hd(float (&d)[R], const unsigned char* a, const unsigned char* b) {
  using K = Bwd<D>;
  constexpr uint32_t swz = sm90::swizzle_code(K::kSpan);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss<0, 0>(d, sm90::make_desc(a + kstep<D>(kk, kRows), 16, 8 * K::kSpan, swz),
                         sm90::make_desc(b + kstep<D>(kk, 2 * R), 16, 8 * K::kSpan, swz), kk > 0);
}

// d (64 x D) += A . B over `rows` rows: A the bf16 fragments of a 64 x rows
// accumulator, B a [rows][D] tile as stored (MN-major: the transpose bit).
template <int D, int ROWS>
__device__ __forceinline__ void product_rows(float (&d)[D / 2], const uint32_t (&a)[ROWS / 16][4],
                                             const unsigned char* b) {
  using K = Bwd<D>;
  constexpr uint32_t swz = sm90::swizzle_code(K::kSpan);
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    sm90::wgmma_rs<1>(d, a[kk], sm90::make_desc(b + kk * 16 * K::kSpan, ROWS * K::kSpan, 8 * K::kSpan, swz), 1);
}

// The accumulator fragment of 64 x 2R as the A fragments of its R / 8 k-steps
template <int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[R / 8][4], const float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 2) a[i / 8][i % 8 / 2] = pack_bf16(x[i], x[i + 1]);
}

// One thread issues a stage's loads of `n_chunks` row chunks of a 3D map
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int rows,
                                          int row0, int plane) {
  using K = Bwd<D>;
#pragma unroll
  for (int c = 0; c < D / K::kW; ++c) sm90::tma_load_3d(dst + c * rows * K::kSpan, map, bar, c * K::kW, row0, plane);
}

// ---------------------------------------------------------------------------
// bf16 dQ (and Delta): a block a (128-row q tile, q head, batch).  Shared
// memory: Q and dO of every consumer, the ring (each stage K then V, QC
// keys: 64, 32 at head_dim 160), barriers.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
                  bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  using K = Bwd<D>;
  constexpr int QC = K::kQC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = sm90::align1024(smem_raw);
  unsigned char* os = qs + kConsumers * K::kTile;
  unsigned char* ring = os + kConsumers * K::kTile;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * K::kKTile);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv), q_off = Skv - Sq;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // the last q tiles, which see the most keys, first
  const int q_end = min(q0 + kBlockRows, Sq);
  const int kv_end = causal ? min(Skv, max(q_off + q_end, 0)) : Skv;  // up to the last row's diagonal
  const int n_sub = cdiv(kv_end, QC);

  if (threadIdx.x == 0) {
    sm90::tma_prefetch_map(&qmap);
    sm90::tma_prefetch_map(&omap);
    sm90::tma_prefetch_map(&kmap);
    sm90::tma_prefetch_map(&vmap);
    sm90::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(own_full, 2 * kConsumers * K::kTile);
      for (int w = 0; w < kConsumers; ++w) {
        load_rows<D>(qs + w * K::kTile, &qmap, own_full, kRows, q0 + w * kRows, b * Hq + h);
        load_rows<D>(os + w * K::kTile, &omap, own_full, kRows, q0 + w * kRows, b * Hq + h);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < 2 * n_sub; ++it) {  // the keys twice: walk 1, then walk 2
        const int s = it < n_sub ? it : it - n_sub;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* ks = ring + stage * 2 * K::kKTile;
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * K::kKTile);
        load_rows<D>(ks, &kmap, &full[stage], QC, s * QC, b * Hkv + hk);
        load_rows<D>(ks + K::kKTile, &vmap, &full[stage], QC, s * QC, b * Hkv + hk);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int w0 = q0 + cw * kRows;  // first query row of this warpgroup
    const int ra = w0 + (threadIdx.x / 32) % 4 * 16 + g, rb = ra + 8;
    const int w_last = min(w0 + kRows, q_end) - 1;  // its last row that is the block's
    const int w_kv_end = w_last < w0 ? 0 : causal ? min(kv_end, q_off + w_last + 1) : kv_end;
    const long long qrow = static_cast<long long>(b * Hq + h) * Sq;
    // lse in log2 units; +inf (so P = 0) past Sq and for a row that sees no key
    const float la = ra < Sq ? lse[qrow + ra] : -INFINITY, lb = rb < Sq ? lse[qrow + rb] : -INFINITY;
    const float l2a = la == -INFINITY ? INFINITY : la * kLog2e;
    const float l2b = lb == -INFINITY ? INFINITY : lb * kLog2e;
    const unsigned char* qw = qs + cw * K::kTile;
    const unsigned char* ow = os + cw * K::kTile;
    const float sl2 = scale * kLog2e;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float dl_a = 0.f, dl_b = 0.f;  // Delta of rows ra and rb
    sm90::mbar_wait(own_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    // P (in sc) and dP of the warpgroup's rows against the stage's keys
    float sc[QC / 2], dp[QC / 2];
    auto scores = [&](int key0, const unsigned char* ks) {
      sm90::wgmma_fence();
      product_hd<D>(sc, qw, ks);
      product_hd<D>(dp, ow, ks + K::kKTile);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      const bool masked = key0 + QC > Skv || (causal && key0 + QC - 1 > q_off + w0);
#pragma unroll
      for (int i = 0; i < QC / 2; ++i) {
        float p = fast_exp2(fmaf(sc[i], sl2, (i & 2) ? -l2b : -l2a));
        if (masked) {
          const int key = key0 + i / 4 * 8 + 2 * t4 + (i & 1);
          if (key >= Skv || (causal && key > q_off + ((i & 2) ? rb : ra))) p = 0.f;
        }
        sc[i] = p;
      }
    };
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    // walk 1: Delta = rowsum(P * dP)
    for (int s = 0; s < n_sub; ++s) {
      sm90::mbar_wait(&full[stage], phase);
      if (s * QC < w_kv_end) {  // tiles right of this warpgroup's rows are skipped
        scores(s * QC, ring + stage * 2 * K::kKTile);
#pragma unroll
        for (int j = 0; j < QC / 8; ++j) {
          dl_a = fmaf(sc[4 * j], dp[4 * j], fmaf(sc[4 * j + 1], dp[4 * j + 1], dl_a));
          dl_b = fmaf(sc[4 * j + 2], dp[4 * j + 2], fmaf(sc[4 * j + 3], dp[4 * j + 3], dl_b));
        }
      }
      release();
    }
    dl_a = quad_sum(dl_a);
    dl_b = quad_sum(dl_b);
    if (t4 == 0 && w0 < Sq) {  // one writer a row, every row below the 64-row padding
      const long long prow = static_cast<long long>(b * Hq + h) * pad_rows(Sq);
      lse2[prow + ra] = l2a;
      lse2[prow + rb] = l2b;
      delta[prow + ra] = dl_a;
      delta[prow + rb] = dl_b;
    }

    // walk 2: dS = P (dP - Delta), dQ += dS.K
    for (int s = 0; s < n_sub; ++s) {
      sm90::mbar_wait(&full[stage], phase);
      if (s * QC < w_kv_end) {
        const unsigned char* ks = ring + stage * 2 * K::kKTile;
        scores(s * QC, ks);
#pragma unroll
        for (int i = 0; i < QC / 2; ++i) sc[i] *= dp[i] - ((i & 2) ? dl_b : dl_a);
        uint32_t da[QC / 16][4];
        to_a(da, sc);
        sm90::wgmma_fence();
        product_rows<D, QC>(acc, da, ks);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      release();
    }

    bf16* out = dq + qrow * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(ra) * D + c) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (rb < Sq)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(rb) * D + c) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK / dV: a block a (64-key tile a consumer, kv head, batch): 128
// keys, 64 at head_dim 160 (one consumer, no setmaxnreg).  Shared memory: K
// and V of every consumer, the ring (each stage Q then dO, BQ rows), the
// ring's lse and Delta (a stage: BQ of each), barriers.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Bwd<D>::kKvThreads, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  using K = Bwd<D>;
  constexpr int BQ = K::kBQ, NC = K::kKvConsumers;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = sm90::align1024(smem_raw);
  unsigned char* vs = ks + NC * K::kTile;
  unsigned char* ring = vs + NC * K::kTile;
  float* lsd = reinterpret_cast<float*>(ring + kStages * 2 * K::kQTile);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(lsd + kStages * 2 * BQ);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kStages;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kRows * NC;  // kv tile 0, which every q tile sees, first
  const int groups = Hq / Hkv, q_off = Skv - Sq;
  // the q tiles from the first with a row that sees key k0 (the causal
  // diagonal) to the end, for each of the group's q-heads: the group's sum
  const int qt0 = (causal ? max(0, k0 - q_off) : 0) / BQ;
  const int nq = max(0, cdiv(Sq, BQ) - qt0);
  const int steps = groups * nq;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch_map(&kmap);
    sm90::tma_prefetch_map(&vmap);
    sm90::tma_prefetch_map(&qmap);
    sm90::tma_prefetch_map(&omap);
    sm90::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * NC);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (NC > 1) sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(own_full, 2 * NC * K::kTile);
      for (int w = 0; w < NC; ++w) {
        load_rows<D>(ks + w * K::kTile, &kmap, own_full, kRows, k0 + w * kRows, b * Hkv + hk);
        load_rows<D>(vs + w * K::kTile, &vmap, own_full, kRows, k0 + w * kRows, b * Hkv + hk);
      }
      const int q_pad = pad_rows(Sq);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        const int hq = b * Hq + hk * groups + it / nq, qr0 = (qt0 + it % nq) * BQ;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* qsm = ring + stage * 2 * K::kQTile;
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * K::kQTile + 2 * BQ * 4);
        load_rows<D>(qsm, &qmap, &full[stage], BQ, qr0, hq);
        load_rows<D>(qsm + K::kQTile, &omap, &full[stage], BQ, qr0, hq);
        const long long at = static_cast<long long>(hq) * q_pad + qr0;
        sm90::bulk_load(lsd + stage * 2 * BQ, lse2 + at, BQ * 4, &full[stage]);
        sm90::bulk_load(lsd + stage * 2 * BQ + BQ, delta + at, BQ * 4, &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 keys each
    if constexpr (NC > 1) sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int wk0 = k0 + cw * kRows;  // first key of this warpgroup
    const int ra = wk0 + (threadIdx.x / 32) % 4 * 16 + g, rb = ra + 8;
    const unsigned char* kw = ks + cw * K::kTile;
    const unsigned char* vw = vs + cw * K::kTile;
    const float sl2 = scale * kLog2e;

    float adk[D / 2], adv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
    sm90::mbar_wait(own_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < steps; ++it) {
      const int qr0 = (qt0 + it % nq) * BQ;
      sm90::mbar_wait(&full[stage], phase);
      // tiles whose rows all lie above this warpgroup's keys' diagonal, and
      // keys past Skv, are skipped
      if (wk0 < Skv && (!causal || q_off + qr0 + BQ - 1 >= wk0)) {
        const unsigned char* qsm = ring + stage * 2 * K::kQTile;
        const unsigned char* osm = qsm + K::kQTile;
        const float* lsm = lsd + stage * 2 * BQ;  // lse2 (+inf past Sq), then Delta (0 past Sq)
        float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: 64 keys x BQ query rows
        sm90::wgmma_fence();
        product_hd<D>(st, kw, qsm);
        product_hd<D>(dpt, vw, osm);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        const bool masked = causal && q_off + qr0 < wk0 + kRows - 1;
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int col = i / 4 * 8 + 2 * t4 + (i & 1);  // query row in the tile
          float p = fast_exp2(fmaf(st[i], sl2, -lsm[col]));
          if (masked && ((i & 2) ? rb : ra) > q_off + qr0 + col) p = 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - lsm[BQ + col]);
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        to_a(pa, st);
        to_a(da, dpt);
        sm90::wgmma_fence();
        product_rows<D, BQ>(adv, pa, osm);
        product_rows<D, BQ>(adk, da, qsm);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(adv);
        sm90::fence_regs(adk);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (ra < Skv) {
        const long long at = kvbase + static_cast<long long>(ra) * D + c;
        *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(adk[4 * j] * scale, adk[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(adv[4 * j], adv[4 * j + 1]);
      }
      if (rb < Skv) {
        const long long at = kvbase + static_cast<long long>(rb) * D + c;
        *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(adk[4 * j + 2] * scale, adk[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(adv[4 * j + 2], adv[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: a thread a key (dK / dV) or a query row (dQ), true f32 FMAs; at
// head_dim 160 two neighbouring threads a row, 80 columns each, whose
// partial dot products meet by one shuffle
// ---------------------------------------------------------------------------
// rows [r0, r0 + n) of one head's (S, D) rows into a [n][ld] tile, zero past S
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, int r0, int n, int S,
                                          int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r0 + r < S ? src[static_cast<long long>(r0 + r) * D + c] : 0.f;
  }
}

// the row's whole dot product from its lanes' partial ones (every thread of
// the block calls it: the loops around it are uniform)
template <int D>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (f32_lanes(D) == 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// A thread's partial S and dP of a staged row (q, o) against its own key
// (k, v), over its kDL columns.  At head_dim 160 the loop stays rolled:
// fully unrolled, the compiler keeps the key's K and V columns in
// registers across the staged rows, 160 floats beside dK and dV's 160, and
// ptxas spilled 1.7 KB a thread: two lanes a row unroll by 4, one fully.
template <int D>
__device__ __forceinline__ void dot_own_row(const float* q, const float* k, const float* o, const float* v,
                                            float& s, float& dp) {
  constexpr int kDL = D / f32_lanes(D);
  constexpr int kUnroll = f32_lanes(D) == 2 ? 4 : kDL;
  s = dp = 0.f;
#pragma unroll (kUnroll)
  for (int d = 0; d < kDL; ++d) {
    s = fmaf(q[d], k[d], s);
    dp = fmaf(o[d], v[d], dp);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32 * f32_lanes(D))
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                   int causal, float scale) {
  constexpr int LP = D + 1;  // the block's own rows, padded: thread i reads row i
  constexpr int kDL = D / f32_lanes(D);  // columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kThreadsF32 * LP;
  float* Qs = Vs + kThreadsF32 * LP;
  float* Os = Qs + kStagedF32 * D;
  float* Ls = Os + kStagedF32 * D;  // natural units, +inf for a row that sees no key
  float* Ds = Ls + kStagedF32;

  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kThreadsF32;
  const int groups = Hq / Hkv, q_off = Skv - Sq;
  const int t = threadIdx.x / f32_lanes(D), c0 = threadIdx.x % f32_lanes(D) * kDL;  // key, first column
  const int key = k0 + t;
  const bool valid = key < Skv;
  const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
  stage_f32(Ks, LP, k + kvbase, k0, kThreadsF32, Skv, D);
  stage_f32(Vs, LP, v + kvbase, k0, kThreadsF32, Skv, D);
  float ak[kDL], av[kDL];
#pragma unroll
  for (int d = 0; d < kDL; ++d) ak[d] = av[d] = 0.f;
  const int i0 = causal ? max(0, k0 - q_off) : 0;

  for (int hh = 0; hh < groups; ++hh) {
    const long long qrow = static_cast<long long>(b * Hq + hk * groups + hh) * Sq;
    for (int q0 = i0 / kStagedF32 * kStagedF32; q0 < Sq; q0 += kStagedF32) {
      __syncthreads();
      stage_f32(Qs, D, q + qrow * D, q0, kStagedF32, Sq, D);
      stage_f32(Os, D, dout + qrow * D, q0, kStagedF32, Sq, D);
      for (int i = threadIdx.x; i < kStagedF32; i += blockDim.x) {
        const bool in = q0 + i < Sq;
        const float l = in ? lse[qrow + q0 + i] : -INFINITY;
        Ls[i] = l == -INFINITY ? INFINITY : l;
        Ds[i] = in ? delta[qrow + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kStagedF32 && q0 + r < Sq; ++r) {
        float s, dp;
        dot_own_row<D>(Qs + r * D + c0, Ks + t * LP + c0, Os + r * D + c0, Vs + t * LP + c0, s, dp);
        s = row_sum<D>(s);
        dp = row_sum<D>(dp);
        const bool seen = valid && (!causal || key <= q_off + q0 + r);
        const float p = seen ? expf(s * scale - Ls[r]) : 0.f;
        const float ds = p * (dp - Ds[r]);
#pragma unroll
        for (int d = 0; d < kDL; ++d) {
          av[d] = fmaf(p, Os[r * D + c0 + d], av[d]);
          ak[d] = fmaf(ds, Qs[r * D + c0 + d], ak[d]);
        }
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int d = 0; d < kDL; ++d) {
    dk[kvbase + static_cast<long long>(key) * D + c0 + d] = ak[d] * scale;
    dv[kvbase + static_cast<long long>(key) * D + c0 + d] = av[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32 * f32_lanes(D))
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int LP = D + 1;
  constexpr int kDL = D / f32_lanes(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kThreadsF32 * LP;
  float* Ks = Os + kThreadsF32 * LP;
  float* Vs = Ks + kStagedF32 * D;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kThreadsF32;
  const int hk = h / (Hq / Hkv), q_off = Skv - Sq;
  const int t = threadIdx.x / f32_lanes(D), c0 = threadIdx.x % f32_lanes(D) * kDL;  // row, first column
  const int row = q0 + t;
  const bool valid = row < Sq;
  const long long qrow = static_cast<long long>(b * Hq + h) * Sq;
  const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
  stage_f32(Qs, LP, q + qrow * D, q0, kThreadsF32, Sq, D);
  stage_f32(Os, LP, dout + qrow * D, q0, kThreadsF32, Sq, D);
  const float l = valid ? lse[qrow + row] : -INFINITY;
  const float lv = l == -INFINITY ? INFINITY : l;
  const int kv_end = causal ? min(Skv, max(q_off + min(q0 + kThreadsF32, Sq), 0)) : Skv;
  // P and dP of the thread's row against key j of the staged tile
  auto pdp = [&](int k0, int j, float& p, float& dp) {
    float s = 0.f;
    dp = 0.f;
#pragma unroll
    for (int d = 0; d < kDL; ++d) {
      s = fmaf(Qs[t * LP + c0 + d], Ks[j * D + c0 + d], s);
      dp = fmaf(Os[t * LP + c0 + d], Vs[j * D + c0 + d], dp);
    }
    s = row_sum<D>(s);
    dp = row_sum<D>(dp);
    const bool seen = valid && (!causal || k0 + j <= q_off + row);
    p = seen ? expf(s * scale - lv) : 0.f;
  };

  float dl = 0.f;  // walk 1: Delta = rowsum(P * dP)
  for (int k0 = 0; k0 < kv_end; k0 += kStagedF32) {
    __syncthreads();
    stage_f32(Ks, D, k + kvbase, k0, kStagedF32, Skv, D);
    stage_f32(Vs, D, v + kvbase, k0, kStagedF32, Skv, D);
    __syncthreads();
    for (int j = 0; j < kStagedF32 && k0 + j < Skv; ++j) {
      float p, dp;
      pdp(k0, j, p, dp);
      dl = fmaf(p, dp, dl);
    }
  }
  float acc[kDL];  // walk 2: dQ
#pragma unroll
  for (int d = 0; d < kDL; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kStagedF32) {
    __syncthreads();
    stage_f32(Ks, D, k + kvbase, k0, kStagedF32, Skv, D);
    stage_f32(Vs, D, v + kvbase, k0, kStagedF32, Skv, D);
    __syncthreads();
    for (int j = 0; j < kStagedF32 && k0 + j < Skv; ++j) {
      float p, dp;
      pdp(k0, j, p, dp);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < kDL; ++d) acc[d] = fmaf(ds, Ks[j * D + c0 + d], acc[d]);
    }
  }
  if (!valid) return;
  if (c0 == 0) delta[qrow + row] = dl;
#pragma unroll
  for (int d = 0; d < kDL; ++d) dq[(qrow + row) * D + c0 + d] = acc[d] * scale;
}

// ---------------------------------------------------------------------------
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int smem) {
  if (smem <= kSmemDefault) return cudaSuccess;  // above 48 KB only after this attribute
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_bf16(int B, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                        cudaStream_t s, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, float* scratch, void* dq, void* dk, void* dv) {
  using K = Bwd<D>;
  const uint64_t bhq = static_cast<uint64_t>(B) * Hq, bhkv = static_cast<uint64_t>(B) * Hkv;
  // boxes of 64 rows x one swizzled row chunk (the blocks' own rows); the
  // dK/dV ring's Q and dO of BQ rows, the dQ ring's K and V of QC rows
  CUtensorMap qmap, omap, kmap, vmap, qmap_bq, omap_bq, kmap_qc, vmap_qc;
  cudaError_t e = sm90::encode_bf16_3d(&qmap, q, D, Sq, bhq, K::kW, kRows);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&omap, dout, D, Sq, bhq, K::kW, kRows);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&kmap, k, D, Skv, bhkv, K::kW, kRows);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&vmap, v, D, Skv, bhkv, K::kW, kRows);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&qmap_bq, q, D, Sq, bhq, K::kW, K::kBQ);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&omap_bq, dout, D, Sq, bhq, K::kW, K::kBQ);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&kmap_qc, k, D, Skv, bhkv, K::kW, K::kQC);
  if (e == cudaSuccess) e = sm90::encode_bf16_3d(&vmap_qc, v, D, Skv, bhkv, K::kW, K::kQC);
  if (e != cudaSuccess) return e;
  static const cudaError_t ready = [] {  // once per head_dim
    cudaError_t r = sm90::check_registers(flash_bwd_dq_bf16<D>, kRegs);
    // the one-consumer dK/dV block runs no setmaxnreg: its registers are
    // whatever ptxas took within the launch bound's 255
    if (r == cudaSuccess && K::kKvConsumers > 1) r = sm90::check_registers(flash_bwd_dkdv_bf16<D>, kRegs);
    if (r == cudaSuccess) r = allow_smem(flash_bwd_dq_bf16<D>, smem_dq_bf16(D));
    return r == cudaSuccess ? allow_smem(flash_bwd_dkdv_bf16<D>, smem_dkdv_bf16(D)) : r;
  }();
  if (ready != cudaSuccess) return ready;
  float* lse2 = scratch;  // then Delta: (B, Hq, Sq padded to 64) each
  float* delta = scratch + bhq * pad_rows(Sq);
  flash_bwd_dq_bf16<D><<<dim3(Hq, B, cdiv(Sq, kBlockRows)), kThreadsBf16, smem_dq_bf16(D), s>>>(
      qmap, omap, kmap_qc, vmap_qc, lse, lse2, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_bf16<D><<<dim3(Hkv, B, cdiv(Skv, kRows * K::kKvConsumers)), K::kKvThreads,
                           smem_dkdv_bf16(D), s>>>(
      kmap, vmap, qmap_bq, omap_bq, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv, Sq,
      Skv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(int B, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                       cudaStream_t s, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk, void* dv) {
  cudaError_t e = allow_smem(flash_bwd_dkdv_f32<D>, smem_dkdv_f32(D));
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_f32<D>, smem_dq_f32(D));
  if (e != cudaSuccess) return e;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
  const int threads = kThreadsF32 * f32_lanes(D);
  flash_bwd_dq_f32<D><<<dim3((Sq + kThreadsF32 - 1) / kThreadsF32, Hq, B), threads, smem_dq_f32(D), s>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), Hq, Hkv, Sq, Skv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32<D><<<dim3((Skv + kThreadsF32 - 1) / kThreadsF32, Hkv, B), threads, smem_dkdv_f32(D),
                          s>>>(qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
                               Hq, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout, dq, dk, dv; lse and
// the scratch are f32).  scratch: allocated by the wrapper, of the floats
// kernels/geometry.py flash_backward_scratch_floats gives (bf16: lse in log2
// units and Delta, each (B, Hq, Sq rounded up to 64); f32: Delta (B, Hq,
// Sq)), which the dQ kernel fills for the dK/dV kernel.  The tiles (dK/dV:
// keys a block, query rows a ring stage or staged; dQ: query rows a block,
// keys a stage), each kernel's threads and shared-memory size come from
// kernels/geometry.py; any that disagrees with this file's arithmetic is
// refused.  Launches two kernels on `stream`; returns cudaGetLastError()
// after the last.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* lse, const void* dout, void* scratch,
    void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, int dkdv_keys,
    int dkdv_rows, int dq_rows, int dq_keys, int dkdv_threads, int dq_threads, int dkdv_smem,
    int dq_smem, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 || (dtype != 0 && dtype != 1) ||
      (D != 16 && D != 32 && D != 64 && D != 128 && D != 160) || dkdv_smem > kSmemPerBlock ||
      dq_smem > kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      dtype == 1
          ? dkdv_keys == kRows * dkdv_consumers(D) && dkdv_rows == q_rows_bf16(D) && dq_rows == kBlockRows &&
                dq_keys == dq_keys_bf16(D) && dkdv_threads == dkdv_threads_bf16(D) &&
                dq_threads == kThreadsBf16 && dkdv_smem == smem_dkdv_bf16(D) && dq_smem == smem_dq_bf16(D)
          : dkdv_keys == kThreadsF32 && dkdv_rows == kStagedF32 && dq_rows == kThreadsF32 &&
                dq_keys == kStagedF32 && dkdv_threads == kThreadsF32 * f32_lanes(D) &&
                dq_threads == dkdv_threads && dkdv_smem == smem_dkdv_f32(D) && dq_smem == smem_dq_f32(D);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FLASH_BWD_CASE(DIM)                                                                \
  case DIM:                                                                                      \
    e = dtype == 1 ? launch_bf16<DIM>(B, Hq, Hkv, Sq, Skv, causal, scale, s, q, k, v, dout, lf, \
                                      sc, dq, dk, dv)                                            \
                   : launch_f32<DIM>(B, Hq, Hkv, Sq, Skv, causal, scale, s, q, k, v, dout, lf,  \
                                     sc, dq, dk, dv);                                            \
    break;
  switch (D) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(160)
    default:
      break;
  }
#undef REPRO_FLASH_BWD_CASE
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
