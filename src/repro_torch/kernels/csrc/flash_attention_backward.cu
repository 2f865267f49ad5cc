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
// on a row whose softmax is near one-hot dP - Delta is smaller than that.
//
// Bound: operations.  The five products do 10 * D operations a visible
// (query, key) pair a q-head: at (1,16,8,4096,4096,64) causal 85.9 GFLOP,
// 0.087 ms at 989 TFLOP/s bf16 (2.5x the forward's).
//
// Design (FlashAttention-2's split), two launches on one stream, no atomics,
// so the result is deterministic:
//   1. the dQ kernel runs one block a (64-row q tile, q head, batch) over
//      the kv tiles up to the causal diagonal, twice: the first walk sums
//      Delta (S and dP), which it also writes (B,Hq,Sq) f32 for step 2;
//      the second recomputes S and dP and sums dQ;
//   2. the dK/dV kernel runs one block a (64-key tile, kv head, batch).  It
//      loops over the group's Hq/Hkv q-heads and over their q tiles from the
//      causal diagonal down, and sums the group's dk and dv in registers, so
//      each output element has one writer.
//   Nine products in all against the minimum five: the price of Delta
//   from P and dP and of dQ without atomics.
//  * bf16: four warps a block, each owning 16 rows (keys in 2, queries in 1)
//    of mma.sync m16n8k16 tiles with f32 accumulators.  The block's own rows
//    are staged in shared memory once; the other side's tiles are double-
//    buffered, the next one loading by cp.async while this one is used.
//    Rows are padded by 16 bytes so that the fragment loads (ldmatrix;
//    .trans for the products over rows) meet no bank conflict; P and dS go
//    from the accumulator
//    fragment to the next product's A fragment in registers (rounded to
//    bf16, as the forward rounds P); exps on ex2.approx with lse taken to
//    log2 units once a row.  At head_dim 128 the staged side is 32 rows, to
//    keep the accumulators in registers.
//  * f32: true f32 on the CUDA cores (no TF32), a thread a key (dK/dV) or a
//    query row (dQ), the other side staged 16 rows at a time.
// What bounds this body, and why a wgmma one is later work: mma.sync is
// run a warp at a time and does not reach the tensor cores' wgmma rate,
// its fragments cost registers (the dK/dV kernel holds two blocks an SM),
// and the dQ kernel computes S and dP twice.  A wgmma body on csrc/sm90.cuh
// (64-row warpgroup tiles with accumulators in registers, Q/dO or K/V
// streamed by TMA into a ring, as in the forward) would lift the first two.
//
// The tiles are the kernel's own (kernels/geometry.py flash_backward_tiles:
// the plan tunes only the forward's); the launcher checks the wrapper's
// tiles, threads and shared memory against its own arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;            // bf16: elements a staged row is padded by
constexpr int kThreadsBf16 = 128;  // four warps of 16 rows
constexpr int kOwnBf16 = 64;       // rows a bf16 block owns
constexpr int kThreadsF32 = 64;    // a thread a row
constexpr int kStagedF32 = 16;     // f32: rows of the other side staged at a time
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemDefault = 48 * 1024;

__host__ __device__ constexpr int staged_bf16(int D) { return D <= 64 ? 64 : 32; }

// the blocks' shared memory, as kernels/geometry.py computes it
// (bf16: the block's own K and V, or Q and dO, once; the other side's tiles
// and, for dK/dV, their lse and Delta, twice: a tile in use, the next in flight)
int smem_dkdv_bf16(int D) {
  return 2 * (kOwnBf16 + 2 * staged_bf16(D)) * (D + kPad) * 2 + 2 * 2 * staged_bf16(D) * 4;
}
int smem_dq_bf16(int D) { return 2 * (kOwnBf16 + 2 * staged_bf16(D)) * (D + kPad) * 2 + 2 * kOwnBf16 * 4; }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a . b, m16n8k16, bf16 inputs, f32 accumulators.  Lane = 4 g + t:
// a holds rows g and g+8, columns 2t, 2t+1 (+8); b holds k rows 2t, 2t+1
// (+8) of column g; c holds rows g (c0, c1) and g+8 (c2, c3), columns 2t, 2t+1.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving a row address of
// matrix l / 8; .trans hands each thread the transposed matrix's fragment.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// A fragment: rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* x, int ld, int r0, int k0, int lane) {
  ldmatrix_x4<false>(a, x + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments (k0..k0+15) of the n-blocks n0 and n0+8 of B = Y^T, Y
// row-major [n][k] (K, V, Q or dO as stored, in a product over the head
// dimension): b[0], b[1] for n0, b[2], b[3] for n0+8
__device__ __forceinline__ void load_bt2(uint32_t* b, const bf16* y, int ld, int n0, int k0, int lane) {
  ldmatrix_x4<false>(b, y + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments (k0..k0+15) of the n-blocks n0 and n0+8 of B = Z, Z row-major
// [k][n] (a product over rows: P^T dO, dS^T Q, dS K), read transposed
__device__ __forceinline__ void load_b2(uint32_t* b, const bf16* z, int ld, int k0, int n0, int lane) {
  ldmatrix_x4<true>(b, z + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// rows [r0, r0 + n) of one head's (S, D) rows into a [n][D + kPad] tile,
// zero past S, in 16-byte vectors
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int n, int S) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < n * V; i += blockDim.x) {
    const int r = i / V, c = (i % V) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) x = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = x;
  }
}

// the same with cp.async (16 bytes a copy, zero-filled past S), so that the
// next tile loads while this one is multiplied; the caller commits the group
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

template <int D>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src, int r0, int n, int S) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < n * V; i += blockDim.x) {
    const int r = i / V, c = (i % V) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + kPad) + c, src + (in ? static_cast<long long>(r0 + r) * D + c : 0), in);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// lse of a row in log2 units, +inf for a row that sees no key (or past Sq):
// exp2(s - that) is then 0
__device__ __forceinline__ float lse_log2(const float* lse, long long at, bool in) {
  const float l = in ? lse[at] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

// ---------------------------------------------------------------------------
// bf16 dK / dV: one block a (64-key tile, kv head, batch)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                    int causal, float scale) {
  constexpr int BC = kOwnBf16, BR = staged_bf16(D), LD = D + kPad, NB = BR / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BC * LD;
  bf16* Qs = Vs + BC * LD;      // two buffers of BR rows
  bf16* Os = Qs + 2 * BR * LD;  // dout, two buffers
  float* Ls = reinterpret_cast<float*>(Os + 2 * BR * LD);
  float* Ds = Ls + 2 * BR;

  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BC;
  const int groups = Hq / Hkv, q_off = Skv - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kw = k0 + warp * 16;  // the warp's first key
  const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
  stage_rows<D>(Ks, k + kvbase, k0, BC, Skv);
  stage_rows<D>(Vs, v + kvbase, k0, BC, Skv);

  float ak[ND][4], av[ND][4];  // dK, dV of the warp's 16 keys
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[i][e] = av[i][e] = 0.f;
  const float sl2 = scale * kLog2e;
  // the q tiles from the first one with a row that sees key k0 (the causal
  // diagonal) to the end, for each of the group's q-heads: the group's sum
  const int qt0 = (causal ? max(0, k0 - q_off) : 0) / BR;
  const int nq = max(0, (Sq + BR - 1) / BR - qt0);
  const int steps = groups * nq;
  auto prefetch = [&](int it) {  // step it's Q, dO, lse and Delta into buffer it % 2
    const int buf = it & 1, q0 = (qt0 + it % nq) * BR;
    const long long qrow = static_cast<long long>(b * Hq + hk * groups + it / nq) * Sq;
    stage_rows_async<D>(Qs + buf * BR * LD, q + qrow * D, q0, BR, Sq);
    stage_rows_async<D>(Os + buf * BR * LD, dout + qrow * D, q0, BR, Sq);
    cp_async_commit();
    for (int i = threadIdx.x; i < BR; i += blockDim.x) {
      const bool in = q0 + i < Sq;
      Ls[buf * BR + i] = lse_log2(lse, qrow + q0 + i, in);
      Ds[buf * BR + i] = in ? delta[qrow + q0 + i] : 0.f;
    }
  };

  if (steps > 0) prefetch(0);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {  // buffer (it + 1) % 2 was last read in step it - 1
      prefetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1, q0 = (qt0 + it % nq) * BR;
    const bf16* Qb = Qs + buf * BR * LD;
    const bf16* Ob = Os + buf * BR * LD;
    const float* Lb = Ls + buf * BR;
    const float* Db = Ds + buf * BR;
    const bool masked = (causal && q_off + q0 < k0 + BC - 1) || q0 + BR > Sq || k0 + BC > Skv;

    float s[NB][4], dp[NB][4];  // S^T and dP^T: the warp's 16 keys x BR query rows
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, warp * 16, kk * 16, lane);
      load_a(va, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bb[4];
        load_bt2(bb, Qb, LD, nb * 8, kk * 16, lane);
        mma16816(s[nb], ka, bb[0], bb[1]);
        mma16816(s[nb + 1], ka, bb[2], bb[3]);
        load_bt2(bb, Ob, LD, nb * 8, kk * 16, lane);
        mma16816(dp[nb], va, bb[0], bb[1]);
        mma16816(dp[nb + 1], va, bb[2], bb[3]);
      }
    }
    // P^T = exp(S^T - lse), then dS^T = P^T (dP^T - Delta)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nb * 8 + 2 * t + (e & 1);  // query row in the tile
        const int key = kw + g + (e >> 1) * 8;
        float p = fast_exp2(fmaf(s[nb][e], sl2, -Lb[r]));
        if (masked && (key >= Skv || q0 + r >= Sq || (causal && key > q_off + q0 + r))) p = 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - Db[r]);
      }
    // dV += P^T dout and dK += dS^T q: the accumulator fragments of query
    // rows 16kk..16kk+15 are the A fragments of k-step kk
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bb[4];
        load_b2(bb, Ob, LD, kk * 16, nd * 8, lane);
        mma16816(av[nd], pa, bb[0], bb[1]);
        mma16816(av[nd + 1], pa, bb[2], bb[3]);
        load_b2(bb, Qb, LD, kk * 16, nd * 8, lane);
        mma16816(ak[nd], da, bb[0], bb[1]);
        mma16816(ak[nd + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this step's buffer is free for step it + 2
  }

  const int ra = kw + g, rb = ra + 8;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < Skv) {
      *reinterpret_cast<uint32_t*>(dk + kvbase + static_cast<long long>(ra) * D + c) =
          pack_bf16(ak[nd][0] * scale, ak[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + kvbase + static_cast<long long>(ra) * D + c) =
          pack_bf16(av[nd][0], av[nd][1]);
    }
    if (rb < Skv) {
      *reinterpret_cast<uint32_t*>(dk + kvbase + static_cast<long long>(rb) * D + c) =
          pack_bf16(ak[nd][2] * scale, ak[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + kvbase + static_cast<long long>(rb) * D + c) =
          pack_bf16(av[nd][2], av[nd][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ (and Delta): one block a (64-row q tile, q head, batch)
// ---------------------------------------------------------------------------
// P (masked, in s) and dP of the warp's 16 rows against the staged keys k0..
template <int D, int BC>
__device__ __forceinline__ void scores_dq(float (&s)[BC / 8][4], float (&dp)[BC / 8][4],
                                          const bf16* Qs, const bf16* Os, const bf16* Ks,
                                          const bf16* Vs, const float* Ls, int rw, int g, int t,
                                          float sl2, bool masked, int k0, int q0, int q_off, int Sq,
                                          int Skv, int causal) {
  constexpr int LD = D + kPad, NB = BC / 8;
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4], oa[4];
    load_a(qa, Qs, LD, rw, kk * 16, g * 4 + t);
    load_a(oa, Os, LD, rw, kk * 16, g * 4 + t);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bb[4];
      load_bt2(bb, Ks, LD, nb * 8, kk * 16, g * 4 + t);
      mma16816(s[nb], qa, bb[0], bb[1]);
      mma16816(s[nb + 1], qa, bb[2], bb[3]);
      load_bt2(bb, Vs, LD, nb * 8, kk * 16, g * 4 + t);
      mma16816(dp[nb], oa, bb[0], bb[1]);
      mma16816(dp[nb + 1], oa, bb[2], bb[3]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rw + g + (e >> 1) * 8;  // row in the tile
      const int key = k0 + nb * 8 + 2 * t + (e & 1);
      float p = fast_exp2(fmaf(s[nb][e], sl2, -Ls[r]));
      if (masked && (key >= Skv || q0 + r >= Sq || (causal && key > q_off + q0 + r))) p = 0.f;
      s[nb][e] = p;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int BR = kOwnBf16, BC = staged_bf16(D), LD = D + kPad, NB = BC / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BR * LD;      // dout
  bf16* Ks = Os + BR * LD;      // two buffers of BC keys
  bf16* Vs = Ks + 2 * BC * LD;  // two buffers
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BC * LD);
  float* Ds = Ls + BR;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int hk = h / (Hq / Hkv), q_off = Skv - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;  // the warp's first row in the tile
  const long long qrow = static_cast<long long>(b * Hq + h) * Sq;
  const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
  stage_rows<D>(Qs, q + qrow * D, q0, BR, Sq);
  stage_rows<D>(Os, dout + qrow * D, q0, BR, Sq);
  for (int i = threadIdx.x; i < BR; i += blockDim.x) Ls[i] = lse_log2(lse, qrow + q0 + i, q0 + i < Sq);
  const float sl2 = scale * kLog2e;
  // kv tiles the q tile sees: up to its last row's diagonal
  const int kv_end = causal ? min(Skv, max(q_off + min(q0 + BR, Sq), 0)) : Skv;
  const int tiles = (kv_end + BC - 1) / BC;
  auto prefetch = [&](int it) {  // kv tile it into buffer it % 2
    stage_rows_async<D>(Ks + (it & 1) * BC * LD, k + kvbase, it * BC, BC, Skv);
    stage_rows_async<D>(Vs + (it & 1) * BC * LD, v + kvbase, it * BC, BC, Skv);
    cp_async_commit();
  };
  // one walk over the kv tiles, loading tile it + 1 while tile it is used
  auto walk = [&](auto&& body) {
    if (tiles > 0) prefetch(0);
    for (int it = 0; it < tiles; ++it) {
      if (it + 1 < tiles) {  // buffer (it + 1) % 2 was last read in step it - 1
        prefetch(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(it * BC, Ks + (it & 1) * BC * LD, Vs + (it & 1) * BC * LD);
      __syncthreads();
    }
  };
  float s[NB][4], dp[NB][4];  // P and dP: the warp's 16 rows x BC keys

  // walk 1: Delta = rowsum(P * dP) of rows g and g + 8
  float dl_a = 0.f, dl_b = 0.f;
  walk([&](int k0, const bf16* Kb, const bf16* Vb) {
    const bool masked = (causal && k0 + BC - 1 > q_off + q0) || k0 + BC > Skv || q0 + BR > Sq;
    scores_dq<D, BC>(s, dp, Qs, Os, Kb, Vb, Ls, rw, g, t, sl2, masked, k0, q0, q_off, Sq, Skv, causal);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      dl_a = fmaf(s[nb][0], dp[nb][0], fmaf(s[nb][1], dp[nb][1], dl_a));
      dl_b = fmaf(s[nb][2], dp[nb][2], fmaf(s[nb][3], dp[nb][3], dl_b));
    }
  });
  dl_a = quad_sum(dl_a);
  dl_b = quad_sum(dl_b);
  if (t == 0) {  // one writer a row: the dK/dV kernel reads Delta from device memory
    Ds[rw + g] = dl_a;
    Ds[rw + g + 8] = dl_b;
    if (q0 + rw + g < Sq) delta[qrow + q0 + rw + g] = dl_a;
    if (q0 + rw + g + 8 < Sq) delta[qrow + q0 + rw + g + 8] = dl_b;
  }

  // walk 2: dS = P (dP - Delta), dQ += dS k
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  walk([&](int k0, const bf16* Kb, const bf16* Vb) {
    const bool masked = (causal && k0 + BC - 1 > q_off + q0) || k0 + BC > Skv || q0 + BR > Sq;
    scores_dq<D, BC>(s, dp, Qs, Os, Kb, Vb, Ls, rw, g, t, sl2, masked, k0, q0, q_off, Sq, Skv, causal);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nb][e] = s[nb][e] * (dp[nb][e] - Ds[rw + g + (e >> 1) * 8]);
    // the fragments of keys 16kk..16kk+15 are k-step kk's A
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bb[4];
        load_b2(bb, Kb, LD, kk * 16, nd * 8, lane);
        mma16816(acc[nd], da, bb[0], bb[1]);
        mma16816(acc[nd + 1], da, bb[2], bb[3]);
      }
    }
  });

  const int ra = q0 + rw + g, rb = ra + 8;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(dq + (qrow + ra) * D + c) = pack_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(dq + (qrow + rb) * D + c) = pack_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// f32: a thread a key (dK / dV) or a query row (dQ), true f32 FMAs
// ---------------------------------------------------------------------------
// rows [r0, r0 + n) of one head's (S, D) rows into a [n][ld] tile, zero past S
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, int r0, int n, int S,
                                          int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r0 + r < S ? src[static_cast<long long>(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                   int causal, float scale) {
  constexpr int LP = D + 1;  // the block's own rows, padded: thread i reads row i
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kThreadsF32 * LP;
  float* Qs = Vs + kThreadsF32 * LP;
  float* Os = Qs + kStagedF32 * D;
  float* Ls = Os + kStagedF32 * D;  // natural units, +inf for a row that sees no key
  float* Ds = Ls + kStagedF32;

  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kThreadsF32;
  const int groups = Hq / Hkv, q_off = Skv - Sq;
  const int key = k0 + threadIdx.x;
  const bool valid = key < Skv;
  const long long kvbase = static_cast<long long>(b * Hkv + hk) * Skv * D;
  stage_f32(Ks, LP, k + kvbase, k0, kThreadsF32, Skv, D);
  stage_f32(Vs, LP, v + kvbase, k0, kThreadsF32, Skv, D);
  float ak[D], av[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.f;
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
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[r * D + d], Ks[threadIdx.x * LP + d], s);
          dp = fmaf(Os[r * D + d], Vs[threadIdx.x * LP + d], dp);
        }
        const bool seen = valid && (!causal || key <= q_off + q0 + r);
        const float p = seen ? expf(s * scale - Ls[r]) : 0.f;
        const float ds = p * (dp - Ds[r]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          av[d] = fmaf(p, Os[r * D + d], av[d]);
          ak[d] = fmaf(ds, Qs[r * D + d], ak[d]);
        }
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[kvbase + static_cast<long long>(key) * D + d] = ak[d] * scale;
    dv[kvbase + static_cast<long long>(key) * D + d] = av[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int LP = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kThreadsF32 * LP;
  float* Ks = Os + kThreadsF32 * LP;
  float* Vs = Ks + kStagedF32 * D;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kThreadsF32;
  const int hk = h / (Hq / Hkv), q_off = Skv - Sq;
  const int row = q0 + threadIdx.x;
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
    for (int d = 0; d < D; ++d) {
      s = fmaf(Qs[threadIdx.x * LP + d], Ks[j * D + d], s);
      dp = fmaf(Os[threadIdx.x * LP + d], Vs[j * D + d], dp);
    }
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
  float acc[D];  // walk 2: dQ
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
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
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j * D + d], acc[d]);
    }
  }
  if (!valid) return;
  delta[qrow + row] = dl;
#pragma unroll
  for (int d = 0; d < D; ++d) dq[(qrow + row) * D + d] = acc[d] * scale;
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
                        const float* lse, float* delta, void* dq, void* dk, void* dv) {
  cudaError_t e = allow_smem(flash_bwd_dkdv_bf16<D>, smem_dkdv_bf16(D));
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_bf16<D>, smem_dq_bf16(D));
  if (e != cudaSuccess) return e;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
  flash_bwd_dq_bf16<D><<<dim3((Sq + kOwnBf16 - 1) / kOwnBf16, Hq, B), kThreadsBf16, smem_dq_bf16(D),
                         s>>>(qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv,
                              causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_bf16<D><<<dim3((Skv + kOwnBf16 - 1) / kOwnBf16, Hkv, B), kThreadsBf16,
                           smem_dkdv_bf16(D), s>>>(qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dk),
                                                   static_cast<bf16*>(dv), Hq, Hkv, Sq, Skv, causal, scale);
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
  flash_bwd_dq_f32<D><<<dim3((Sq + kThreadsF32 - 1) / kThreadsF32, Hq, B), kThreadsF32,
                        smem_dq_f32(D), s>>>(qf, kf, vf, of, lse, delta, static_cast<float*>(dq), Hq,
                                             Hkv, Sq, Skv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32<D><<<dim3((Skv + kThreadsF32 - 1) / kThreadsF32, Hkv, B), kThreadsF32,
                          smem_dkdv_f32(D), s>>>(qf, kf, vf, of, lse, delta, static_cast<float*>(dk),
                                                 static_cast<float*>(dv), Hq, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout, dq, dk, dv; lse and
// delta are f32).  delta: scratch of B * Hq * Sq floats, allocated by the
// wrapper, which the dQ kernel fills for the dK/dV kernel.  The tiles (dK/dV:
// keys a block, query rows staged; dQ: query rows a block, keys staged),
// threads and shared-memory sizes come from kernels/geometry.py; any that
// disagrees with this file's arithmetic is refused.  Launches two kernels on
// `stream`; returns cudaGetLastError() after the last.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* lse, const void* dout, void* delta,
    void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, int dkdv_keys,
    int dkdv_rows, int dq_rows, int dq_keys, int threads, int dkdv_smem, int dq_smem, int causal,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 || (dtype != 0 && dtype != 1) ||
      (D != 16 && D != 32 && D != 64 && D != 128) || dkdv_smem > kSmemPerBlock ||
      dq_smem > kSmemPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      dtype == 1
          ? dkdv_keys == kOwnBf16 && dkdv_rows == staged_bf16(D) && dq_rows == kOwnBf16 &&
                dq_keys == staged_bf16(D) && threads == kThreadsBf16 &&
                dkdv_smem == smem_dkdv_bf16(D) && dq_smem == smem_dq_bf16(D)
          : dkdv_keys == kThreadsF32 && dkdv_rows == kStagedF32 && dq_rows == kThreadsF32 &&
                dq_keys == kStagedF32 && threads == kThreadsF32 && dkdv_smem == smem_dkdv_f32(D) &&
                dq_smem == smem_dq_f32(D);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FLASH_BWD_CASE(DIM)                                                                \
  case DIM:                                                                                      \
    e = dtype == 1 ? launch_bf16<DIM>(B, Hq, Hkv, Sq, Skv, causal, scale, s, q, k, v, dout, lf, \
                                      dl, dq, dk, dv)                                            \
                   : launch_f32<DIM>(B, Hq, Hkv, Sq, Skv, causal, scale, s, q, k, v, dout, lf,  \
                                     dl, dq, dk, dv);                                            \
    break;
  switch (D) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    default:
      break;
  }
#undef REPRO_FLASH_BWD_CASE
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
