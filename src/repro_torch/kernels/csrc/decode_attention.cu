// Decode attention over a KV cache, read as stored, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's decode attention
// (src/repro/models/attention.py, `decode_step`) is plain jnp, and the
// port's plain version (kernels/decode_attention.py,
// `decode_attention_plain`) casts the whole cache int8 -> bf16 -> f32 and
// runs two f32 products over it, masked positions included, at every layer
// of every step.  This kernel reads each visible K and V row once, as the
// cache stores it, and nothing else of the cache.
//
// One new query token a row attends over positions [0, cur] of its cache
// (global positions; this rank holds [off, off + L)):
//   s_t  = (q . k_t) * hd^-0.5 * k_s[t]          (k_s = 1 for a bf16/f32 cache)
//   att  = sum_t softmax(s)_t * v_s[t] * v_t,   lse = log sum_t exp(s_t)
// for the g = Hq / Hk query heads of each KV head (GQA).
//
// Bound: bytes.  Per visible position and KV head it reads 2 * hd bytes of
// int8 codes and 8 of scales (2 * hd * 2 for bf16) and does 4 * g * hd
// f32 operations: ~4 operations a byte at granite-moe's g = 2, ~15 at
// g = 8, hd = 128, against the card's ~20 f32 operations a byte of HBM.
//
// Design (flash-decoding):
//  * Grid (B * Hk, n_split).  A block takes one chunk of positions of one
//    (row, KV head) for all g query heads, so each K/V byte is read once.
//    n_split depends on L and B * Hk alone (the host's `splits`); a chunk
//    that lies wholly past the row's cur returns at once, so the bytes read
//    follow the visible positions, not the cache's length.
//  * Each (row, head) slab of K and V is contiguous (rows of hd elements);
//    the slabs are taken through their strides, so a view of some KV heads
//    of a larger cache is read in place.  Tiles of T positions are copied
//    with 16-byte cp.async (scales with 4-byte ones) into a 4-stage
//    shared-memory ring, three tiles in flight a block and three blocks an
//    SM: ~150 KB in flight an SM against the ~25 KB that HBM's latency asks.
//  * A position is read by P lanes, each holding VD = hd / P dimensions of
//    every head's q in registers (P the least power of two that keeps
//    g * VD within 32 registers up to g = 2, 64 from g = 4); the lanes'
//    partial dot products meet in log2(P) xor-shuffles.  Each group of P lanes keeps its own running max,
//    sum and output slice over the positions it takes (an online softmax
//    per group), so the value product needs no reduction until the chunk
//    ends; then the groups meet in shared memory, and the chunk's
//    normalised output and log-sum-exp go to a small f32 scratch.
//  * A second kernel combines each (row, head)'s chunks into att and lse.
//    A row with no visible position on this rank gets att = 0 and
//    lse = -inf (weight 0 in collectives.softmax_combine).
//  * Math in f32 on CUDA cores, as the plain version: int8 -> f32 (the
//    byte placed in the mantissa of 2^23 and 2^23 + 128 subtracted: exact,
//    and no quarter-rate I2F) and bf16 -> f32 are exact; probabilities are
//    never rounded to bf16.  The softmax runs in base 2 (logits times
//    log2(e), exp2f); lse comes back in natural log.  Sums run in another
//    order than the plain version's, so the two agree to f32 rounding, not
//    bit for bit.
//  * The tile (16 KB of K and V a stage), 16 positions a group a step over
//    all its heads and ~16 blocks an SM (the host's `splits`) were the
//    fastest of the variants timed at the benchmark cell's shapes (PERF.md);
//    more threads a block, fewer or more stages, or 4 blocks an SM were
//    no faster there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;  // K and V of one tile, the target
constexpr int kGroupPositions = 16;  // positions a group takes a step, over all its heads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kCombineThreads = 128;

struct Args {
  const void* q;           // (B, Hq, hd), bf16 or f32; element strides q_sb, q_sh, 1
  long long q_sb, q_sh;
  const void* k;           // (B, Hk, L, hd), element strides k_sb, k_sh, hd, 1
  const void* v;
  long long k_sb, k_sh, v_sb, v_sh;
  const float* ks;         // (B, Hk, L, 1) f32, element strides ks_sb, ks_sh, 1; null: no scales
  const float* vs;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  const long long* cur;    // (1,) or (B,): the global position of the new token
  int cur_per_row;
  long long off;           // the first global position this rank holds
  float scale;             // hd^-0.5
  int Hk, g, L, n_split, chunk;
  int q_bf16;
  float* part_o;           // (B * Hk, n_split, g, hd): a chunk's normalised output
  float* part_lse;         // (B * Hk, n_split, g)
  float* att;              // (B, Hq, hd) f32, contiguous
  float* lse;              // (B, Hq) f32
};

// Positions [0, end) of this rank that row b sees.
__device__ __forceinline__ int visible_end(const Args& a, int b) {
  const long long lim = a.cur[a.cur_per_row ? b : 0] - a.off + 1;
  return static_cast<int>(lim < 0 ? 0 : (lim > a.L ? a.L : lim));
}

// ---------------------------------------------------------------------------
// Geometry of an instance
// ---------------------------------------------------------------------------
// Lanes a position: the least power of two (at most 32) that leaves each
// lane at most `qregs` registers of q (as many of the running output): 32
// up to two heads a group, 64 from four, where log2(lanes) shuffles a head
// and position would outweigh the registers.
constexpr int lanes_for(int hd, int gm) {
  const int qregs = gm <= 2 ? 32 : 64;
  int p = 1;
  while (p < 32 && hd % (2 * p) == 0 && (hd / p) * gm > qregs) p *= 2;
  return p;
}

constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

template <typename KV, int HD, int GM>
struct Geo {
  static constexpr int ES = sizeof(KV);
  static constexpr bool SCALED = ES == 1;               // int8 codes with f32 row scales
  static constexpr int P = lanes_for(HD, GM);
  static constexpr int VD = HD / P;                     // dimensions a lane
  static constexpr int NG = kThreads / P;               // groups of P lanes
  static constexpr int RS_MAX = kGroupPositions / GM;   // positions a group per step
  static constexpr int T_TARGET = kStageBytes / (2 * HD * ES);
  static constexpr int RS = clampi(T_TARGET / NG, 1, RS_MAX);
  static constexpr int SP = NG * RS;                    // positions a step
  static constexpr int T = T_TARGET >= SP ? (T_TARGET / SP) * SP : SP;  // positions a tile
  static constexpr int ROW = HD * ES;                   // bytes of a K or V row
  static constexpr int STAGE = 2 * T * ROW + (SCALED ? 2 * T * 4 : 0);
  static constexpr int RED = NG * GM * (HD + 2) * 4;    // the groups' partials
  static constexpr int SMEM = kStages * STAGE > RED ? kStages * STAGE : RED;
  static_assert(HD % P == 0 && kThreads % P == 0 && T % SP == 0, "geometry");
  static_assert(ROW % 16 == 0, "a row is whole 16-byte units");
  static_assert(SMEM <= 232448, "one block's shared memory on an H100");
};

// ---------------------------------------------------------------------------
// Copies and loads
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N bytes (a multiple of 4) of shared memory as words, in the widest loads
// their alignment allows (the address is aligned to N's power-of-two part).
template <int N>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[N / 4]) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z, w[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = x.x, w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
}

// Four int8 codes -> f32, exactly: code + 128 as the low byte of the float
// 2^23 + (code + 128), less 2^23 + 128 (a byte permute and an add, where
// I2F runs at a quarter of the add's rate).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// VD elements of type KV at p (shared memory) -> f32.
template <typename KV, int VD>
__device__ __forceinline__ void load_row(const unsigned char* p, float (&f)[VD]) {
  constexpr int N = VD * static_cast<int>(sizeof(KV));
  if constexpr (N % 4 == 0) {
    uint32_t w[N / 4];
    load_words<N>(p, w);
    if constexpr (sizeof(KV) == 1) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) i8x4_to_f32(w[i], f + 4 * i);
    } else if constexpr (sizeof(KV) == 2) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) f[i] = __uint_as_float(w[i]);
    }
  } else if constexpr (sizeof(KV) == 1) {  // 5 or 10 codes a lane (head_dim 160)
#pragma unroll
    for (int i = 0; i < VD; ++i) f[i] = static_cast<float>(reinterpret_cast<const int8_t*>(p)[i]);
  } else {  // 5 bf16 a lane
#pragma unroll
    for (int i = 0; i < VD; ++i)
      f[i] = __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(p)[i]) << 16);
  }
}

__device__ __forceinline__ float load_q(const Args& a, long long i) {
  return a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}

// ---------------------------------------------------------------------------
// One chunk of one (row, KV head)
// ---------------------------------------------------------------------------
template <typename KV, int HD, int GM>
__global__ void __launch_bounds__(kThreads) decode_attention_split(const Args a) {
  using G = Geo<KV, HD, GM>;
  constexpr int P = G::P, VD = G::VD, NG = G::NG, RS = G::RS, SP = G::SP, T = G::T, ROW = G::ROW;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.Hk, h = bh % a.Hk;
  const int c0 = split * a.chunk;
  const int end = visible_end(a, b);
  if (c0 >= end) return;  // the whole chunk lies past cur
  const int n = min(c0 + a.chunk, end) - c0;
  const int tid = threadIdx.x, grp = tid / P, li = tid % P;

  const unsigned char* kg =
      static_cast<const unsigned char*>(a.k) + (b * a.k_sb + h * a.k_sh + static_cast<long long>(c0) * HD) * G::ES;
  const unsigned char* vg =
      static_cast<const unsigned char*>(a.v) + (b * a.v_sb + h * a.v_sh + static_cast<long long>(c0) * HD) * G::ES;
  const float* ksg = G::SCALED ? a.ks + b * a.ks_sb + h * a.ks_sh + c0 : nullptr;
  const float* vsg = G::SCALED ? a.vs + b * a.vs_sb + h * a.vs_sh + c0 : nullptr;

  const int ntiles = (n + T - 1) / T;
  const float scale2 = a.scale * kLog2e;  // logits, maxima and sums run in base 2 (exp2f)
  auto load_tile = [&](int tile) {  // its K, V (and scales) into its stage; always one group
    if (tile < ntiles) {
      const int t0 = tile * T, nt = min(T, n - t0);
      unsigned char* st = smem + (tile % kStages) * G::STAGE;
      const int units = nt * ROW / 16;
      for (int i = tid; i < units; i += kThreads) {
        cp_async16(st + i * 16, kg + static_cast<long long>(t0) * ROW + i * 16);
        cp_async16(st + T * ROW + i * 16, vg + static_cast<long long>(t0) * ROW + i * 16);
      }
      if constexpr (G::SCALED) {
        float* ss = reinterpret_cast<float*>(st + 2 * T * ROW);
        for (int i = tid; i < nt; i += kThreads) {
          cp_async4(ss + i, ksg + t0 + i);
          cp_async4(ss + T + i, vsg + t0 + i);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  float qf[GM][VD];
#pragma unroll
  for (int j = 0; j < GM; ++j)
#pragma unroll
    for (int e = 0; e < VD; ++e)
      qf[j][e] = j < a.g ? load_q(a, b * a.q_sb + (h * a.g + j) * a.q_sh + li * VD + e) : 0.0f;

  float m[GM], l[GM], acc[GM][VD];
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    m[j] = -INFINITY, l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < VD; ++e) acc[j][e] = 0.0f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();               // everyone's have; everyone is done with tile - 1
    load_tile(tile + kStages - 1);  // into tile - 1's stage
    const unsigned char* st = smem + (tile % kStages) * G::STAGE;
    const unsigned char* kt = st;
    const unsigned char* vt = st + T * ROW;
    const float* kst = reinterpret_cast<const float*>(st + 2 * T * ROW);
    const float* vst = kst + T;
    const int nt = min(T, n - tile * T);
    for (int s0 = 0; s0 < nt; s0 += SP) {
      float sc[RS][GM];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int t = s0 + r * NG + grp;
        float kf[VD];
        load_row<KV, VD>(kt + t * ROW + li * VD * G::ES, kf);
#pragma unroll
        for (int j = 0; j < GM; ++j) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < VD; ++e) d = fmaf(qf[j][e], kf[e], d);
          sc[r][j] = d;
        }
      }
#pragma unroll
      for (int r = 0; r < RS; ++r)
#pragma unroll
        for (int j = 0; j < GM; ++j)
#pragma unroll
          for (int o = P / 2; o > 0; o >>= 1) sc[r][j] += __shfl_xor_sync(0xffffffffu, sc[r][j], o);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int t = s0 + r * NG + grp;
        const bool ok = t < nt;
        const float ksc = G::SCALED && ok ? kst[t] : 1.0f;
#pragma unroll
        for (int j = 0; j < GM; ++j) sc[r][j] = ok ? sc[r][j] * scale2 * ksc : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        float mx = m[j];
#pragma unroll
        for (int r = 0; r < RS; ++r) mx = fmaxf(mx, sc[r][j]);
        if (mx > m[j]) {  // a new max: rescale what this group holds
          const float c = exp2f(m[j] - mx);
          l[j] *= c;
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[j][e] *= c;
          m[j] = mx;
        }
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int t = s0 + r * NG + grp;
        if (t < nt) {
          float vf[VD];
          load_row<KV, VD>(vt + t * ROW + li * VD * G::ES, vf);
          const float vsc = G::SCALED ? vst[t] : 1.0f;
#pragma unroll
          for (int j = 0; j < GM; ++j) {
            const float p = exp2f(sc[r][j] - m[j]);
            l[j] += p;
            const float w = p * vsc;
#pragma unroll
            for (int e = 0; e < VD; ++e) acc[j][e] = fmaf(w, vf[e], acc[j][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; the ring is idle
  __syncthreads();

  // the groups' partials meet in shared memory: [group][head][hd | m | l]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    float* row = red + (grp * GM + j) * (HD + 2);
#pragma unroll
    for (int e = 0; e < VD; ++e) row[li * VD + e] = acc[j][e];
    if (li == 0) row[HD] = m[j], row[HD + 1] = l[j];
  }
  __syncthreads();
  const long long part = static_cast<long long>(bh) * a.n_split + split;
  for (int i = tid; i < a.g * HD; i += kThreads) {
    const int j = i / HD, d = i % HD;
    float mx = -INFINITY;
    for (int r = 0; r < NG; ++r) mx = fmaxf(mx, red[(r * GM + j) * (HD + 2) + HD]);
    float sum = 0.0f, o = 0.0f;
    for (int r = 0; r < NG; ++r) {
      const float* row = red + (r * GM + j) * (HD + 2);
      if (row[HD] == -INFINITY) continue;  // a group that saw no visible position
      const float w = exp2f(row[HD] - mx);
      sum = fmaf(w, row[HD + 1], sum);
      o = fmaf(w, row[d], o);
    }
    a.part_o[(part * a.g + j) * HD + d] = o / sum;
    if (d == 0) a.part_lse[part * a.g + j] = mx * kLn2 + logf(sum);  // natural log
  }
}

// ---------------------------------------------------------------------------
// The chunks of each (row, KV head) into att and lse
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kCombineThreads) decode_attention_combine(const Args a, int hd) {
  const int bh = blockIdx.x, b = bh / a.Hk, h = bh % a.Hk;
  const int nv = (visible_end(a, b) + a.chunk - 1) / a.chunk;  // chunks that hold a visible position
  const int Hq = a.Hk * a.g;
  const long long part0 = static_cast<long long>(bh) * a.n_split;
  for (int i = threadIdx.x; i < a.g * hd; i += kCombineThreads) {
    const int j = i / hd, d = i % hd;
    const long long out = static_cast<long long>(b) * Hq + h * a.g + j;
    if (nv == 0) {
      a.att[out * hd + d] = 0.0f;
      if (d == 0) a.lse[out] = -INFINITY;
      continue;
    }
    float mx = -INFINITY;
    for (int s = 0; s < nv; ++s) mx = fmaxf(mx, a.part_lse[(part0 + s) * a.g + j]);
    float sum = 0.0f, o = 0.0f;
    for (int s = 0; s < nv; ++s) {
      const float w = expf(a.part_lse[(part0 + s) * a.g + j] - mx);
      sum += w;
      o = fmaf(w, a.part_o[((part0 + s) * a.g + j) * hd + d], o);
    }
    a.att[out * hd + d] = o / sum;
    if (d == 0) a.lse[out] = mx + logf(sum);
  }
}

template <typename KV, int HD, int GM>
int launch_split(const Args& a, int rows_heads, cudaStream_t s) {
  using G = Geo<KV, HD, GM>;
  auto kernel = decode_attention_split<KV, HD, GM>;
  static bool attr_set = false;  // above 48 KB a kernel must ask for its shared memory
  if (G::SMEM > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<dim3(rows_heads, a.n_split), kThreads, G::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int HD>
int launch_hd(const Args& a, int rows_heads, cudaStream_t s) {
  if (a.g <= 1) return launch_split<KV, HD, 1>(a, rows_heads, s);
  if (a.g <= 2) return launch_split<KV, HD, 2>(a, rows_heads, s);
  if (a.g <= 4) return launch_split<KV, HD, 4>(a, rows_heads, s);
  if (a.g <= 8) return launch_split<KV, HD, 8>(a, rows_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int launch_kv(const Args& a, int hd, int rows_heads, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<KV, 16>(a, rows_heads, s);
    case 32: return launch_hd<KV, 32>(a, rows_heads, s);
    case 64: return launch_hd<KV, 64>(a, rows_heads, s);
    case 128: return launch_hd<KV, 128>(a, rows_heads, s);
    case 160: return launch_hd<KV, 160>(a, rows_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kv: 0 = int8 codes with f32 scales (ks, vs), 1 = bfloat16, 2 = float32.
// q_bf16: q is bfloat16 (else float32).  Strides are in elements.  Every
// pointer and the K/V strides times the element size are 16-byte aligned
// (checked by the caller).  Returns the launches' CUDA error (0 when both
// were queued).
extern "C" int decode_attention_launch(
    const void* q, long long q_sb, long long q_sh, int q_bf16,
    const void* k, long long k_sb, long long k_sh, const void* v, long long v_sb, long long v_sh,
    const void* ks, long long ks_sb, long long ks_sh, const void* vs, long long vs_sb, long long vs_sh,
    int kv, const void* cur, int cur_per_row, long long off, float scale,
    int B, int Hk, int g, int L, int hd, int n_split, int chunk,
    void* part_o, void* part_lse, void* att, void* lse, void* stream) {
  if (B <= 0 || Hk <= 0 || g <= 0 || L <= 0 || n_split <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q, a.q_sb = q_sb, a.q_sh = q_sh, a.q_bf16 = q_bf16;
  a.k = k, a.k_sb = k_sb, a.k_sh = k_sh, a.v = v, a.v_sb = v_sb, a.v_sh = v_sh;
  a.ks = static_cast<const float*>(ks), a.ks_sb = ks_sb, a.ks_sh = ks_sh;
  a.vs = static_cast<const float*>(vs), a.vs_sb = vs_sb, a.vs_sh = vs_sh;
  a.cur = static_cast<const long long*>(cur), a.cur_per_row = cur_per_row, a.off = off;
  a.scale = scale, a.Hk = Hk, a.g = g, a.L = L, a.n_split = n_split, a.chunk = chunk;
  a.part_o = static_cast<float*>(part_o), a.part_lse = static_cast<float*>(part_lse);
  a.att = static_cast<float*>(att), a.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_heads = B * Hk;
  int err;
  if (kv == 0) {
    if (!ks || !vs) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_kv<int8_t>(a, hd, rows_heads, s);
  } else if (kv == 1) {
    err = launch_kv<__nv_bfloat16>(a, hd, rows_heads, s);
  } else if (kv == 2) {
    err = launch_kv<float>(a, hd, rows_heads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  decode_attention_combine<<<rows_heads, kCombineThreads, 0, s>>>(a, hd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
