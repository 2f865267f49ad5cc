// Rowwise symmetric int8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_quant_kernel` (src/repro/kernels/quantize.py:17,
// `quantize_int8` at :36) and `_dequant_kernel` (:26, `dequantize_int8` at :65):
//   scale = amax / 127 (1 where amax == 0),  q = clip(rint(x / scale), -127, 127),
//   x' = q * scale.
//
// Bound: bytes.  Quantize reads x once and writes q and one scale per row;
// dequantize reads q and the scales once and writes x'.  A few operations an
// element, far below the card's ~295 operations per byte.
//
// Quantize needs the row's amax before it can write a code, so a body that
// streams the row twice moves about 9 bytes an f32 element against the
// bound's 5 once a row outgrows L1.  This body keeps every row on chip
// (registers or shared memory) between the amax and the write of q, and
// reads x from device memory once.  The host (geometry.quantize_launch)
// picks one of five regimes from the width alone, counted in units of 16
// elements (one 16-byte store of q):
//  * narrow (at most 16 units: 256 elements, 1 KiB f32 / 512 B bf16): a
//    group of `lanes` lanes (a power of two) holds a row, one unit a lane,
//    and 32 / lanes rows share a warp (a 64-wide bf16 KV row takes 4 lanes,
//    a 32-wide f32 router row 2); the group's max is a shuffle max over
//    xor offsets below `lanes`, which never leave the group.
//  * warp (at most 128 bytes of x a lane: a 4 KiB row, 1024 f32 / 2048
//    bf16): one warp a row, K units a lane (K = 1, 2 in f32, 1, 2, 4 in
//    bf16: at most 32 registers of x), every 16-byte load issued before the
//    reduction, 8 of them in flight a lane at the widest.
//  * cta (a slice of at most 115,456 bytes: two blocks an SM, so that one
//    block's loads overlap another's writes; 28,864 f32 / 57,728 bf16): one
//    block a row.  One thread issues 1-D bulk copies (cp.async.bulk, 16 KiB
//    each, an mbarrier each) of the row into shared memory; the threads
//    reduce each piece as it lands, a block reduction gives the amax, and q
//    is written from the shared copy.
//  * cluster (at most 8 such slices; 230,912 f32 / 461,824 bf16): a
//    thread-block cluster of k = 2..8 blocks a row (launched with
//    cudaLaunchKernelEx and a cluster-dimension attribute; the untied
//    head's 100,352-wide rows take 4 in f32, 2 in bf16), each block a slice
//    of ceil(units / k) units, loaded and reduced as in `cta`.  The blocks'
//    partial maxima meet in distributed shared memory, pushed rather than
//    pulled: each block writes its partial into a slot of every block's
//    shared memory and arrives on that block's mbarrier, then waits on its
//    own.  A pull (a cluster barrier, every block reading the others'
//    partials, a second cluster barrier before exit) holds every thread of
//    the cluster at two full barriers a row; the push needs one thread a
//    peer, no barrier before exit, and only a split cluster barrier that
//    the slice's load hides (it orders the mbarriers' initialisation
//    before the first remote arrival).
//  * two_pass (wider rows): one block a row reads it twice, once for the
//    amax and once to write q, so that no width is refused (the JAX kernel
//    takes any C).  Only the width selects this regime.
// A refused launch (a cluster the card cannot place, too much shared
// memory) returns its CUDA error; nothing falls back to another regime.
//
// Loads and stores are 16 bytes when C is a multiple of 16 and x and q are
// 16-byte aligned (`vec`, checked by the caller).  Otherwise (a ragged
// width, an offset pointer) each regime takes masked scalar loads and
// stores, its row still on chip between the two; nothing is padded.  In
// shared memory a thread reads its unit's 16-byte chunks in an order
// rotated by its lane, so that the eight threads of a quarter warp hit
// distinct banks, and puts the codes back in order before the store.
//
// The numerics are the oracle's bit for bit: the amax is a max, exact in
// any order, so partials combined across a warp, a block or a cluster give
// the same bits; the scale is a true f32 division `amax / 127.0f` and
// `x / scale` a true IEEE division (`__fdiv_rn`; never a multiply by a
// reciprocal, which moves the ties), rounded half to even with `rintf`.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // dequantize, and the narrow / warp regimes of quantize
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnit = 16;                  // elements a unit: 16 bytes of q
constexpr int kSliceThreads = 512;         // most threads of a cta / cluster / two_pass block
constexpr int kHeaderBytes = 256;          // shared memory before the slice
constexpr int kPieceBytes = 16384;         // one bulk copy
constexpr int kMaxPieces = 8;              // mbarriers in the header
constexpr int kMaxCluster = 8;
enum Regime { kNarrow = 0, kWarp = 1, kCta = 2, kCluster = 3, kTwoPass = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// A row's scale and its codes: every regime quantizes through row_quant.
struct RowQuant {
  float s;  // the row's scale
  __device__ __forceinline__ uint32_t code(float x) const {
    const float r = rintf(__fdiv_rn(x, s));  // half to even, as jnp.round
    const int8_t c = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    return static_cast<uint32_t>(static_cast<uint8_t>(c));
  }
  // the four codes of four elements, lowest address lowest byte
  __device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) const {
    return code(a) | (code(b) << 8) | (code(c) << 16) | (code(d) << 24);
  }
};

__device__ __forceinline__ RowQuant row_quant(float amax) {
  return RowQuant{amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f};
}

// Element i of words w holding elements of T in order (f32: a word each;
// bf16: two a word, the lower address in the low half).
template <typename T> __device__ __forceinline__ float elem(const uint32_t* w, int i);
template <> __device__ __forceinline__ float elem<float>(const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* w, int i) {
  return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
}

// The codes of one 16-byte chunk of x (4 f32 or 8 bf16) into out[0] (f32) or
// out[0..1] (bf16).
template <typename T>
__device__ __forceinline__ void chunk_codes(const uint4& v, const RowQuant& rq, uint32_t* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  out[0] = rq.pack4(elem<T>(w, 0), elem<T>(w, 1), elem<T>(w, 2), elem<T>(w, 3));
  if constexpr (sizeof(T) == 2)
    out[1] = rq.pack4(elem<T>(w, 4), elem<T>(w, 5), elem<T>(w, 6), elem<T>(w, 7));
}

template <typename T>
__device__ __forceinline__ float chunk_amax(float amax, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) amax = fmaxf(amax, fabsf(elem<T>(w, i)));
  return amax;
}

__device__ __forceinline__ void store16(int8_t* dst, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// narrow and warp regimes: a row in the registers of `lanes` lanes
// ---------------------------------------------------------------------------
// Lane `sub` of a row's group holds units sub, sub + lanes, ... (K of them):
// with vec, unit u is elements 16u .. 16u + 15, its codes one 16-byte
// store; without, slot m holds element sub + lanes * m (scalar loads, each
// coalesced across the group).  Lanes of rows past the last still take part
// in the shuffles, with nothing loaded.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_warp_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     long long rows, int cols, int lanes) {
  constexpr int NV = sizeof(T);            // 16-byte loads a unit: 4 f32, 2 bf16
  constexpr int kWords = K * 4 * NV;       // words of x a lane holds (at most 32)
  constexpr int kSlots = K * kUnit;        // elements a lane holds
  const int sub = threadIdx.x & (lanes - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * cols;
  uint32_t w[kWords];
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = sub + k * lanes;
      const bool in = live && u * kUnit < cols;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const uint4 v = in ? *reinterpret_cast<const uint4*>(xr + u * kUnit + j * (16 / NV))
                           : make_uint4(0u, 0u, 0u, 0u);
        w[(k * NV + j) * 4 + 0] = v.x;
        w[(k * NV + j) * 4 + 1] = v.y;
        w[(k * NV + j) * 4 + 2] = v.z;
        w[(k * NV + j) * 4 + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = sub + lanes * m;
      if (live && e < cols) {
        if constexpr (sizeof(T) == 4) {
          w[m] = __float_as_uint(xr[e]);
        } else {
          const uint32_t b = __bfloat16_as_ushort(xr[e]);
          w[m >> 1] |= (m & 1) ? (b << 16) : b;
        }
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int m = 0; m < kSlots; ++m) amax = fmaxf(amax, fabsf(elem<T>(w, m)));
  for (int off = lanes >> 1; off > 0; off >>= 1)  // within the row's group only
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;
  const RowQuant rq = row_quant(amax);
  if (sub == 0) scale[row] = rq.s;
  int8_t* qr = q + row * cols;
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = sub + k * lanes;
      if (u * kUnit >= cols) continue;
      const uint32_t* uw = w + k * 4 * NV;
      uint32_t out[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        out[g] = rq.pack4(elem<T>(uw, 4 * g), elem<T>(uw, 4 * g + 1), elem<T>(uw, 4 * g + 2),
                          elem<T>(uw, 4 * g + 3));
      store16(qr + u * kUnit, out);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = sub + lanes * m;
      if (e < cols) qr[e] = static_cast<int8_t>(rq.code(elem<T>(w, m)));
    }
  }
}

// ---------------------------------------------------------------------------
// cta, cluster and two_pass regimes: a row (or its slice) a block
// ---------------------------------------------------------------------------
// The max over the block; every thread gets it.  red: 33 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < warps ? red[lane] : 0.f;
    t = warp_max(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Codes of unit `u` read from shared memory `xs`, stored to qr + 16 u.  The
// thread reads the unit's NV chunks starting at chunk `rot` (so that the
// eight threads of a quarter warp hit distinct banks) and rotates the words
// back into address order.
template <typename T>
__device__ __forceinline__ void unit_from_smem(const T* xs, int u, int rot, const RowQuant& rq,
                                               int8_t* qr) {
  constexpr int NV = sizeof(T);
  constexpr int WPC = 4 / NV;  // words of q a chunk: 1 f32, 2 bf16
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j + rot) & (NV - 1);
    const uint4 v = *reinterpret_cast<const uint4*>(xs + u * kUnit + c * (16 / NV));
    chunk_codes<T>(v, rq, w + j * WPC);
  }
  // slot j holds chunk (j + rot) % NV: rotate right by rot chunks
  if (NV == 4) {
    if (rot & 1) {
      const uint32_t t = w[3];
      w[3] = w[2]; w[2] = w[1]; w[1] = w[0]; w[0] = t;
    }
    if (rot & 2) {
      uint32_t t = w[0]; w[0] = w[2]; w[2] = t;
      t = w[1]; w[1] = w[3]; w[3] = t;
    }
  } else if (rot & 1) {
    uint32_t t = w[0]; w[0] = w[2]; w[2] = t;
    t = w[1]; w[1] = w[3]; w[3] = t;
  }
  store16(qr + u * kUnit, w);
}

// One thread: the bulk copies of `bytes` (a multiple of 16) at src into dst,
// a piece of kPieceBytes an mbarrier.
__device__ __forceinline__ void load_slice(void* dst, const void* src, int bytes, uint64_t* bar) {
  for (int p = 0, off = 0; off < bytes; ++p, off += kPieceBytes) {
    const int len = min(kPieceBytes, bytes - off);
    sm90::mbar_arrive_expect_tx(&bar[p], len);
    sm90::bulk_load(static_cast<unsigned char*>(dst) + off, static_cast<const unsigned char*>(src) + off,
                    len, &bar[p]);
  }
}

// This thread's max of |x| over n elements that bulk copies bring into xs:
// chunk c = tid + nt * i (consecutive threads on consecutive 16 bytes), each
// piece waited on (its phase of parity `parity`) before its first chunk is
// read, and every piece before the return, so that the writes see them all.
template <typename T>
__device__ __forceinline__ float slice_amax(const T* xs, int n, uint64_t* bar, uint32_t parity) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kChunksAPiece = kPieceBytes / 16;
  const int chunks = n / VEC, pieces = (chunks + kChunksAPiece - 1) / kChunksAPiece;
  float amax = 0.f;
  int landed = 0;  // pieces this thread has seen complete
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    while (c >= landed * kChunksAPiece) sm90::mbar_wait(&bar[landed++], parity);
    amax = chunk_amax<T>(amax, *reinterpret_cast<const uint4*>(xs + c * VEC));
  }
  for (; landed < pieces; ++landed) sm90::mbar_wait(&bar[landed], parity);
  return amax;
}

// Without vec: masked scalar loads of n elements at xr into xs, and this
// thread's max of |x| (a barrier must come before xs is read).
template <typename T>
__device__ __forceinline__ float slice_load_scalar(const T* xr, T* xs, int n) {
  float amax = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const T v = xr[e];
    xs[e] = v;
    amax = fmaxf(amax, fabsf(to_f32(v)));
  }
  return amax;
}

// q of the n elements in xs, written to qr.
template <typename T>
__device__ __forceinline__ void slice_write(const T* xs, int n, const RowQuant& rq, int8_t* qr, int vec) {
  if (vec) {
    constexpr int NV = sizeof(T);
    const int rot = (threadIdx.x / (8 / NV)) & (NV - 1);
    for (int u = threadIdx.x; u < n / kUnit; u += blockDim.x) unit_from_smem<T>(xs, u, rot, rq, qr);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) qr[e] = static_cast<int8_t>(rq.code(to_f32(xs[e])));
  }
}

// cta: a block a row.  Shared memory: kMaxPieces mbarriers, the block
// reduction's 33 floats, then the row at kHeaderBytes.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads, 2)
quantize_cta_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                    int cols, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kMaxPieces * 8);
  T* xs = reinterpret_cast<T*>(smem + kHeaderBytes);
  const long long row = blockIdx.x;
  float amax;
  if (vec) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < kMaxPieces; ++p) sm90::mbar_init(&bar[p], 1);
      sm90::fence_barrier_init();
      load_slice(xs, x + row * cols, cols * static_cast<int>(sizeof(T)), bar);
    }
    __syncthreads();
    amax = slice_amax(xs, cols, bar, 0);
  } else {
    amax = slice_load_scalar(x + row * cols, xs, cols);
  }
  const RowQuant rq = row_quant(block_max(amax, red));  // its barrier publishes the scalar stores
  if (threadIdx.x == 0) scale[row] = rq.s;
  slice_write(xs, cols, rq, q + row * cols, vec);
}

// The shared::cluster address of `p` (this block's shared memory) in block `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(sm90::smem_u32(p)), "r"(rank));
  return a;
}

// Waits for the phase of parity `parity` of a barrier that other blocks of
// the cluster arrive on: their writes before the arrival are seen after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sm90::smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 26)) __trap();
  }
}

// cluster: k blocks a row, block `rank` its slice of slice_units units.  The
// partial maxima are pushed, not pulled: thread r < k of each block writes
// the block's partial into slot `rank` of block r's shared memory and
// arrives (release, cluster scope) on block r's `got` mbarrier, which
// expects k arrivals; each block waits on its own `got` and reduces its k
// slots locally.  Every remote write into a block lands before its `got`
// completes, and a block writes only into blocks that wait for it, so no
// block needs a barrier before it exits.  The one cluster barrier, whose
// arrival follows the mbarriers' initialisation and whose wait precedes the
// first remote arrival, is split around the slice's load and reduction.
// Shared memory: kMaxPieces mbarriers, the block reduction's 33 floats, the
// k slots, `got`, then the slice at kHeaderBytes.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads, 2)
quantize_cluster_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                        int cols, int slice_units, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kMaxPieces * 8);
  float* part = reinterpret_cast<float*>(smem + 200);      // kMaxCluster slots, to byte 232
  uint64_t* got = reinterpret_cast<uint64_t*>(smem + 232);  // to byte 240 < kHeaderBytes
  T* xs = reinterpret_cast<T*>(smem + kHeaderBytes);
  const cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / k;
  const int e0 = rank * slice_units * kUnit;
  const int n = max(0, min(cols - e0, slice_units * kUnit));  // elements of this slice
  const T* xr = x + row * cols + e0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(got, k);
    if (vec)
      for (int p = 0; p < kMaxPieces; ++p) sm90::mbar_init(&bar[p], 1);
    sm90::fence_barrier_init();
    if (vec) load_slice(xs, xr, n * static_cast<int>(sizeof(T)), bar);
  }
  cluster_arrive();  // this block's `got` is initialised
  __syncthreads();
  float amax = vec ? slice_amax(xs, n, bar, 0) : slice_load_scalar(xr, xs, n);
  amax = block_max(amax, red);  // its barrier publishes the scalar path's stores
  cluster_wait();  // every block's `got` is initialised
  if (threadIdx.x < k) {
    const uint32_t slot = map_rank(&part[rank], threadIdx.x);
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(slot), "f"(amax) : "memory");
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                     map_rank(got, threadIdx.x))
                 : "memory");
  }
  mbar_wait_cluster(got, 0);  // the k partials of the row are here
  float m = 0.f;
  for (int r = 0; r < k; ++r) m = fmaxf(m, part[r]);
  const RowQuant rq = row_quant(m);
  if (rank == 0 && threadIdx.x == 0) scale[row] = rq.s;
  slice_write(xs, n, rq, q + row * cols + e0, vec);
}

// Rows wider than a cluster of 8 holds: the row read twice.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads, 2)
quantize_two_pass_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int cols, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kMaxPieces * 8);
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * cols;
  int8_t* qr = q + row * cols;
  const int tid = threadIdx.x, nt = blockDim.x;
  float amax = 0.f;
  if (vec) {
    for (int c = tid; c < cols / VEC; c += nt)
      amax = chunk_amax<T>(amax, *reinterpret_cast<const uint4*>(xr + c * VEC));
  } else {
    for (int e = tid; e < cols; e += nt) amax = fmaxf(amax, fabsf(to_f32(xr[e])));
  }
  const RowQuant rq = row_quant(block_max(amax, red));
  if (tid == 0) scale[row] = rq.s;
  if (vec) {
    for (int u = tid; u < cols / kUnit; u += nt) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        chunk_codes<T>(*reinterpret_cast<const uint4*>(xr + u * kUnit + j * VEC), rq, w + j * (4 / NV));
      store16(qr + u * kUnit, w);
    }
  } else {
    for (int e = tid; e < cols; e += nt) qr[e] = static_cast<int8_t>(rq.code(to_f32(xr[e])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  T* __restrict__ out, long long rows, int cols, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int8_t* qr = q + row * cols;
  T* orow = out + row * cols;
  const float s = scale[row];
  if (vec) {  // four int8 a load, four outputs a store
    for (int i = lane * 4; i < cols; i += 32 * 4) {
      const char4 c = *reinterpret_cast<const char4*>(qr + i);
      const float v[4] = {c.x * s, c.y * s, c.z * s, c.w * s};
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(orow + i) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(orow + i) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  } else {
    for (int i = lane; i < cols; i += 32) orow[i] = from_f32<T>(static_cast<float>(qr[i]) * s);
  }
}

inline dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

// Raise a kernel's dynamic shared memory limit to `bytes` (once per size it grows to).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T>
int launch_quantize(const T* x, int8_t* q, float* scale, long long rows, int cols, int vec,
                    int regime, int threads, int group, int per_lane, int smem, cudaStream_t s) {
  if (regime == kNarrow || regime == kWarp) {
    // group: lanes a row; per_lane: units a lane
    if (threads != kThreads || group < 1 || group > 32 || (group & (group - 1)) ||
        static_cast<long long>(group) * per_lane * kUnit < cols)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((rows + kThreads / group - 1) / (kThreads / group)));
#define QUANT_WARP(K)                                                                   \
  do {                                                                                  \
    if (vec)                                                                            \
      quantize_warp_kernel<T, K, true><<<grid, kThreads, 0, s>>>(x, q, scale, rows, cols, group);  \
    else                                                                                \
      quantize_warp_kernel<T, K, false><<<grid, kThreads, 0, s>>>(x, q, scale, rows, cols, group); \
  } while (0)
    if (per_lane == 1) {
      QUANT_WARP(1);
    } else if (per_lane == 2) {
      QUANT_WARP(2);
    } else if constexpr (sizeof(T) == 2) {  // 4 units a lane: bf16 only (128 bytes)
      if (per_lane != 4) return static_cast<int>(cudaErrorInvalidValue);
      QUANT_WARP(4);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#undef QUANT_WARP
    return static_cast<int>(cudaGetLastError());
  }
  if (threads < 32 || threads > kSliceThreads || threads % 32) return static_cast<int>(cudaErrorInvalidValue);
  if (regime == kTwoPass) {
    if (smem < kHeaderBytes) return static_cast<int>(cudaErrorInvalidValue);
    quantize_two_pass_kernel<T><<<static_cast<unsigned>(rows), threads, smem, s>>>(x, q, scale, cols, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != kCta && regime != kCluster) return static_cast<int>(cudaErrorInvalidValue);
  // cta / cluster: group = blocks a row, per_lane = units of a slice
  const int k = group, slice_units = per_lane;
  const long long slice_bytes = static_cast<long long>(slice_units) * kUnit * sizeof(T);
  if ((regime == kCta) != (k == 1) || k < 1 || k > kMaxCluster ||
      static_cast<long long>(k) * slice_units * kUnit < cols ||
      slice_bytes > static_cast<long long>(kMaxPieces) * kPieceBytes || smem < kHeaderBytes + slice_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == kCta) {
    static int allowed = 48 * 1024;
    cudaError_t e = allow_smem(quantize_cta_kernel<T>, smem, allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    quantize_cta_kernel<T><<<static_cast<unsigned>(rows), threads, smem, s>>>(x, q, scale, cols, vec);
    return static_cast<int>(cudaGetLastError());
  }
  static int allowed = 48 * 1024;
  cudaError_t e = allow_smem(quantize_cluster_kernel<T>, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * k));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;  // a cluster the card cannot place is refused here, not run elsewhere
  e = cudaOccupancyMaxActiveClusters(&clusters, quantize_cluster_kernel<T>, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  e = cudaLaunchKernelEx(&cfg, quantize_cluster_kernel<T>, x, q, scale, cols, slice_units, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x).  vec: 1 when cols is a multiple
// of 16 and x and q are 16-byte aligned (checked by the caller).  regime,
// threads, group, per_lane and smem are geometry.quantize_launch's: group is
// the lanes a row (narrow, warp) or the blocks a row (cta, cluster);
// per_lane the units a lane (narrow, warp) or a slice's units (cta,
// cluster).  Returns the launch's CUDA error (0 when it was queued).
extern "C" int quantize_int8_launch(const void* x, void* q, void* scale, long long rows,
                                    int cols, int dtype, int vec, int regime, int threads,
                                    int group, int per_lane, int smem, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quantize<float>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                  static_cast<float*>(scale), rows, cols, vec, regime, threads,
                                  group, per_lane, smem, s);
  if (dtype == 1)
    return launch_quantize<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                          static_cast<int8_t*>(q), static_cast<float*>(scale),
                                          rows, cols, vec, regime, threads, group, per_lane, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (of the output).  vec: 1 when q and out
// are 16-byte aligned and cols is a multiple of 4 (checked by the caller).
extern "C" int dequantize_int8_launch(const void* q, const void* scale, void* out,
                                      long long rows, int cols, int dtype, int vec,
                                      void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dequantize_kernel<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, cols, vec);
  } else if (dtype == 1) {
    dequantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, cols, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
