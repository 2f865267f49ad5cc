"""Launch geometry of the port's Hopper kernels: pure integer math.

The Hopper counterpart of the JAX package's ``flash_vmem_bytes`` and
``scan_vmem_bytes``: where a TPU kernel's working set had to fit VMEM, a CUDA
kernel's has to fit the shared memory one block may use on an H100 (232,448
bytes) and its threads the register file (65,536 registers of 32 bits on
each SM).  A tile is never shrunk: each ``*_launch`` applies only the JAX
kernel's own clamp (``min(block, dim)``), raises ``ValueError`` where the
JAX kernel asserts divisibility, and raises ``ValueError`` for a tile the
Hopper kernel cannot launch.

**flash_attention** (``csrc/flash_attention.cu``).  One block serves one
query tile of ``block_q`` rows for one ``(batch, head)`` and loops over the
key axis, the causal diagonal bounding it:

* bf16 kernel (TMA -> wgmma): ``ceil(block_q / 64)`` consumer warpgroups of
  64 query rows each plus one producer warpgroup, so ``128 * (ceil(block_q /
  64) + 1)`` threads.  The kernel is compiled for at most 640 threads (four
  consumers, 96 registers each at launch) at head_dim <= 64 and 384 (two
  consumers, 168 registers) at head_dim 128 and 160; no block holds more
  than 1,024.
  Shared memory: 1,024 bytes of alignment slack, Q (``64 * head_dim * 2``
  bytes a consumer), a ring of ``max(2, ceil(block_kv / 64))`` stages of K
  and V 64 keys each (``2 * 64 * head_dim * 2`` bytes a stage: one kv tile
  in flight) and 8-byte mbarriers (one for Q, two a stage).  ``kv_pad`` is
  the ring's keys, ``64 * stages``.  A tile is stored at its true head_dim
  (at 160, five 32-element chunks under the 64-byte swizzle), so the same
  formula holds at every head_dim.
* f32 kernel: one thread per query row (two at head_dim 160, 80 columns
  each), so ``block_q`` threads (``2 * block_q`` at 160; at most 256), K and
  V staged row-major, the key tile padded to a multiple of 16.

Of the JAX schedule space's nine ``attn_block`` options, ``(128|256|512)²``,
at head_dim 64 in bf16 the six with ``block_q`` in (128, 256) are
launchable; ``block_q = 512`` would need 1,152 threads and raises.  At
head_dim 128 and 160 in bf16, (128, 128) and (128, 256).

The forward and the backward are built for ``FLASH_HEAD_DIMS``; a
backward at head_dim 160 (stablelm-12b training) runs a one-consumer dK/dV
block and a 32-key dQ stage (``flash_backward_tiles``).

**moe_gemm** (``csrc/moe_gemm.cu``).  Grid ``(E, C/block_c, f/block_f)``;
one block owns a ``block_c x block_f`` output tile and loops over ``d``
(the TPU's sequential fourth grid axis):

* bf16 kernel (TMA -> wgmma): ``ceil(block_c / 64)`` consumer warpgroups of
  64 rows (at most 2, so ``block_c <= 128``) plus one producer warpgroup:
  ``128 * (ceil(block_c / 64) + 1)`` threads, at most 384.  ``d`` streams 64
  deep through a ring of ``max(2, ceil(block_d / 64))`` stages (one
  ``block_d`` step in flight), a stage holding 64 x 64 of x per consumer
  and 64 x BN of w, ``BN = 128`` for ``block_f <= 128`` else 256 (wider
  tiles are walked in BN-wide column chunks): ``(64 * consumers + BN) *
  128`` bytes; plus 1,024 bytes of alignment slack, two 8-byte mbarriers a
  stage and one for the output, which is staged through the ring on its
  way out.  The default plan tile (128, 256, 256) takes 384 threads and
  197,704 bytes.  TMA reads rows of 16-byte multiples, so the stored inner
  dimensions (``d`` and ``f``, and ``C`` when x is given transposed) and
  ``block_d``, ``block_f`` must be multiples of 8.  ``x_t`` / ``w_t``: the
  operand is stored transposed, ``(E,d,C)`` / ``(E,f,d)``, and read so.
* f32 kernel: one thread per 8 x 8 outputs (``ceil(block_c/8) *
  ceil(block_f/8)`` threads, at most 512); each ``block_d`` step is staged
  16 rows of ``d`` at a time (a whole f32 step of the default tile would
  need 393,216 bytes).  It takes contiguous operands only.

**selective_scan** (``csrc/selective_scan.cu``).  A chunk-parallel scan:
``chunk`` is the split of ``L``.  The chunk pass (grid ``(B, Di/d_block,
L/chunk - 1)``) and the output pass (grid ``(B, Di/d_block, L/chunk)``)
run one thread per channel (``d_block`` threads, at most 512) holding its
``N`` (at most 16) f32 states in registers for one chunk, with the
chunk's ``B`` and ``C`` staged in shared memory as f32 (``2 * chunk * N *
4`` bytes, whatever the input dtype); the carry pass between them runs one
thread per ``(batch, state, channel)``.  Three launches a call, one when
``chunk == L``.  The wrapper allocates the f32 scratch, ``B * (L/chunk) *
Di * (N + 1)`` floats (the chunks' end states and their sums of ``dt``).
At ``N = 16`` every ``scan_chunk`` option of the JAX space (64, 128, 256)
launches in both dtypes (256 takes 32,768 bytes); a chunk above 1,816
steps would not fit a block.

**quantize_int8** (``csrc/quantize.cu``).  A row's elements stay on chip
between its amax and the write of q, so x is read once; ``quantize_launch``
picks one of five regimes from the width ``C`` and the dtype alone, counted
in units of 16 elements (one 16-byte store of q):

* ``narrow`` (at most 16 units): a group of ``lanes`` lanes (the units
  rounded up to a power of two) holds a row, a unit a lane, and several
  rows share a warp; the row's max is a shuffle max within the group.
* ``warp`` (at most 128 bytes of x a lane, a 4 KiB row): one warp a row, 1
  or 2 units a lane in f32, 1, 2 or 4 in bf16, every load issued before the
  reduction.
* ``cta`` (a row that fits ``QUANT_SLICE_BYTES``, 115,456 bytes: two blocks
  an SM): one block a row; bulk copies bring the row into shared memory,
  a block reduction gives the amax and q is written from the copy.
* ``cluster`` (at most ``QUANT_MAX_CLUSTER`` such slices): a thread-block
  cluster of 2-8 blocks a row, each block a slice of ``slice_units`` units
  loaded as in ``cta``; the blocks' partial maxima meet through distributed
  shared memory.
* ``two_pass`` (wider rows): one block a row reads it twice, so that no
  width is refused, as the JAX kernel refuses none.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import List, Tuple

SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on sm_90
REGISTERS_PER_SM = 65_536
FLASH_HEAD_DIMS = (16, 32, 64, 128, 160)  # head_dims the forward kernel is instantiated for
FLASH_BWD_HEAD_DIMS = FLASH_HEAD_DIMS  # and the backward kernels

# the JAX schedule space's attn_block and scan_chunk options (repro
# core/space.py:136,140)
ATTN_BLOCK_OPTIONS: Tuple[Tuple[int, int], ...] = tuple(
    itertools.product((128, 256, 512), (128, 256, 512))
)

SCAN_CHUNK_OPTIONS: Tuple[int, ...] = (64, 128, 256)

MAX_BLOCK_THREADS = 1024  # threads one CUDA block may hold
_BF16_KEY_STEP = 64  # keys per ring stage and online-softmax step, bf16 kernel
_F32_KEY_STEP = 16   # keys per online-softmax step, f32 kernel
_WG = 128            # threads of a warpgroup
_WG_ROWS = 64        # rows of one consumer warpgroup (the wgmma M)
_ALIGN_SLACK = 1024  # bytes: a 128-byte-swizzled TMA tile starts on a 1,024-byte boundary
_MBARRIER = 8        # bytes of one mbarrier


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def max_threads(head_dim: int, dtype: str) -> int:
    """The ``__launch_bounds__`` the kernel is compiled with."""
    if dtype == "float32":
        return 256
    return 384 if head_dim > 64 else 640


def f32_lanes(head_dim: int) -> int:
    """f32 kernel: threads a query row (two at head_dim 160: a row's query
    and accumulator would not fit one thread's registers)."""
    return 2 if head_dim > 128 else 1


def _consumers(rows: int) -> int:
    return -(-rows // _WG_ROWS)


def _ring_stages(block: int) -> int:
    """Stages of 64 (keys or depth) that hold one ``block``, at least 2."""
    return max(2, -(-block // _BF16_KEY_STEP))


@dataclass(frozen=True)
class FlashLaunch:
    block_q: int
    block_kv: int
    threads: int
    kv_pad: int  # key rows staged at a time (bf16: the ring's 64 * stages)
    smem_bytes: int
    grid: Tuple[int, int, int]  # (query tiles, q heads, batch)


def flash_smem_bytes(block_kv: int, head_dim: int, dtype: str, block_q: int) -> Tuple[int, int]:
    """(staged key rows, shared-memory bytes) of one block."""
    if dtype == "float32":
        kv_pad = _round_up(block_kv, _F32_KEY_STEP)
        return kv_pad, 2 * kv_pad * head_dim * 4
    stages = _ring_stages(block_kv)
    tile = _BF16_KEY_STEP * head_dim * 2  # 64 rows of Q, K or V
    smem = (_ALIGN_SLACK + _consumers(block_q) * tile + stages * 2 * tile
            + _MBARRIER * (1 + 2 * stages))
    return stages * _BF16_KEY_STEP, smem


def flash_threads(block_q: int, dtype: str, head_dim: int) -> int:
    if dtype == "float32":
        return block_q * f32_lanes(head_dim)
    return _WG * (_consumers(block_q) + 1)


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def flash_launch(
    batch: int, q_heads: int, seq_q: int, seq_kv: int, head_dim: int,
    dtype: str, block_q: int, block_kv: int,
) -> FlashLaunch:
    """The launch of one ``flash_attention`` call, or ``ValueError``."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, not {dtype}")
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is built for head_dim in {FLASH_HEAD_DIMS}, not {head_dim}")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"tile ({block_q}, {block_kv}) must be positive")
    bq, bkv = min(block_q, seq_q), min(block_kv, seq_kv)  # JAX's clamp, nothing else
    kv_pad, smem = flash_smem_bytes(bkv, head_dim, dtype, bq)
    threads = flash_threads(bq, dtype, head_dim)
    limit = max_threads(head_dim, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"attention tile (block_q={bq}, block_kv={bkv}) at head_dim {head_dim} "
            f"in {dtype} needs {smem} bytes of shared memory; a Hopper block has "
            f"{SMEM_PER_BLOCK}"
        )
    if threads > MAX_BLOCK_THREADS:
        raise ValueError(
            f"attention tile (block_q={bq}, block_kv={bkv}) at head_dim {head_dim} "
            f"in {dtype} needs {threads} threads; a CUDA block holds at most "
            f"{MAX_BLOCK_THREADS} threads"
        )
    if threads > limit:
        raise ValueError(
            f"attention tile (block_q={bq}, block_kv={bkv}) at head_dim {head_dim} "
            f"in {dtype} needs {threads} threads (and {smem} bytes of shared memory); "
            f"the kernel is compiled for at most {limit} threads "
            f"({REGISTERS_PER_SM // limit // 8 * 8} registers each)"
        )
    grid = ((seq_q + bq - 1) // bq, q_heads, batch)
    return FlashLaunch(bq, bkv, threads, kv_pad, smem, grid)


# The backward (csrc/flash_attention_backward.cu): a dQ kernel (a block a
# 128-row q tile of a q head, walking the kv tiles up to the diagonal twice:
# Delta = rowsum(P * dP), then dQ) and a dK/dV kernel (a block a 128-key tile
# of a kv head, 64 at head_dim 160, looping over the group's q-heads and
# their q tiles from the diagonal down).  bf16: both are TMA -> wgmma
# pipelines of one producer and two consumer warpgroups (64 rows each; the
# dK/dV block at head_dim 160 one consumer) and a ring of four stages; f32:
# a thread a row (two at 160).  Its tiles are the kernel's own: the plan
# tunes only the forward's, as in the JAX package.
FLASH_BWD_STAGES = 4  # bf16: ring stages of either kernel
_BWD_PAD_ROWS = 64  # bf16: the dQ kernel's lse and Delta scratch pads each head's rows to 64
_BWD_F32_ROWS = 64  # f32: rows (keys or queries) a block
_BWD_F32_STAGED = 16  # f32: rows of the other side staged at a time


def flash_backward_consumers(head_dim: int) -> Tuple[int, int]:
    """bf16 (dK/dV, dQ) consumer warpgroups a block: at head_dim 160 a
    dK/dV thread holds dK and dV at 80 floats each, more than the 168
    registers a thread of three warpgroups compiles for, so that block is
    one consumer and the producer."""
    return (1 if head_dim > 128 else 2), 2


@dataclass(frozen=True)
class FlashBwdLaunch:
    dkdv_tile: Tuple[int, int]  # (keys a block owns, q rows a ring stage or staged at a time)
    dq_tile: Tuple[int, int]  # (q rows a block owns, keys a ring stage or staged at a time)
    dkdv_threads: int
    dq_threads: int
    dkdv_smem: int
    dq_smem: int
    dkdv_grid: Tuple[int, int, int]  # (kv heads, batch, kv tiles): heaviest tile first
    dq_grid: Tuple[int, int, int]  # (q heads, batch, q tiles): the last tile launched first
    scratch_floats: int  # f32 the wrapper allocates for the dQ kernel to hand the dK/dV kernel


def flash_backward_threads(head_dim: int, dtype: str) -> Tuple[int, int]:
    """(dK/dV, dQ) threads a block."""
    if dtype == "float32":
        n = _BWD_F32_ROWS * f32_lanes(head_dim)
        return n, n
    kv, q = flash_backward_consumers(head_dim)
    return _WG * (kv + 1), _WG * (q + 1)


def flash_backward_tiles(head_dim: int, dtype: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((dk/dv keys, q rows a stage), (dq rows, keys a stage)).  bf16: 64
    rows a consumer warpgroup; the dK/dV ring stages 64 q rows, 16 at
    head_dim 128 and 160 (so that dK, dV, S^T and dP^T fit the registers a
    thread is compiled for); the dQ ring 64 keys, 32 at head_dim 160 (dQ, S
    and dP within 168 registers).  f32: a thread a row (two at head_dim
    160), 64 rows a block, 16 rows of the other side staged."""
    if dtype == "float32":
        return (_BWD_F32_ROWS, _BWD_F32_STAGED), (_BWD_F32_ROWS, _BWD_F32_STAGED)
    kv, q = flash_backward_consumers(head_dim)
    return ((kv * _WG_ROWS, 64 if head_dim <= 64 else 16),
            (q * _WG_ROWS, _WG_ROWS if head_dim <= 128 else 32))


def flash_backward_smem_bytes(head_dim: int, dtype: str) -> Tuple[int, int]:
    """(dk/dv kernel, dq kernel) shared-memory bytes of one block.  bf16:
    alignment slack, the block's own rows (K and V, or Q and dO) once, a ring
    of four stages (dK/dV: Q and dO of a stage's q rows and their lse and
    Delta in f32; dQ: K and V of 64 keys), and 8-byte mbarriers (one for the
    own rows, two a stage)."""
    (kc, kr), (qr, qc) = flash_backward_tiles(head_dim, dtype)
    if dtype == "float32":
        own = 2 * kc * (head_dim + 1) * 4  # the block's K and V (or Q and dO) rows, padded
        staged = 2 * kr * head_dim * 4
        return own + staged + 2 * kr * 4, own + staged
    st, bars = FLASH_BWD_STAGES, _MBARRIER * (1 + 2 * FLASH_BWD_STAGES)
    dkdv = _ALIGN_SLACK + 2 * kc * head_dim * 2 + st * (2 * kr * head_dim * 2 + 2 * kr * 4) + bars
    dq = _ALIGN_SLACK + 2 * qr * head_dim * 2 + st * 2 * qc * head_dim * 2 + bars
    return dkdv, dq


def flash_backward_scratch_floats(batch: int, q_heads: int, seq_q: int, dtype: str) -> int:
    """bf16: lse in log2 units and Delta, each (B, Hq, Sq rounded up to 64);
    f32: Delta (B, Hq, Sq)."""
    if dtype == "float32":
        return batch * q_heads * seq_q
    return 2 * batch * q_heads * _round_up(seq_q, _BWD_PAD_ROWS)


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def flash_backward_launch(
    batch: int, q_heads: int, kv_heads: int, seq_q: int, seq_kv: int, head_dim: int, dtype: str,
) -> FlashBwdLaunch:
    """The launch of one ``flash_attention_backward`` call, or ``ValueError``."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"flash_attention backward takes float32 or bfloat16, not {dtype}")
    if head_dim not in FLASH_BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward is built for head_dim in {FLASH_BWD_HEAD_DIMS}, "
                         f"not {head_dim}")
    if q_heads % kv_heads:
        raise ValueError(f"q heads {q_heads} not a multiple of kv heads {kv_heads}")
    dkdv, dq = flash_backward_tiles(head_dim, dtype)
    s_kv, s_q = flash_backward_smem_bytes(head_dim, dtype)
    if max(s_kv, s_q) > SMEM_PER_BLOCK:
        raise ValueError(f"flash backward at head_dim {head_dim} in {dtype} needs "
                         f"{max(s_kv, s_q)} bytes of shared memory; a Hopper block has {SMEM_PER_BLOCK}")
    return FlashBwdLaunch(
        dkdv, dq, *flash_backward_threads(head_dim, dtype), s_kv, s_q,
        (kv_heads, batch, -(-seq_kv // dkdv[0])), (q_heads, batch, -(-seq_q // dq[0])),
        flash_backward_scratch_floats(batch, q_heads, seq_q, dtype))


def launchable_attn_blocks(head_dim: int = 64, dtype: str = "bfloat16") -> List[Tuple[int, int]]:
    """Which of the JAX space's ``attn_block`` options launch (long sequences)."""
    out = []
    for bq, bkv in ATTN_BLOCK_OPTIONS:
        try:
            flash_launch(1, 1, 1 << 20, 1 << 20, head_dim, dtype, bq, bkv)
        except ValueError:
            continue
        out.append((bq, bkv))
    return out


# ---------------------------------------------------------------------------
# moe_gemm
# ---------------------------------------------------------------------------
MOE_MAX_THREADS = {"bfloat16": 384, "float32": 512}  # the kernels' __launch_bounds__
_MOE_BN_CHOICES = (128, 256)  # bf16: the wgmma N widths the kernel is built for
_MOE_F32_MICRO = 8  # f32: each thread owns 8 x 8 outputs
_MOE_F32_SLAB = 16  # f32: rows of d staged at a time


@dataclass(frozen=True)
class MoeLaunch:
    block_c: int
    block_f: int
    block_d: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]  # (experts, row tiles, column tiles)
    x_t: bool = False  # x is stored (E, d, C)
    w_t: bool = False  # w is stored (E, f, d)


def moe_bn(block_f: int) -> int:
    """The bf16 kernel's wgmma N: the column chunk a consumer computes at a time."""
    return next((n for n in _MOE_BN_CHOICES if block_f <= n), _MOE_BN_CHOICES[-1])


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def moe_gemm_launch(
    E: int, C: int, d: int, f: int, dtype: str, block_c: int, block_f: int, block_d: int,
    x_t: bool = False, w_t: bool = False,
) -> MoeLaunch:
    """The launch of one ``moe_gemm`` call ``(E,C,d) x (E,d,f)``, or ``ValueError``.

    ``x_t`` / ``w_t``: the operand is stored transposed, ``(E,d,C)`` /
    ``(E,f,d)`` (bf16 only: the f32 kernel takes contiguous operands)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moe_gemm kernel takes float32 or bfloat16, not {dtype}")
    if min(block_c, block_f, block_d) < 1:
        raise ValueError(f"tile ({block_c}, {block_f}, {block_d}) must be positive")
    bc, bf, bd = min(block_c, C), min(block_f, f), min(block_d, d)  # JAX's clamp
    tile = f"moe tile (block_c={bc}, block_f={bf}, block_d={bd})"
    if C % bc or f % bf or d % bd:
        raise ValueError(f"{tile} does not divide (C={C}, f={f}, d={d})")
    if dtype == "bfloat16":
        if d % 8 or f % 8 or (x_t and C % 8) or bd % 8 or bf % 8:
            raise ValueError(
                f"{tile} in bfloat16: TMA reads 16-byte rows, so d={d}, f={f} (and C={C} "
                "for a transposed x), block_d and block_f must be multiples of 8"
            )
        consumers = -(-bc // _WG_ROWS)
        threads = _WG * (consumers + 1)
        stage = (consumers * _WG_ROWS + moe_bn(bf)) * _BF16_KEY_STEP * 2
        stages = _ring_stages(bd)
        smem = _ALIGN_SLACK + stages * (stage + 2 * _MBARRIER) + _MBARRIER
    else:
        if x_t or w_t:
            raise ValueError(f"{tile} in float32: the kernel takes contiguous operands only")
        ny, nx = -(-bc // _MOE_F32_MICRO), -(-bf // _MOE_F32_MICRO)
        threads = ny * nx
        smem = (ny * _MOE_F32_MICRO * (_MOE_F32_SLAB + 1) + _MOE_F32_SLAB * nx * _MOE_F32_MICRO) * 4
    if threads > MOE_MAX_THREADS[dtype]:
        raise ValueError(
            f"{tile} in {dtype} needs {threads} threads; the kernel is compiled for "
            f"at most {MOE_MAX_THREADS[dtype]}"
        )
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{tile} in {dtype} needs {smem} bytes of shared memory; a Hopper block "
            f"has {SMEM_PER_BLOCK}"
        )
    return MoeLaunch(bc, bf, bd, threads, smem, (E, C // bc, f // bf), bool(x_t), bool(w_t))


# ---------------------------------------------------------------------------
# selective_scan
# ---------------------------------------------------------------------------
SCAN_MAX_THREADS = 512  # the __launch_bounds__ of the scan kernel
SCAN_MAX_STATE = 16  # states per channel held in registers


@dataclass(frozen=True)
class ScanLaunch:
    chunk: int
    d_block: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]  # the output pass's (batch, channel blocks, chunks)
    scratch_floats: int  # f32 scratch the wrapper allocates (0 for one chunk)

    @property
    def kernels(self) -> int:
        """Kernel launches a call: chunk, carry and output passes, or the
        output pass alone for one chunk."""
        return 3 if self.grid[2] > 1 else 1


def scan_smem_bytes(chunk: int, n_state: int) -> int:
    """B and C of one chunk (chunk x N each), staged in f32."""
    return 2 * chunk * n_state * 4


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def scan_launch(
    B: int, L: int, Di: int, N: int, dtype: str, chunk: int, d_block: int
) -> ScanLaunch:
    """The launch of one ``selective_scan`` call, or ``ValueError``."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"selective_scan kernel takes float32 or bfloat16, not {dtype}")
    if chunk < 1 or d_block < 1:
        raise ValueError(f"scan tile (chunk={chunk}, d_block={d_block}) must be positive")
    ch, db = min(chunk, L), min(d_block, Di)  # JAX's clamp
    tile = f"scan tile (chunk={ch}, d_block={db})"
    if L % ch or Di % db:
        raise ValueError(f"{tile} does not divide (L={L}, Di={Di})")
    if N > SCAN_MAX_STATE:
        raise ValueError(f"selective_scan kernel holds at most {SCAN_MAX_STATE} states, not N={N}")
    if db > SCAN_MAX_THREADS:
        raise ValueError(
            f"{tile} needs {db} threads (one per channel); the kernel is compiled for "
            f"at most {SCAN_MAX_THREADS}"
        )
    smem = scan_smem_bytes(ch, N)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{tile} at N={N} in {dtype} needs {smem} bytes of shared memory; a Hopper "
            f"block has {SMEM_PER_BLOCK}"
        )
    chunks = L // ch
    scratch = B * chunks * Di * (N + 1) if chunks > 1 else 0
    return ScanLaunch(ch, db, db, smem, (B, Di // db, chunks), scratch)


# The backward (the same file), at the forward's tile.  Passes: the chunks'
# local adjoints from zero (grid (B, Di/d_block, L/chunk - 1), a thread a
# channel with its N states), their reverse fold (a thread a (batch, state,
# channel)), the output pass (grid (B, Di/d_block, L/chunk) of 256 threads:
# a thread holds 4 states of a channel, 64 channels in flight, the tile's
# d_block channels 64 at a time; each chunk's states rerun from its carry-in,
# keeping each 64-step segment's start, then a segment at a time,
# checkpointed every 4 steps in shared memory, each 4-step span rerun into
# registers and walked back), and a reduction of
# the partial dB, dC, dA and dD sums.  Four launches a call, two when chunk
# == L.
SCAN_BWD_THREADS = 256
SCAN_BWD_STATES_PER_THREAD = 4
SCAN_BWD_SPAN = 4  # steps between the output pass's checkpoints
SCAN_BWD_SEGMENT = 64  # steps whose checkpoints the output pass holds at once
SCAN_BWD_CHANNELS = SCAN_BWD_THREADS * SCAN_BWD_STATES_PER_THREAD // SCAN_MAX_STATE  # in flight
_SCAN_BWD_WARPS = SCAN_BWD_THREADS // 32
SCAN_BWD_MIN_BLOCKS_PER_SM = 2  # the output pass's __launch_bounds__: <= 128 registers a thread
SMEM_PER_SM = 233_472  # bytes of shared memory an H100 SM has for blocks (228 KB)
SMEM_RESERVED_PER_BLOCK = 1_024  # bytes the runtime keeps of it for each resident block


@dataclass(frozen=True)
class ScanBwdLaunch:
    chunk: int
    d_block: int
    threads: int  # of the output pass
    smem_bytes: int  # of the output pass
    grid: Tuple[int, int, int]  # the output pass's (batch, channel blocks, chunks)
    scratch_floats: int  # f32 scratch the wrapper allocates

    @property
    def kernels(self) -> int:
        return 4 if self.grid[2] > 1 else 2

    @property
    def blocks_per_sm(self) -> int:
        """Output-pass blocks an SM holds: its registers allow two, its shared
        memory (each block's plus what the runtime reserves) may allow fewer."""
        return min(SCAN_BWD_MIN_BLOCKS_PER_SM, SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED_PER_BLOCK))


def scan_backward_smem_bytes(chunk: int) -> int:
    """The output pass: B and C of a segment (at most 64 steps) staged in f32
    (16 states a step, zero past N), its checkpoints (4 floats a thread every
    4 steps) and the chunk's other segments' start states (4 floats a thread
    each), two buffers of the warps' per-step dB and dC sums over a span (8
    warps x 4 steps x 32 floats) and three of a span's dt, u and gy in f32
    (3 x 4 steps x 64 channels)."""
    seg, segs = min(chunk, SCAN_BWD_SEGMENT), -(-chunk // SCAN_BWD_SEGMENT)
    per_thread = SCAN_BWD_THREADS * SCAN_BWD_STATES_PER_THREAD
    return 4 * (2 * seg * SCAN_MAX_STATE + (-(-seg // SCAN_BWD_SPAN) + segs - 1) * per_thread
                + 2 * _SCAN_BWD_WARPS * SCAN_BWD_SPAN * 32 + 3 * 3 * SCAN_BWD_SPAN * SCAN_BWD_CHANNELS)


def scan_backward_scratch_floats(B: int, L: int, Di: int, N: int, chunk: int, d_block: int) -> int:
    """The adjoint carries and sums of dt (B * L/chunk * Di * (N + 1), none
    for one chunk), the partial dB and dC rows of each channel block (2 * B
    * L * Di/d_block * N) and the partial dA and dD of each chunk (B *
    L/chunk * Di * (N + 1))."""
    chunks = L // chunk
    per_chunk = B * chunks * Di * (N + 1)
    return (per_chunk if chunks > 1 else 0) + 2 * B * L * (Di // d_block) * N + per_chunk


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def scan_backward_launch(
    B: int, L: int, Di: int, N: int, dtype: str, chunk: int, d_block: int
) -> ScanBwdLaunch:
    """The launch of one ``selective_scan_backward`` call at the forward's
    tile (``scan_launch``'s clamp and checks), or ``ValueError``."""
    fwd = scan_launch(B, L, Di, N, dtype, chunk, d_block)
    smem = scan_backward_smem_bytes(fwd.chunk)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"scan tile (chunk={fwd.chunk}, d_block={fwd.d_block}) at N={N}: the backward needs "
            f"{smem} bytes of shared memory; a Hopper block has {SMEM_PER_BLOCK}"
        )
    return ScanBwdLaunch(fwd.chunk, fwd.d_block, SCAN_BWD_THREADS, smem, fwd.grid,
                         scan_backward_scratch_floats(B, L, Di, N, fwd.chunk, fwd.d_block))


def launchable_scan_chunks(d_block: int = 256, n_state: int = 16, dtype: str = "bfloat16") -> List[int]:
    """Which of the JAX space's ``scan_chunk`` options launch (long sequences)."""
    out = []
    for ch in SCAN_CHUNK_OPTIONS:
        try:
            scan_launch(1, 1 << 20, d_block, n_state, dtype, ch, d_block)
        except ValueError:
            continue
        out.append(ch)
    return out


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------
QUANT_UNIT = 16  # elements a unit: one 16-byte store of q
QUANT_WARP_THREADS = 256  # the warp regimes' block: 8 warps
QUANT_LANE_BYTES = 128  # bytes of x one lane holds in the warp regimes (8 loads of 16 bytes)
QUANT_WARP_UNITS = {"float32": (1, 2), "bfloat16": (1, 2, 4)}  # units a lane the kernel is built for
QUANT_SLICE_THREADS = 512  # most threads of a cta / cluster / two_pass block: __launch_bounds__(512, 2)
QUANT_HEADER_BYTES = 256  # shared memory before a slice: its mbarriers and the block reduction
QUANT_PIECE_BYTES = 16_384  # bytes of one bulk copy; a slice takes at most QUANT_MAX_PIECES
QUANT_MAX_PIECES = 8
QUANT_SLICE_BYTES = SMEM_PER_SM // 2 - SMEM_RESERVED_PER_BLOCK - QUANT_HEADER_BYTES  # two blocks an SM
QUANT_MAX_CLUSTER = 8  # the portable cluster size
QUANT_REGIMES = ("narrow", "warp", "cta", "cluster", "two_pass")
_QUANT_ESZ = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class QuantLaunch:
    regime: str  # one of QUANT_REGIMES
    threads: int  # a block's
    grid: int  # blocks
    lanes: int  # narrow / warp: lanes a row (a power of two, at most 32); else 0
    units_per_lane: int  # narrow / warp: units a lane holds; else 0
    cluster: int  # blocks a row: 1, or 2-8 in the cluster regime
    slice_units: int  # cta / cluster: units of a block's slice (the last may hold fewer); else 0
    smem_bytes: int  # dynamic shared memory of a block


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def quantize_launch(rows: int, cols: int, dtype: str) -> QuantLaunch:
    """The launch of one ``quantize_int8`` call of ``(rows, cols)``, or ``ValueError``."""
    if dtype not in _QUANT_ESZ:
        raise ValueError(f"quantize_int8 kernel takes float32 or bfloat16, not {dtype}")
    if rows < 1 or cols < 1:
        raise ValueError(f"quantize_int8 kernel takes a non-empty (R, C), not ({rows}, {cols})")
    unit_bytes = QUANT_UNIT * _QUANT_ESZ[dtype]
    units = -(-cols // QUANT_UNIT)
    if units <= 16:
        lanes = _pow2_at_least(units)
        rows_a_block = QUANT_WARP_THREADS // lanes
        return QuantLaunch("narrow", QUANT_WARP_THREADS, -(-rows // rows_a_block), lanes, 1, 1, 0, 0)
    if units * unit_bytes <= 32 * QUANT_LANE_BYTES:
        per_lane = min(k for k in QUANT_WARP_UNITS[dtype] if 32 * k >= units)
        return QuantLaunch("warp", QUANT_WARP_THREADS, -(-rows // (QUANT_WARP_THREADS // 32)), 32,
                           per_lane, 1, 0, 0)
    cluster = -(-units // (QUANT_SLICE_BYTES // unit_bytes))
    if cluster > QUANT_MAX_CLUSTER:
        return QuantLaunch("two_pass", QUANT_SLICE_THREADS, rows, 0, 0, 1, 0, QUANT_HEADER_BYTES)
    slice_units = -(-units // cluster)
    threads = min(QUANT_SLICE_THREADS, max(128, _round_up(-(-slice_units // 2), 32)))
    return QuantLaunch("cta" if cluster == 1 else "cluster", threads, rows * cluster, 0, 0, cluster,
                       slice_units, QUANT_HEADER_BYTES + slice_units * unit_bytes)
