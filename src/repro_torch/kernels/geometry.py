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
key axis one ``block_kv`` tile at a time, staging that tile of K and V in
shared memory:

* bf16 kernel: one warp per 16 query rows, so ``32 * ceil(block_q / 16)``
  threads; K is staged row-major and V transposed, each row padded by 8
  elements, and the key tile is padded up to a multiple of 64 keys (the
  online-softmax step).  The kernel is compiled for at most 512 threads at
  head_dim <= 64 (128 registers each) and 256 at head_dim 128.
* f32 kernel: one thread per query row, so ``block_q`` threads (at most
  256), K and V staged row-major, the key tile padded to a multiple of 16.

Of the JAX schedule space's nine ``attn_block`` options, ``(128|256|512)²``,
at head_dim 64 in bf16 the six with ``block_q`` in (128, 256) are
launchable; ``block_q = 512`` would need 1,024 threads and raises.

**moe_gemm** (``csrc/moe_gemm.cu``).  Grid ``(E, C/block_c, f/block_f)``;
one block owns a ``block_c x block_f`` output tile and loops over ``d`` in
``block_d`` steps (the TPU's sequential fourth grid axis):

* bf16 kernel: one warp per 32 x 64 piece of the tile, so
  ``32 * ceil(block_c/32) * ceil(block_f/64)`` threads (at most 512); each
  ``block_d`` step stages the x tile ``[block_c][block_d]`` and the w tile
  ``[block_d][block_f]`` whole, rows padded by 8 elements, rows and columns
  padded up to the warp tile and zero-filled.  It stages 16-byte vectors, so
  ``d``, ``f``, ``block_d`` and ``block_f`` must be multiples of 8.  The
  default plan tile (128, 256, 256) takes 512 threads and 202,752 bytes.
* f32 kernel: one thread per 8 x 8 outputs (``ceil(block_c/8) *
  ceil(block_f/8)`` threads, at most 512); each ``block_d`` step is staged
  16 rows of ``d`` at a time (a whole f32 step of the default tile would
  need 393,216 bytes).

**selective_scan** (``csrc/selective_scan.cu``).  Grid ``(B, Di/d_block)``,
one thread per channel (``d_block`` threads, at most 512) holding its ``N``
(at most 16) f32 states in registers for all of ``L``; each ``chunk`` of
time steps stages ``u`` and ``dt`` (``chunk x d_block``) and ``B``, ``C``
(``chunk x N``) in the input dtype.  At ``d_block = 256``, ``N = 16``, of
the JAX space's ``scan_chunk`` options (64, 128, 256) bf16 launches 64 and
128 (256 needs 278,528 bytes) and f32 launches 64 only (128 needs 278,528).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Tuple

SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on sm_90
REGISTERS_PER_SM = 65_536
HEAD_DIMS = (16, 32, 64, 128)  # head_dims the kernel is instantiated for

# the JAX schedule space's attn_block and scan_chunk options (repro
# core/space.py:136,140)
ATTN_BLOCK_OPTIONS: Tuple[Tuple[int, int], ...] = tuple(
    itertools.product((128, 256, 512), (128, 256, 512))
)

SCAN_CHUNK_OPTIONS: Tuple[int, ...] = (64, 128, 256)

_BF16_KEY_STEP = 64  # keys per online-softmax step, bf16 kernel
_F32_KEY_STEP = 16   # keys per online-softmax step, f32 kernel
_PAD = 8             # bf16 elements of padding per staged row


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def max_threads(head_dim: int, dtype: str) -> int:
    """The ``__launch_bounds__`` the kernel is compiled with."""
    if dtype == "float32":
        return 256
    return 256 if head_dim > 64 else 512


@dataclass(frozen=True)
class FlashLaunch:
    block_q: int
    block_kv: int
    threads: int
    kv_pad: int  # key rows staged per tile (block_kv padded up)
    smem_bytes: int
    grid: Tuple[int, int, int]  # (query tiles, q heads, batch)


def flash_smem_bytes(block_kv: int, head_dim: int, dtype: str) -> Tuple[int, int]:
    """(staged key rows, shared-memory bytes) of one block."""
    if dtype == "float32":
        kv_pad = _round_up(block_kv, _F32_KEY_STEP)
        return kv_pad, 2 * kv_pad * head_dim * 4
    kv_pad = _round_up(block_kv, _BF16_KEY_STEP)
    return kv_pad, (kv_pad * (head_dim + _PAD) + head_dim * (kv_pad + _PAD)) * 2


def flash_threads(block_q: int, dtype: str) -> int:
    if dtype == "float32":
        return block_q
    return 32 * ((block_q + 15) // 16)


def flash_launch(
    batch: int, q_heads: int, seq_q: int, seq_kv: int, head_dim: int,
    dtype: str, block_q: int, block_kv: int,
) -> FlashLaunch:
    """The launch of one ``flash_attention`` call, or ``ValueError``."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, not {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is built for head_dim in {HEAD_DIMS}, not {head_dim}")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"tile ({block_q}, {block_kv}) must be positive")
    bq, bkv = min(block_q, seq_q), min(block_kv, seq_kv)  # JAX's clamp, nothing else
    kv_pad, smem = flash_smem_bytes(bkv, head_dim, dtype)
    threads = flash_threads(bq, dtype)
    limit = max_threads(head_dim, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"attention tile (block_q={bq}, block_kv={bkv}) at head_dim {head_dim} "
            f"in {dtype} needs {smem} bytes of shared memory; a Hopper block has "
            f"{SMEM_PER_BLOCK}"
        )
    if threads > limit:
        raise ValueError(
            f"attention tile (block_q={bq}, block_kv={bkv}) at head_dim {head_dim} "
            f"in {dtype} needs {threads} threads (and {smem} bytes of shared memory); "
            f"the kernel is compiled for at most {limit} threads "
            f"({REGISTERS_PER_SM // limit} registers each)"
        )
    grid = ((seq_q + bq - 1) // bq, q_heads, batch)
    return FlashLaunch(bq, bkv, threads, kv_pad, smem, grid)


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
MOE_MAX_THREADS = 512  # the __launch_bounds__ of both moe_gemm kernels
_MOE_WARP_ROWS, _MOE_WARP_COLS = 32, 64  # bf16: the output piece of one warp
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


def moe_gemm_launch(
    E: int, C: int, d: int, f: int, dtype: str, block_c: int, block_f: int, block_d: int
) -> MoeLaunch:
    """The launch of one ``moe_gemm`` call ``(E,C,d) x (E,d,f)``, or ``ValueError``."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moe_gemm kernel takes float32 or bfloat16, not {dtype}")
    if min(block_c, block_f, block_d) < 1:
        raise ValueError(f"tile ({block_c}, {block_f}, {block_d}) must be positive")
    bc, bf, bd = min(block_c, C), min(block_f, f), min(block_d, d)  # JAX's clamp
    tile = f"moe tile (block_c={bc}, block_f={bf}, block_d={bd})"
    if C % bc or f % bf or d % bd:
        raise ValueError(f"{tile} does not divide (C={C}, f={f}, d={d})")
    if dtype == "bfloat16":
        if d % 8 or f % 8 or bd % 8 or bf % 8:
            raise ValueError(
                f"{tile} in bfloat16: the kernel stages 16-byte rows, so d={d}, f={f}, "
                "block_d and block_f must be multiples of 8"
            )
        bc_pad = _round_up(bc, _MOE_WARP_ROWS)
        bf_pad = _round_up(bf, _MOE_WARP_COLS)
        bd_pad = _round_up(bd, 16)
        threads = 32 * (bc_pad // _MOE_WARP_ROWS) * (bf_pad // _MOE_WARP_COLS)
        smem = (bc_pad * (bd_pad + _PAD) + bd_pad * (bf_pad + _PAD)) * 2
    else:
        ny, nx = -(-bc // _MOE_F32_MICRO), -(-bf // _MOE_F32_MICRO)
        threads = ny * nx
        smem = (ny * _MOE_F32_MICRO * (_MOE_F32_SLAB + 1) + _MOE_F32_SLAB * nx * _MOE_F32_MICRO) * 4
    if threads > MOE_MAX_THREADS:
        raise ValueError(
            f"{tile} in {dtype} needs {threads} threads; the kernel is compiled for "
            f"at most {MOE_MAX_THREADS}"
        )
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{tile} in {dtype} needs {smem} bytes of shared memory; a Hopper block "
            f"has {SMEM_PER_BLOCK}"
        )
    return MoeLaunch(bc, bf, bd, threads, smem, (E, C // bc, f // bf))


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
    grid: Tuple[int, int]  # (batch, channel blocks)


def scan_smem_bytes(chunk: int, d_block: int, n_state: int, dtype: str) -> int:
    """u and dt (chunk x d_block) and B, C (chunk x N), staged in the input dtype."""
    esize = 2 if dtype == "bfloat16" else 4
    return (2 * chunk * d_block + 2 * chunk * n_state) * esize


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
    smem = scan_smem_bytes(ch, db, N, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{tile} at N={N} in {dtype} needs {smem} bytes of shared memory; a Hopper "
            f"block has {SMEM_PER_BLOCK}"
        )
    return ScanLaunch(ch, db, db, smem, (B, Di // db))


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
