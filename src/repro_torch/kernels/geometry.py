"""Launch geometry of the Hopper flash-attention kernel: pure integer math.

The Hopper counterpart of the JAX package's ``flash_vmem_bytes``: where the
TPU kernel's working set had to fit VMEM, the CUDA kernel's has to fit the
shared memory one block may use on an H100 (232,448 bytes) and its threads
the register file (65,536 registers of 32 bits on each SM).

One block of ``kernels/csrc/flash_attention.cu`` serves one query tile of
``block_q`` rows for one ``(batch, head)`` and loops over the key axis one
``block_kv`` tile at a time, staging that tile of K and V in shared memory:

* bf16 kernel: one warp per 16 query rows, so ``32 * ceil(block_q / 16)``
  threads; K is staged row-major and V transposed, each row padded by 8
  elements, and the key tile is padded up to a multiple of 64 keys (the
  online-softmax step).  The kernel is compiled for at most 512 threads at
  head_dim <= 64 (128 registers each) and 256 at head_dim 128.
* f32 kernel: one thread per query row, so ``block_q`` threads (at most
  256), K and V staged row-major, the key tile padded to a multiple of 16.

A tile is never shrunk: ``flash_launch`` applies the JAX kernel's own clamp
to the sequence length (``min(block, S)``) and raises ``ValueError`` for a
tile the kernel cannot launch.  Of the JAX schedule space's nine
``attn_block`` options, ``(128|256|512)²``, at head_dim 64 in bf16 the six
with ``block_q`` in (128, 256) are launchable; ``block_q = 512`` would need
1,024 threads and raises.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Tuple

SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on sm_90
REGISTERS_PER_SM = 65_536
HEAD_DIMS = (16, 32, 64, 128)  # head_dims the kernel is instantiated for

# the JAX schedule space's attn_block options (repro core/space.py:136)
ATTN_BLOCK_OPTIONS: Tuple[Tuple[int, int], ...] = tuple(
    itertools.product((128, 256, 512), (128, 256, 512))
)

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
