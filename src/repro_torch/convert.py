"""Weights carried across from the JAX package.

``params_from_numpy`` takes the JAX ``init_params`` pytree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: the same nesting, the same stacked leading ``n_periods``
axis, the same ``(in, out)`` weight layout.  Each leaf keeps its own dtype:
the MoE ``router`` and the Mamba ``A_log`` and ``Dp`` are f32, every other
leaf (Mamba's ``dt_b`` included) is in ``cfg.dtype``; a leaf of another
dtype raises.  bf16 leaves (numpy's ``ml_dtypes`` bfloat16) pass through
float32, which holds them exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

F32_LEAVES = ("router", "A_log", "Dp")  # f32 whatever the model dtype


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    device = resolve_device(device)
    for name in ("blocks", "final_norm", "embed"):
        if name not in tree:
            raise KeyError(f"parameter tree lacks {name!r}")
    periods = {np.asarray(v).shape[0] for b in tree["blocks"].values() for v in _leaves(b)}
    if periods != {cfg.n_periods}:
        raise ValueError(f"stacked axis {sorted(periods)} != n_periods {cfg.n_periods}")

    def conv(t, path=()):
        return {
            k: conv(v, path + (k,)) if isinstance(v, dict) else _checked(v, path + (k,))
            for k, v in t.items()
        }

    def _checked(a, path):
        want = "float32" if path[-1] in F32_LEAVES else cfg.dtype
        got = np.asarray(a).dtype.name
        if got != want:
            raise ValueError(f"leaf {'.'.join(path)} is {got}; the port expects {want}")
        return _leaf(a, device)

    return conv(tree)


def _leaves(t: dict):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
