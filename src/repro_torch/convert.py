"""Weights carried across from the JAX package.

``params_from_numpy`` takes the JAX ``init_params`` pytree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: the same nesting, the same stacked leading ``n_periods``
axis, the same ``(in, out)`` weight layout.  Each leaf keeps its own dtype:
the MoE ``router`` and the Mamba ``A_log`` and ``Dp`` are f32, every other
leaf (Mamba's ``dt_b`` included) is in ``cfg.dtype``; a leaf of another
dtype raises.  bf16 leaves (numpy's ``ml_dtypes`` bfloat16) pass through
float32, which holds them exactly.  ``opt_state_from_numpy`` carries the
JAX optimizer state across the same way, so that an optimizer step can be
compared from identical state.
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
    # an embeddings-input arch (musicgen, qwen2-vl) has no embedding table
    for name in ("blocks", "final_norm") + (("embed",) if cfg.input_kind == "tokens" else ()):
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


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX ``init_opt_state`` / ``apply_updates`` state, its leaves as numpy
    (``jax.tree.map(np.asarray, state)``), as the port's optimizer state:
    ``mu``/``nu`` with the parameter nesting, each leaf an f32 tensor or an
    int8 moment ``{"q": int8, "s": f32}``, and ``step`` as an int."""
    device = resolve_device(device)
    for name in ("mu", "nu", "step"):
        if name not in tree:
            raise KeyError(f"optimizer state lacks {name!r}")

    def moment(a, path):
        a = np.asarray(a)
        want = "int8" if path[-1] == "q" else "float32"
        if a.dtype.name != want:
            raise ValueError(f"moment leaf {'.'.join(path)} is {a.dtype.name}; expected {want}")
        return torch.from_numpy(np.array(a)).to(device)

    def conv(t, path):
        return {k: conv(v, path + (k,)) if isinstance(v, dict) else moment(v, path + (k,))
                for k, v in t.items()}

    periods = {np.asarray(v).shape[0] for b in tree["mu"]["blocks"].values() for v in _leaves(b)}
    if periods != {cfg.n_periods}:
        raise ValueError(f"stacked axis {sorted(periods)} != n_periods {cfg.n_periods}")
    return {"mu": conv(tree["mu"], ("mu",)), "nu": conv(tree["nu"], ("nu",)),
            "step": int(np.asarray(tree["step"]))}


MLP_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")  # the JAX package's cost-MLP dict


def mlp_params_from_numpy(params: dict, device="cuda"):
    """The JAX package's cost-MLP parameters (``learned_cost._mlp_init``:
    ``w`` as ``(in, out)``, numpy or anything ``np.asarray`` takes) as the
    port's ``learned_cost.MLP`` on ``device``, f32."""
    from repro_torch.core.learned_cost import MLP

    device = resolve_device(device)
    p = {k: np.array(params[k], dtype=np.float32) for k in MLP_KEYS}  # writable copies
    net = MLP(p["w1"].shape[0], p["w1"].shape[1], device=device)
    with torch.no_grad():
        for i, lin in enumerate((net.l1, net.l2, net.l3), start=1):
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(p[f"w{i}"].T)))
            lin.bias.copy_(torch.from_numpy(p[f"b{i}"]))
    return net


def mlp_params_to_numpy(net) -> dict:
    """``mlp_params_from_numpy`` backwards: the module's parameters as numpy
    f32 under the JAX package's keys and layout."""
    out = {}
    for i, lin in enumerate((net.l1, net.l2, net.l3), start=1):
        out[f"w{i}"] = lin.weight.detach().cpu().numpy().T.copy()
        out[f"b{i}"] = lin.bias.detach().cpu().numpy().copy()
    return out
