"""Architecture registry of the port: ``get_config(arch_id)``.

The port runs the archs in ``_MODULES``.  Every other arch id of the JAX
package is listed in ``_LATER`` with the ROADMAP item that brings it, and
asking for it raises.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import SHAPES, InputShape, LayerSpec, ModelConfig

_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    # their layers are ported, but neither fits one card: reduced() on the CPU
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
}

# arch id -> the ROADMAP item (queue A/B) that ports what it needs
_LATER = {
    "qwen2-vl-72b": "A2 (M-RoPE, embeddings input)",
    "musicgen-large": "A2 (sinusoidal positions, embeddings input)",
    "nemotron-4-15b": "A2 (dense archs beyond granite-3-2b)",
    "stablelm-12b": "A2 (dense archs beyond granite-3-2b)",
    "deepseek-67b": "A2 (dense archs beyond granite-3-2b)",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: ROADMAP item {_LATER[arch_id]}"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {list(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "LayerSpec", "ModelConfig", "get_config", "get_shape"]
