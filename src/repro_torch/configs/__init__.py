"""Architecture registry of the port: ``get_config(arch_id)``.

Every arch id of the JAX package resolves, in the JAX package's order.  Which
of them fit one H100 at full width is ``PERF.md`` section 4's business: the
configs are the published ones whatever the card holds.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import SHAPES, InputShape, LayerSpec, ModelConfig

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "musicgen-large": "musicgen_large",
    "granite-3-2b": "granite_3_2b",
    "nemotron-4-15b": "nemotron_4_15b",
    "stablelm-12b": "stablelm_12b",
    "deepseek-67b": "deepseek_67b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {list(SHAPES)}")
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """Yield every (arch, shape) dry-run cell, as the JAX package's ``cells``:
    ``long_500k`` needs sub-quadratic attention and is skipped for the pure
    full-attention archs unless ``include_skipped``."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_name, shape in SHAPES.items():
            if shape_name == "long_500k" and not cfg.sub_quadratic and not include_skipped:
                continue
            yield cfg, shape


__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "LayerSpec", "ModelConfig", "cells", "get_config",
           "get_shape"]
