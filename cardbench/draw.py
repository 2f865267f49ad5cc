"""Inputs drawn from ``--seed``: weights, token rows and a decode cache's history.

Every draw has a generator of its own on the device, seeded from the run's
seed and the draw's name (``sub_seed``), so a leaf or a layer's history can
be drawn again alone, for the reference, and comes out the same.  Weights
take the leaf names, shapes and dtypes the program declares
(``transformer.meta_params``) and are drawn in place, one call a stacked
leaf, by the rule the configuration file gives each leaf name under
``init``:

* ``["normal", mean, std]``;
* ``["normal_depth", std]``: ``std / sqrt(2 * n_layers)`` (output projections);
* ``["s4d_real"]``: ``log(1..N)`` along the last axis (Mamba's ``A_log``);
* ``["dt_log_uniform", lo, hi]``: the inverse softplus of a step drawn
  log-uniform in ``[lo, hi]`` (Mamba's ``dt`` bias).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for the draw ``names`` of the run ``seed``."""
    key = "/".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *names))


def flat(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def nest(items: Dict[str, object]) -> dict:
    out: dict = {}
    for path, v in items.items():
        *parents, leaf = path.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def rule_for(init: dict, path: str) -> list:
    return init.get(path.rsplit(".", 1)[-1], init["default"])


def fill_(t: torch.Tensor, rule: list, gen: torch.Generator, n_layers: int) -> torch.Tensor:
    kind, *args = rule
    if kind == "normal":
        return t.normal_(args[0], args[1], generator=gen)
    if kind == "normal_depth":
        return t.normal_(0.0, args[0] / max(1.0, math.sqrt(2 * n_layers)), generator=gen)
    if kind == "s4d_real":
        n = t.shape[-1]
        return t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=t.device)))
    if kind == "dt_log_uniform":
        u = torch.rand(t.shape, generator=gen, device=t.device)
        dt = torch.exp(u * (math.log(args[1]) - math.log(args[0])) + math.log(args[0]))
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))
    raise ValueError(f"unknown init rule {rule!r}")


def weights(meta: dict, init: dict, n_layers: int, seed: int, device, only=None) -> dict:
    """The weights of ``meta`` (a tree of meta tensors: names, shapes, dtypes)
    drawn on ``device``; ``only``: the dotted paths to draw (all by default),
    returned flat."""
    out = {}
    for path, leaf in flat(meta):
        if only is not None and path not in only:
            continue
        t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        out[path] = fill_(t, rule_for(init, path), generator(device, seed, "weights", path), n_layers)
    return out if only is not None else nest(out)


def token_rows(n: int, seq: int, vocab: int, seed: int, device, name: str = "tokens") -> torch.Tensor:
    """``(n, seq)`` int64 ids uniform over the vocabulary."""
    return torch.randint(0, vocab, (n, seq), generator=generator(device, seed, name), device=device)


def history(shape, std: float, seed: int, layer: str, name: str, device) -> torch.Tensor:
    """A layer's cache history of ``shape`` (rows, heads, positions, head
    size): N(0, std^2) in bfloat16."""
    t = torch.empty(shape, dtype=torch.bfloat16, device=device)
    return t.normal_(0.0, std, generator=generator(device, seed, "history", layer, name))
