#!/usr/bin/env python3
"""How far the embeddings archs' bf16 decode lies from a forward of the same
rows, and whether that is bf16 rounding: at depths that hold an f32 copy of
the weights, the bf16 forward and the bf16 decode each against an f32
forward of the same weights (cast to bf16); at deeper cuts, the bf16 decode
against the bf16 forward alone.  Bounds ``chip_smoke.py``'s
``DECODE_VS_FORWARD_REL_PER_SQRT_LAYER``.

    python3 scripts/torch_decode_noise.py

Runs on a machine with one CUDA card, from the root of a checkout.  The
inputs are ``chip_smoke.py``'s: ``EMBED_DECODE_STEPS`` N(0, 1) embeddings
rows from its seed at the decode's text positions, weights from its seed.
Prints one JSON line per arch and depth (relative norm and max abs of each
difference, ``per_sqrt_layer`` = the decode-vs-forward gap / sqrt(layers)),
then the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# arch -> (depths with an f32 copy, bf16-only depths)
DEPTHS = {"musicgen-large": ((4, 12, 48), ()), "qwen2-vl-72b": ((2, 4, 8), (16, 34))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_noise: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    name, _, limit = cs.nvidia_smi().partition(",")
    cs.CARD.update(card=name.strip(), power_limit=limit.strip())
    _build.build(cs.LIBRARIES)
    mods = cs.make_mods()
    tf, n = mods.transformer, cs.EMBED_DECODE_STEPS
    tiles = mods.tiles_from_plan(mods.SchedulePlan(attn_block=(128, 128)))  # launches in f32 too

    def diff(a, b) -> dict:
        d = a.float() - b.float()
        return {"rel": (d.norm() / b.float().norm()).item(), "max_abs": d.abs().max().item()}

    def cast(tree, dt):
        return {k: cast(v, dt) if isinstance(v, dict) else v.to(dt) for k, v in tree.items()}

    def decode(params, cfg, x):
        cache = tf.init_cache(cfg, 1, n, device="cuda")
        return torch.stack([tf.decode_step(params, cfg, cache, x[:, t:t + 1], t)[0] for t in range(n)], 1)

    for arch, (with_f32, bf16_only) in DEPTHS.items():
        base = mods.get_config(arch)
        x = torch.from_numpy(np.random.default_rng(cs.SEED).standard_normal(
            (1, n, base.d_model), dtype=np.float32)).cuda()
        pos = mods.make_positions(base, 1, n, device="cuda")
        with torch.no_grad():
            for layers in with_f32 + bf16_only:
                c16 = dataclasses.replace(base, n_layers=layers)
                row = {"arch": arch, "layers": layers}
                if layers in with_f32:
                    c32 = dataclasses.replace(c16, dtype="float32")
                    p32 = tf.init_params(c32, cs.SEED, device="cuda")
                    f32 = tf.forward(p32, c32, x, pos, tiles=tiles)
                    p16 = cast(p32, torch.bfloat16)
                    del p32
                else:
                    f32, p16 = None, tf.init_params(c16, cs.SEED, device="cuda")
                x16 = x.to(torch.bfloat16)
                f16 = tf.forward(p16, c16, x16, pos, tiles=tiles)
                d16 = decode(p16, c16, x16)
                if f32 is not None:
                    row.update(fwd_bf16_vs_f32=diff(f16, f32), dec_bf16_vs_f32=diff(d16, f32))
                row["dec_vs_fwd_bf16"] = diff(d16, f16)
                row["per_sqrt_layer"] = row["dec_vs_fwd_bf16"]["rel"] / math.sqrt(layers)
                print(json.dumps({**row, **cs.CARD}), flush=True)
                del p16, f32, f16, d16
                gc.collect()
                torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
