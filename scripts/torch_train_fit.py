#!/usr/bin/env python3
"""Which depth of a full-width model trains on one card: ``chip_smoke.py``'s
train phase at each depth asked for, its peak memory or the out-of-memory
error where it does not fit.

    python3 scripts/torch_train_fit.py [--arch falcon-mamba-7b] [--layers 24 28 32]
    python3 scripts/torch_train_fit.py --arch stablelm-12b --layers 10 12 14

Runs on a machine with one CUDA card, from the root of a checkout.  The
plan is ``chip_smoke.py``'s for the arch (``TRAIN_CUTS``: 1 x 4096, remat
full, int8 moments; falcon-mamba-7b scan_chunk 128, stablelm-12b tile
(128, 256)); each depth runs the phase's three steps with its exact launch
counts and checks.  Prints one JSON line per
depth (the phase's own ``train`` line first where it fits), then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b", help="an arch of chip_smoke.TRAIN_CUTS")
    ap.add_argument("--layers", type=int, nargs="+", default=[24, 28, 32])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_fit: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    name, _, limit = cs.nvidia_smi().partition(",")
    cs.CARD.update(card=name.strip(), power_limit=limit.strip())
    mods = cs.make_mods()
    plan = mods.SchedulePlan(**cs.TRAIN_CUTS[args.arch][0])
    for layers in args.layers:
        try:
            cs.phase_train(torch, f"fit {layers}", plan, mods, args.arch, 1, layers)
            row = {"layers": layers, "fits": True}
        except torch.cuda.OutOfMemoryError as e:
            row = {"layers": layers, "fits": False, "error": str(e).splitlines()[0]}
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"arch": args.arch, **row, **cs.CARD}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
