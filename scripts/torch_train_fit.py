#!/usr/bin/env python3
"""Which depth of a full-width model trains on one card: ``chip_smoke.py``'s
train phase at each depth asked for, its peak memory or the out-of-memory
error where it does not fit, beside the dry run's predicted peak.

    python3 scripts/torch_train_fit.py [--arch falcon-mamba-7b] [--layers 56 64]
    python3 scripts/torch_train_fit.py --arch stablelm-12b --layers 32 40
    python3 scripts/torch_train_fit.py --arch stablelm-12b --layers 40 44 --dry-only

Runs on a machine with one CUDA card, from the root of a checkout; with
``--dry-only`` anywhere (no card: the dry run's peaks alone, counted on the
host, ``launch/dryrun_impl.py``), so that a depth that will not fit is seen
before a card run.  The plan is ``chip_smoke.py``'s for the arch
(``TRAIN_PLANS``: 1 x 4096, remat full, int8 moments; falcon-mamba-7b
scan_chunk 128, stablelm-12b tile (128, 256)); the depth defaults to the
arch's full one.  Each depth runs the phase's three steps with its exact
launch counts and checks.  Prints one JSON line per depth (the phase's own
``train`` line first where it fits), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b", help="an arch of chip_smoke.TRAIN_PLANS")
    ap.add_argument("--layers", type=int, nargs="+", default=None,
                    help="depths to try (default: the arch's full depth)")
    ap.add_argument("--dry-only", action="store_true", help="the dry run's peaks alone, no card")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.py
    import torch

    if not args.dry_only and not torch.cuda.is_available():
        print("torch_train_fit: no CUDA device (--dry-only runs without one)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    mods = cs.make_mods()
    plan = mods.SchedulePlan(**cs.TRAIN_PLANS[args.arch])
    layers_list = args.layers or [mods.get_config(args.arch).n_layers]
    if not args.dry_only:
        name, _, limit = cs.nvidia_smi().partition(",")
        cs.CARD.update(card=name.strip(), power_limit=limit.strip())
    for layers in layers_list:
        dry = cs.dry_train_peaks({"fit": (args.arch, 1, plan.to_dict(), layers)})["fit"]
        row = {"layers": layers, "dry_peak_gib": dry / 2**30}
        if not args.dry_only:
            try:
                cs.phase_train(torch, f"fit {layers}", plan, mods, args.arch, 1, layers, dry)
                row["fits"] = True
            except torch.cuda.OutOfMemoryError as e:
                row.update(fits=False, error=str(e).splitlines()[0])
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({"arch": args.arch, **row, **cs.CARD}), flush=True)
    if not args.dry_only:
        print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
