#!/usr/bin/env python3
"""Decode-step time of two source trees of the port, in turns, on the card.

    python3 scripts/torch_decode_ab.py A_ROOT B_ROOT [--rounds 3] [--arch ARCH ...]

Each root is a checkout (or an unpacked ``git archive``) that holds
``src/``; each builds its own kernels under its ``build/`` first.  Round
``i`` runs A then B when ``i`` is even, B then A when it is odd, each in a
fresh process: full-width weights from seed 0, a ``ServingEngine`` of 4
slots and ``max_len`` 128 (as ``chip_smoke.py``'s ``serve``), six requests
run through it, then 40 decode steps of all slots, of which the median of
the last 30 is kept (host clock up to ``torch.cuda.synchronize()``).
Decode at 4 slots is bound by the host's launches, so this compares the
host work two trees do a step.  Prints one JSON line a run, then one line
with each tree's medians by arch and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import transformer
from repro_torch.serving.engine import ServingEngine

_build.build({libs!r})
out = {{}}
for arch in {archs!r}:
    cfg = get_config(arch)
    params = transformer.init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(0, cfg.vocab_size, 8), max_new_tokens=4)
    eng.run()
    mask = np.ones((eng.slots,), bool)
    times = []
    for _ in range(40):
        t0 = time.perf_counter()
        eng._decode(mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out[arch] = statistics.median(times[10:]) * 1e3
    del eng, params
    torch.cuda.empty_cache()
print(json.dumps(out))
"""
LIBRARIES = ["rmsnorm", "flash_attention", "flash_attention_backward", "moe_gemm",
             "selective_scan", "quantize"]


def run(root: Path, archs) -> dict:
    code = CHILD.format(src=str(root / "src"), libs=LIBRARIES, archs=list(archs))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--arch", action="append",
                    default=None, help="an arch to serve (repeatable)")
    args = ap.parse_args()
    archs = args.arch or ["nemotron-4-15b", "granite-3-2b", "granite-moe-1b-a400m"]
    roots = {"a": args.a.resolve(), "b": args.b.resolve()}
    got = {"a": {k: [] for k in archs}, "b": {k: [] for k in archs}}
    for i in range(args.rounds):
        for side in ("a", "b") if i % 2 == 0 else ("b", "a"):
            ms = run(roots[side], archs)
            print(json.dumps({"round": i, "tree": side, "root": str(roots[side]),
                              "median_decode_step_ms": ms}), flush=True)
            for k, v in ms.items():
                got[side][k].append(v)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"summary": {side: {k: {"runs": v, "median": statistics.median(v)}
                                         for k, v in got[side].items()} for side in got},
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
