#!/usr/bin/env python3
"""Whether two source trees of the port compute the same one-device steps,
bit for bit, on the CPU.

    python3 scripts/torch_tree_equal.py A_ROOT B_ROOT

Each root is a checkout (or an unpacked ``git archive``) that holds
``src/``.  In a fresh process per tree, each case below (``reduced()``
configs, seeded weights and batch) takes two train steps, then a prefill of
the batch and three decode steps of the serve step; the losses, learning
rates and grad norms, the updated weights and moments, the logits and the
decoded logits of the two trees are compared with ``torch.equal`` (dtype
and shape too).  Prints one JSON line a case and exits 1 if any differs.
"""
from __future__ import annotations

import json
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

# (arch, plan fields, model dtype): microbatches, remat, int8 moments and
# grad_comm, an EP plan (which one device runs dense), embeddings input
CASES = [
    ("granite-moe-1b-a400m", dict(microbatches=1), "float32"),
    ("granite-moe-1b-a400m", dict(microbatches=2, grad_comm="int8", opt_dtype="int8",
                                  moe_mode="ep", param_strategy="tp"), "float32"),
    ("falcon-mamba-7b", dict(microbatches=2, remat="dots"), "float32"),
    ("granite-3-2b", dict(microbatches=1, grad_comm="int8", opt_dtype="int8"), "bfloat16"),
    ("jamba-1.5-large-398b", dict(microbatches=1, remat="full"), "float32"),
    ("musicgen-large", dict(microbatches=1), "float32"),
    ("qwen2-vl-72b", dict(microbatches=1), "float32"),
]

CHILD = r"""
import dataclasses, pickle, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(2)
from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.models import transformer
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import (
    make_positions, make_prefill_step, make_serve_step, make_train_step)

out = []
for arch, fields, dtype in {cases!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    plan = SchedulePlan(**fields)
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, moment_dtype=plan.opt_dtype)
    params = transformer.init_params(cfg, 3, device="cpu")
    opt = optim.init_opt_state(params, oc)
    B, S = 4, 16
    g = torch.Generator().manual_seed(1)
    if cfg.input_kind == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    else:
        inputs = torch.randn(B, S, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {{"inputs": inputs, "labels": labels,
              "positions": make_positions(cfg, B, S, device="cpu")}}
    step = make_train_step(cfg, None, plan, oc, device="cpu")
    metrics = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        metrics.append({{k: v.clone() for k, v in m.items()}})
    logits = make_prefill_step(cfg, None, plan, device="cpu")(params, batch)
    serve = make_serve_step(cfg, None, plan, device="cpu")
    cache = transformer.init_cache(cfg, B, 8, device="cpu")
    decoded = []
    with torch.no_grad():
        for t in range(3):
            lg, cache = serve(params, cache, inputs[:, t:t + 1], t)
            decoded.append(lg.clone())
        # continuous batching: an int8 cache, per-row positions, a row left out
        cache8 = transformer.init_cache(cfg, B, 8, kv_dtype="int8", device="cpu")
        commit = torch.tensor([True, False, True, True])
        for t in range(3):
            cur = torch.tensor([t, t + 1, t, t + 2])
            lg, cache8 = serve(params, cache8, inputs[:, t:t + 1], cur, commit)
            decoded.append(lg.clone())
    out.append({{"metrics": metrics,
                 "params": {{k: v.detach().clone() for k, v in optim.leaves(params)}},
                 "opt": opt, "logits": logits, "decoded": decoded, "caches": [cache, cache8]}})
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _run(root: Path, path: str) -> list:
    code = CHILD.format(src=str(root / "src"), cases=CASES, path=path)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


def _differences(a, b, path: str = "") -> list:
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys differ"]
        return [d for k in a for d in _differences(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        return [d for i, (u, v) in enumerate(zip(a, b)) for d in _differences(u, v, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    return [] if a == b else [path]


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(p).resolve() for p in sys.argv[1:]]
    with tempfile.TemporaryDirectory() as tmp:
        got = [_run(r, str(Path(tmp) / f"{i}.pkl")) for i, r in enumerate(roots)]
    bad = 0
    for case, a, b in zip(CASES, *got):
        diff = _differences(a, b)
        bad += bool(diff)
        print(json.dumps({"arch": case[0], "plan": case[1], "dtype": case[2],
                          "bit_equal": not diff, "differing": diff[:10]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
