#!/usr/bin/env python3
"""Find the op where the port's f32 card path first departs from its CPU path.

    python3 scripts/torch_parity_probe.py [--arch granite-3-2b] [--with-train]

On a machine with one CUDA card, from the root of a checkout.  It builds the
kernels, then:

1. logs the float32 precision settings (``allow_tf32`` of matmul and cuDNN,
   ``get_float32_matmul_precision()``);
2. runs ``chip_smoke.phase_parity`` for the arch: the 2-layer f32 model at
   full width, card against CPU;
3. per op: runs the same model on the CPU recording every norm, attention
   block, flash call, MLP and the logits with their inputs, replays each op
   on the card from the CPU's inputs, and prints the op's own error (the
   error it adds, not what it inherits) and the error carried into it;
4. holds the f32 flash kernel at the parity shape against ``ref.attention``
   in float64;
5. with ``--with-train``, runs ``chip_smoke``'s two train phases and
   repeats 1-4.

Prints one JSON line per step and exits non-zero only if a step raised.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _settings(torch) -> dict:
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def _err(torch, got, exp) -> dict:
    got, exp = got.detach().double().cpu(), exp.detach().double().cpu()
    d = (got - exp).abs()
    return {"max_abs": d.max().item(), "exp_abs_max": exp.abs().max().item(),
            "rel_norm": ((got - exp).norm() / exp.norm().clamp_min(1e-300)).item()}


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device) if hasattr(x, "to") else x


def per_op(torch, np, arch: str, mods) -> list:
    """Every recorded op's own card-vs-CPU error from the CPU's inputs."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, layers, transformer

    cfg = dataclasses.replace(mods.get_config(arch), n_layers=2, dtype="float32")
    tiles = mods.tiles_from_plan(mods.SchedulePlan())
    params = transformer.init_params(cfg, 0, device="cpu")
    S = 320
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S)))
    records = []

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            records.append((name, fn, args, kwargs, out))
            return out
        return wrapped

    patches = [(layers, "norm"), (attention, "forward"), (ops, "attention"),
               (transformer, "_mlp_forward"), (transformer, "_logits")]
    saved = [(m, n, getattr(m, n)) for m, n in patches]
    try:
        for m, n, fn in saved:
            setattr(m, n, recording(f"{m.__name__.rsplit('.', 1)[-1]}.{n}", fn))
        pos = mods.make_positions(cfg, 1, S, device="cpu")
        transformer.forward(params, cfg, tokens, pos, tiles=tiles)
        cpu_calls = list(records)
        records.clear()
        transformer.forward(_to(params, "cuda"), cfg, tokens.cuda(),
                            mods.make_positions(cfg, 1, S, device="cuda"), tiles=tiles)
        cuda_calls = list(records)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    rows = []
    for i, ((name, fn, args, kwargs, out), (_, _, gargs, _, gout)) in enumerate(zip(cpu_calls, cuda_calls)):
        replay = fn(*[_to(a, "cuda") for a in args], **_to(kwargs, "cuda"))  # the op alone
        torch.cuda.synchronize()
        inherited = [_err(torch, g, c)["max_abs"] for g, c in zip(gargs, args) if hasattr(c, "shape")]
        rows.append({"i": i, "op": name, "own": _err(torch, replay, out),
                     "carried": _err(torch, gout, out), "input_max_abs": max(inherited, default=0.0)})
    return rows


def flash_f64(torch, fa, ref) -> list:
    """The f32 flash kernel at the parity shapes against ref.attention in float64."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, Hq, Hkv, S, D, bq, bkv in ((1, 32, 8, 320, 64, 256, 256), (1, 16, 8, 320, 64, 256, 256)):
        q = torch.randn((B, Hq, S, D), generator=gen, device="cuda")
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
        v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
        got = fa.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv)
        exp = ref.attention(q.double().cpu(), k.double().cpu(), v.double().cpu(), causal=True)
        plain = ref.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        rows.append({"shape": [B, Hq, Hkv, S, S, D], "tile": [bq, bkv],
                     "kernel_vs_f64": _err(torch, got, exp), "plain_f32_card_vs_f64": _err(torch, plain, exp)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--with-train", action="store_true")
    args = ap.parse_args()
    import types

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_parity_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.space import SchedulePlan
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe, transformer
    from repro_torch.models.losses import cross_entropy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import optimizer as optim
    from repro_torch.training.train_step import make_positions, make_prefill_step, tiles_from_plan
    from repro_torch.training.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py sets them
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    name, _, limit = smi.partition(",")
    chip_smoke.CARD.update(card=name.strip(), power_limit=limit.strip())
    _build.build(chip_smoke.LIBRARIES)
    mods = types.SimpleNamespace(
        get_config=get_config, ops=ops, transformer=transformer, ServingEngine=ServingEngine,
        make_prefill_step=make_prefill_step, make_positions=make_positions,
        tiles_from_plan=tiles_from_plan, moe=moe, optim=optim, cross_entropy=cross_entropy,
        InputShape=InputShape, Trainer=Trainer, TrainerConfig=TrainerConfig,
        SchedulePlan=SchedulePlan,
    )

    def probe(when: str) -> None:
        chip_smoke.emit("probe.settings", when=when, **_settings(torch))
        chip_smoke.phase_parity(torch, np, get_config(args.arch), SchedulePlan(), ops, transformer,
                                moe, make_positions, tiles_from_plan)
        chip_smoke.emit("probe.per_op", when=when, arch=args.arch, ops=per_op(torch, np, args.arch, mods))
        chip_smoke.emit("probe.flash_f64", when=when, cases=flash_f64(torch, fa, ref))

    probe("alone")
    if args.with_train:
        for plan_name, plan in (("a", SchedulePlan(remat="full", microbatches=2, opt_dtype="int8",
                                                   grad_comm="int8")),
                                ("b", SchedulePlan(remat="dots", microbatches=2))):
            chip_smoke.phase_train(torch, plan_name, plan, mods)
        probe("after the train phases")
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
