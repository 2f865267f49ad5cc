"""Serving CLI: batched decode with the continuous-batching engine.

    python -m repro_torch.launch.serve --arch ARCH [--smoke] [--device cpu]

ARCH is any arch the port registers (``repro_torch.configs.ARCH_IDS`` and
``PORT_ARCH_IDS``): granite-3-2b, granite-moe-1b-a400m, falcon-mamba-7b,
nemotron-4-15b and stablelm-12b fit one H100 at full width; deepseek-67b,
jamba-1.5-large-398b, phi3.5-moe-42b-a6.6b and jamba2-mini (whose 32 layers
fit at 16, one stage of a two-card pipeline) only with ``--smoke`` (the
reduced config).  The
engine drives token-input archs: for musicgen-large and qwen2-vl-72b (a stub
frontend's embeddings in) it says so and returns 0, as the JAX package's CLI
does.  Runs on the CUDA device unless ``--device cpu`` is given; weights are
random, drawn on the device from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced() config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.input_kind != "tokens":
        print(f"[serve] {args.arch} uses a stub modality frontend; serving "
              "demo drives token-input archs — pick granite/deepseek/etc.")
        return 0
    params = transformer.init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, params, batch_slots=args.slots, max_len=64, device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(1, 6))
        eng.submit(rng.integers(0, cfg.vocab_size, plen), max_new_tokens=args.max_new)
    done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"[serve] req {r.uid}: prompt {r.prompt.tolist()} -> {r.generated}")
    print(f"[serve] completed {len(done)}/{args.requests} requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
