"""falcon-mamba-7b and stablelm-12b train at full depth on one H100: the dry
run's count of the jobs ``chip_smoke.py`` trains on the card.

Each job (1 x 4096 tokens, ``chip_smoke.TRAIN_PLANS``: remat full, int8
moments) is dry-run on the meta device at the arch's full depth (64 and 40
layers) for mesh ``card`` (``launch/dryrun_impl.dry_run(..., local=True)``,
whose peak was 0.66-1.51 % below the card's ``max_memory_allocated`` in its
card check).  Its peak must leave the card's 79.18 GiB a margin (at most
76 GiB), and the optimizer step must add at most 2 GiB over the live bytes
it starts from (chunks of at most ``optimizer.CHUNK_ELEMS`` elements, where
a whole-leaf update of the stacked ``in_proj`` or ``w_up`` made f32
temporaries of 8 and 21 GiB).  The quantize launches are two a chunk of each
quantizable leaf.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.space import ONE_CARD, SchedulePlan
from repro_torch.launch import dryrun_impl
from repro_torch.models import transformer
from repro_torch.training import optimizer as optim

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the card's jobs and their plans)

torch.set_num_threads(1)

GiB = 2**30


@pytest.mark.parametrize("arch, layers", [("falcon-mamba-7b", 64), ("stablelm-12b", 40)])
def test_full_depth_train_job_fits_one_card(arch, layers, monkeypatch):
    cfg = get_config(arch)
    assert cfg.n_layers == layers
    trackers, opt = [], {}

    class Tracked(dryrun_impl.LiveBytes):
        def __init__(self):
            super().__init__()
            trackers.append(self)

    real = optim.apply_updates

    def watched(*args, **kwargs):
        """``apply_updates`` with the live bytes it starts from and its own peak."""
        t = trackers[-1]
        opt["entry"], peak_before = t.live, t.peak
        t.peak = t.live
        try:
            return real(*args, **kwargs)
        finally:
            opt["peak"] = t.peak
            t.peak = max(t.peak, peak_before)

    monkeypatch.setattr(dryrun_impl, "LiveBytes", Tracked)
    monkeypatch.setattr(optim, "apply_updates", watched)
    plan = SchedulePlan(**chip_smoke.TRAIN_PLANS[arch])
    rec = dryrun_impl.dry_run(cfg, InputShape("train_chip", chip_smoke.SEQ, 1, "train"), plan,
                              ONE_CARD, hw="h100", local=True)
    mem = rec["memory"]
    assert len(trackers) == 1 and opt, "the dry run did not reach the optimizer"
    assert mem["peak_bytes"] <= 76 * GiB, mem["peak_bytes"] / GiB
    assert mem["resident_bytes"] < opt["entry"] <= mem["peak_bytes"]
    assert opt["peak"] - opt["entry"] <= 2 * GiB, (opt["peak"] - opt["entry"]) / GiB
    shapes = [s for _, s in optim.leaves(transformer.param_shapes(cfg)) if optim._quantizable(s)]
    n_chunks = sum(len(optim.chunks(s)) for s in shapes)
    assert n_chunks > len(shapes)  # the stacked leaves split
    assert rec["launches"]["quantize_int8"] == rec["launches"]["dequantize_int8"] == 2 * n_chunks
