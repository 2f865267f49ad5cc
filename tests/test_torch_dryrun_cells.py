"""The production-mesh dry run at full size (the fourth part of
``tests/test_torch_dryrun.py``, apart so that a parallel run takes it beside
that file): deepseek-67b's training on the H100 node (1 x 8) at all 95
layers, and granite-3-2b's on the TPU pod (16 x 16), finish with every
field of the record.
"""
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun_impl

torch.set_num_threads(1)

RECORD_FIELDS = {
    "compute_s", "memory_s", "collective_s", "step_s", "dominant", "flops_per_device",
    "dot_flops_per_device", "aten_flops_per_device", "kernel_flops_per_device", "flops_total",
    "hbm_bytes_total", "coll_bytes_per_chip", "coll_wire_bytes_per_chip", "coll_by_kind",
    "coll_counts", "memory", "bytes_per_device", "fits_hbm", "launches", "model_flops",
    "useful_flops_ratio", "mfu", "chips", "rank", "hw", "source", "dryrun_s",
}
MEMORY_FIELDS = {"params_bytes", "opt_state_bytes", "cache_bytes", "batch_bytes", "resident_bytes",
                 "peak_bytes"}


@pytest.mark.parametrize("arch,shape,hw,chips", [
    ("deepseek-67b", "train_4k", "h100", 8),
    ("granite-3-2b", "train_4k", "tpu-v5e", 256),
], ids=["deepseek-67b-h100", "granite-3-2b-tpu-v5e"])
def test_full_size_cells_finish_with_every_field(arch, shape, hw, chips):
    rec = dryrun_impl.evaluate_cell(arch, shape, "single", hw=hw, verbose=False)
    assert RECORD_FIELDS | {"arch", "shape", "mesh", "plan"} == set(rec)
    assert set(rec["memory"]) == MEMORY_FIELDS and rec["chips"] == chips
    assert rec["source"] == "dryrun" and rec["step_s"] > 0 and 0 < rec["mfu"] < 1
    assert rec["flops_per_device"] > rec["aten_flops_per_device"] > 0
    assert rec["bytes_per_device"] == rec["memory"]["peak_bytes"] > rec["memory"]["resident_bytes"]
    assert rec["fits_hbm"] == (rec["bytes_per_device"] <= dryrun_impl.get_hardware(hw).hbm_bytes)
    n_attn = get_config(arch).n_layers
    microbatches = rec["plan"]["microbatches"]
    # every layer's flash forward twice (the step and remat's recompute) and
    # its backward once, in each microbatch
    assert rec["launches"]["flash_attention"] == 2 * n_attn * microbatches
    assert rec["launches"]["flash_attention_backward"] == n_attn * microbatches
    json.dumps(rec)


