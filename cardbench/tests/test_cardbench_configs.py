"""Each configuration file's sizes against the program's ``get_config``, and
the published keys it names against its sizes."""
import dataclasses

import pytest

from cardbench import bench
from cardbench.reference.model import Model

import cardbench.run as R

CONFIGS = sorted(p.stem for p in (bench.HERE / "configs").glob("*.json"))  # with a cell or not yet
PUBLISHED = {  # the configuration file's size -> the published config.json's key
    "d_model": "hidden_size", "n_layers": "num_hidden_layers", "vocab_size": "vocab_size",
    "tie_embeddings": "tie_word_embeddings", "n_heads": "num_attention_heads",
    "n_kv_heads": "num_key_value_heads", "rope_theta": "rope_theta", "n_experts": "num_local_experts",
    "experts_per_token": "num_experts_per_tok", "ssm_state": "state_size",
    "conv_width": "conv_kernel", "dt_rank": "time_step_rank",
}


def _cell(name):
    return bench.Cell(name=name, chips=1, config=bench.load_json(bench.HERE / "configs" / f"{name}.json"),
                      traffic={}, limits={}, end_to_end=[], per_layer=[], root=bench.HERE)


@pytest.mark.parametrize("name", CONFIGS)
def test_cardbench_config_matches_the_program(name):
    cell = _cell(name)
    cfg = R.port_config(cell)
    assert cfg.name == name and cfg.n_layers == cell.config["sizes"]["n_layers"]
    Model.from_file(cell.config)  # every size is one the reference reads


@pytest.mark.parametrize("name", CONFIGS)
def test_cardbench_config_against_published_keys(name):
    cfg = bench.load_json(bench.REPO / f"cardbench/configs/{name}.json")
    sizes, pub = cfg["sizes"], cfg["published"]
    for size, key in PUBLISHED.items():
        if size in sizes and key in pub and key not in cfg["reduced"]:
            assert sizes[size] == pub[key], (size, key)
    width = "d_inner" if "d_inner" in sizes and sizes["d_inner"] else "d_ff"
    assert sizes[width] == pub["intermediate_size"]
    assert cfg["dtype"] == pub["torch_dtype"]
    assert set(cfg["reduced"]) <= set(R.CUTS)  # depth alone: no width is cut


@pytest.mark.parametrize("name", CONFIGS)
def test_cardbench_config_mismatch_is_refused(name, monkeypatch):
    cell = _cell(name)
    bad = dataclasses.replace(cell, config={**cell.config,
                                            "sizes": {**cell.config["sizes"], "d_model": 7}})
    with pytest.raises(ValueError, match="d_model"):
        R.port_config(bad)
