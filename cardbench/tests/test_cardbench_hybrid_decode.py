"""The hybrid decode kind (``kinds/hybrid_decode.py``) and its reader
(``metrics/mamba_host_ms.hybrid_decode.py``) on the CPU: a tiny Jamba cell
(the program's ``reduced()`` jamba2-mini in float32) beside ``tiny.py``'s,
its histories and drawn states, ``compare`` and the SSM-state error, the
float8 control refused, and the reader on synthetic spans."""
import json

import pytest
import torch

from cardbench import bench, trace
from cardbench.tests import tiny
from repro_torch.runtime import tracing
from repro_torch.runtime.tracing import Span

import cardbench.run as R

HYBRID = "tiny-hybrid.decode"
SIZES = {"d_model": 64, "n_layers": 8, "vocab_size": 256,
         "period": [["mamba", "dense"], ["mamba", "moe"], ["mamba", "dense"], ["mamba", "moe"],
                    ["attn", "dense"], ["mamba", "moe"], ["mamba", "dense"], ["mamba", "moe"]],
         "norm_eps": 1e-06, "tie_embeddings": False, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "n_experts": 4, "experts_per_token": 2, "capacity_factor": 1.25,
         "capacity_block": 128, "ssm_state": 8, "dt_rank": 8, "conv_width": 4}
TRAFFIC = {"kind": "hybrid_decode", "slots": 4, "max_len": 64, "history_lengths": [16, 40],
           "history_std": 3.0, "conv_std": 1.28, "ssm_std": 0.008, "warmup_steps": 2, "most_steps": 6,
           "tune": {"algo": "mcts_1s", "shape": "long_500k", "hw": "h100", "mesh": "card", "seed": 0}}
LIMITS = {"token_gap_p99": 1e-3, "kv_median_err": 1e-3, "ssm_state_err": 1e-3, "ssm_first_layer_err": 1e-3}


def make(root, limits=None):
    """``tiny.make``'s benchmark and a tiny hybrid cell beside its cells."""
    path = tiny.make(root)
    init = bench.load_json(bench.HERE / "configs" / "jamba2-mini.json")["init"]
    (root / "configs" / "tiny-hybrid.json").write_text(json.dumps(
        {"arch": "jamba2-mini", "variant": "reduced", "sizes": SIZES, "dtype": "float32", "reduced": [],
         "hybrid": {"d_inner": 128, "mamba_inner_norms": True, "moe_renormalize": False}, "init": init}))
    (root / "traffic" / "decode-tiny-hybrid.json").write_text(json.dumps(TRAFFIC))
    (root / "limits" / f"{HYBRID}.json").write_text(json.dumps({**LIMITS, **(limits or {})}))
    b = json.loads(path.read_text())
    b["configs"].append({"name": "tiny-hybrid", "source": "test", "file": "configs/tiny-hybrid.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": HYBRID, "config": "tiny-hybrid", "traffic": "decode-tiny-hybrid",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if tiny.DECODE in m.get("workloads", []):
            m["workloads"].append(HYBRID)
    b["per_layer"].append({"name": "mamba_host_ms.hybrid_decode", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "serve step", "moves": "decode_tokens_per_s",
                           "workloads": [HYBRID]})
    path.write_text(json.dumps(b))
    return bench.find_cell(HYBRID, path, root)


def _setup(cell):
    run = tiny.run(cell, seconds=600)
    run.cfg = R.port_config(cell)
    R.tune(run)
    return run, cell.kind()


def test_cardbench_hybrid_cell_runs_correct_on_the_cpu(tmp_path):
    out = R.execute(tiny.run(make(tmp_path), seconds=600))
    assert out["correct"] and out["attempted"] == TRAFFIC["most_steps"]
    assert set(out["checks"]) == set(LIMITS)
    assert out["checks"]["ssm_state_err"]["value"] < 1e-5  # float32 both sides, other orders of sums
    assert set(out["metrics"]) == {"setup_s", "decode_tokens_per_s", "decode_step_p95_ms"}


def test_cardbench_hybrid_draws_repeat_a_slot_at_a_time(tmp_path):
    run, kind = _setup(make(tmp_path))
    a = kind.slot_history(run, "b4", 0, "k", 2, 30, "cpu")
    b = kind.slot_history(run, "b4", 0, "k", 2, 30, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 30, 16) and a[0].dtype == torch.int8 and a[1].shape == (2, 30, 1)
    other = kind.slot_history(run, "b4", 0, "k", 3, 30, "cpu")
    assert not torch.equal(a[0], other[0])
    conv, ssm = kind.mamba_state(run, "b1", 0, "cpu")
    assert conv.shape == (4, 3, 128) and ssm.shape == (4, 128, 8) and ssm.dtype == torch.float32
    assert torch.equal(ssm, kind.mamba_state(run, "b1", 0, "cpu")[1])
    assert abs(float(conv.std()) - TRAFFIC["conv_std"]) < 0.1
    assert abs(float(ssm.std()) - TRAFFIC["ssm_std"]) < 1e-3
    assert [b for b, _ in kind.mamba_layers(run.cfg)] == ["b0", "b1", "b2", "b3", "b5", "b6", "b7"]


def test_cardbench_hybrid_setup_writes_the_drawn_state(tmp_path):
    run, kind = _setup(make(tmp_path))
    st = kind.setup(run)
    conv, ssm = kind.mamba_state(run, "b2", 0, "cpu")
    c = st.cache["b2"]
    # the warm-up steps moved the state on from the drawn one
    assert not torch.equal(c["ssm"][0], ssm) and not torch.equal(c["conv"][0], conv)
    assert torch.equal(c["conv"][0][:, :1], conv[:, len(st.served) - 1:len(st.served)])
    for b, h in enumerate(st.hist):
        codes, scales = kind.slot_history(run, "b4", 0, "v", b, h, "cpu")
        assert torch.equal(st.cache["b4"]["v"][0, b, :, :h], codes)
        assert torch.equal(st.cache["b4"]["v_s"][0, b, :, :h], scales)


def test_cardbench_hybrid_compare_and_the_float8_control(tmp_path):
    run, kind = _setup(make(tmp_path))
    st = kind.setup(run)
    kind.window(st, run)
    kind.finish(st, run)
    logits, rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float32")
    assert {k[2] for k in rows} == {"k", "v", "ssm"} and set(rows) == set(st.written)
    got = kind.compare(logits, rows, st.served, st.written)
    assert set(got) == set(LIMITS) and all(v <= LIMITS[k] for k, v in got.items())
    # the SSM error is the worst Mamba layer's relative error over every slot
    key = next(k for k in rows if k[2] == "ssm")
    bad = dict(st.written)
    bad[key] = rows[key] * 1.1
    assert kind.compare(logits, rows, st.served, bad)["ssm_state_err"] == pytest.approx(0.1, rel=1e-4)
    # the first Mamba layer's widest row: one slot's state left as drawn, or
    # one channel off, moves it whole where the Frobenius error is diluted
    first = ("b0", 0, "ssm")
    assert next(k for k in rows if k[2] == "ssm") == first
    drawn = kind.mamba_state(run, "b0", 0, "cpu")[1]
    bad_channel = st.written[first].clone()
    bad_channel[2, 5] *= 1.5
    got = kind.compare(logits, rows, st.served, {**st.written, first: bad_channel})
    assert got["ssm_first_layer_err"] == pytest.approx(0.5, rel=1e-3) and got["ssm_state_err"] < 0.05
    unwritten = kind.compare(logits, rows, st.served,
                             {**st.written, first: torch.cat([drawn[:1], st.written[first][1:]])})
    assert unwritten["ssm_first_layer_err"] > 0.5
    # the float8 control in the program's place: the states and rows it
    # leaves fail limits set near float32's readings (at this size its
    # tokens hardly move: the tiny model's logits lie close together)
    ctl_logits, ctl_rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float8")
    served = torch.cat([st.served[:, :1], ctl_logits.argmax(dim=-1).cpu()], dim=1)
    ctl = kind.compare(logits, rows, served, ctl_rows)
    assert all(ctl[k] > LIMITS[k] for k in ("kv_median_err", "ssm_state_err", "ssm_first_layer_err")), ctl


def test_cardbench_hybrid_refuses_a_program_without_the_fields(tmp_path):
    cell = make(tmp_path)
    cell.config["hybrid"]["moe_renormalize"] = True
    run, kind = _setup(cell)
    with pytest.raises(ValueError, match="moe_renormalize"):
        kind.setup(run)


def test_cardbench_hybrid_step_work_adds_the_mamba_state(tmp_path):
    from cardbench import work as W

    run, kind = _setup(make(tmp_path))
    base = W.decode_work(kind.sizes(run), [20, 30, 40, 50], "int8", "float32")
    got = kind.step_work(run, [20, 30, 40, 50])
    state = 2 * 4 * (3 * 128 * 4 + 128 * 8 * 4) + (8 + 2 * 8) * 4  # a layer: window, state, norms
    assert got.flops == base.flops and got.bytes == base.bytes + 7 * state


def _read(run):
    return bench.load_module(bench.HERE / "metrics" / "mamba_host_ms.hybrid_decode.py").read(run)


def test_cardbench_mamba_host_ms_reader(monkeypatch, tmp_path):
    run = tiny.run(make(tmp_path), traced=True)
    run.trace = trace.Summary(window_s=1.0, busy_s=0.5, device_ops={"k": 0.5}, idle_gaps=[],
                              n_device_events=1)
    spans = []
    for step in range(2):  # a step of 10 ms holding two layers' mamba spans of 1 + 2 ms
        t = step * 20_000_000
        spans.append(Span(tracing.ROOT, t, t + 10_000_000, None, step))
        for j, name in enumerate(("mamba.project", "mamba.ssm")):
            spans.append(Span(name, t + j * 3_000_000, t + j * 3_000_000 + (j + 1) * 1_000_000, 0, step))
    spans.append(Span("mamba.ssm", 90_000_000, 99_000_000, None, None))  # a forward's: no step
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    assert _read(run) == pytest.approx(3.0)
    monkeypatch.setattr(tracing, "spans", lambda: [s for s in spans if not s.name.startswith("mamba.")])
    assert _read(run) is None  # a program without the spans: nothing, no error
    run.trace = None
    assert _read(run) is None
