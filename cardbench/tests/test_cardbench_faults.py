"""``correct`` comes out false with the timed path broken underneath, and with
the reference at float8 put in the program's place (the control), on the
tiny cells: the harness's run with the look for a card skipped."""
import pytest
import torch

from cardbench.tests import tiny
from cardbench.tools import readings

import cardbench.run as R


def _run(tmp_path, name):
    return R.execute(tiny.run(tiny.cell(tmp_path, name)))


def test_cardbench_train_state_left_unchanged(tmp_path, monkeypatch):
    from repro_torch.training import optimizer

    def unchanged(params, grads, state, oc, dist=None):
        return params, state, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}

    monkeypatch.setattr(optimizer, "apply_updates", unchanged)
    out = _run(tmp_path, tiny.TRAIN)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_cardbench_train_half_the_batch(tmp_path):
    with readings.half_batch():
        out = _run(tmp_path, tiny.TRAIN)
    assert not out["correct"], out["checks"]


def _decode_fault(monkeypatch, change):
    from repro_torch.models import transformer

    whole = transformer.decode_step

    def broken(params, cfg, cache, inputs, cur, commit=None, **kw):
        logits, cache = whole(params, cfg, cache, inputs, cur, commit, **kw)
        return change(logits), cache

    monkeypatch.setattr(transformer, "decode_step", broken)


def test_cardbench_decode_token_altered(tmp_path, monkeypatch):
    def shift_first_row(logits):
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits

    _decode_fault(monkeypatch, shift_first_row)
    out = _run(tmp_path, tiny.DECODE)
    assert not out["correct"]
    assert out["checks"]["token_gap_p99"]["value"] > out["checks"]["token_gap_p99"]["limit"]


def test_cardbench_decode_half_the_slots_left_out(tmp_path, monkeypatch):
    def half(logits):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits

    _decode_fault(monkeypatch, half)
    assert not _run(tmp_path, tiny.DECODE)["correct"]


def test_cardbench_decode_cache_left_unwritten(tmp_path, monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_write_at_cur_", lambda *a, **k: None)
    out = _run(tmp_path, tiny.DECODE)
    assert not out["correct"]
    assert out["checks"]["kv_first_layer_err"]["value"] == pytest.approx(1.0)


def test_cardbench_train_control_float8(tmp_path):
    cell = tiny.cell(tmp_path, tiny.TRAIN)
    run = readings.new_run(cell, 5, 0.1, "cpu")
    kind = cell.kind()
    from repro_torch.models import transformer

    meta = transformer.meta_params(run.cfg)
    ref = kind.reference_numbers(run, meta, "float32")
    ctl = kind.compare(kind.reference_numbers(run, meta, "float8"), ref)
    assert any(ctl[k] > cell.limits[k] for k in ctl), ctl


def test_cardbench_decode_control_float8(tmp_path):
    cell = tiny.cell(tmp_path, tiny.DECODE)
    run = readings.new_run(cell, 5, 0.1, "cpu")
    kind = cell.kind()
    st = kind.setup(run)
    kind.window(st, run)
    kind.finish(st, run)
    logits, rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float32")
    ctl_logits, ctl_rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float8")
    served = torch.cat([st.served[:, :1], ctl_logits.argmax(-1)], dim=1)
    ctl = kind.compare(logits, rows, served, ctl_rows)
    assert any(ctl[k] > cell.limits[k] for k in ctl), ctl


def test_cardbench_train_second_moment_unwritten(tmp_path):
    """Step 1's update does not read the stored second moment, so only
    ``nu_gap`` sees it left unstored."""
    with readings.nu_unwritten():
        out = _run(tmp_path, tiny.TRAIN)
    assert not out["correct"]
    assert out["checks"]["nu_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] <= out["checks"]["change_gap"]["limit"]
