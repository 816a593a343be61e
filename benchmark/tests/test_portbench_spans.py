"""The readers of the program's own spans (``benchmark/spans.py``): each
``program_span`` metric has its reader file and lists existing cells; at
the small sizes on the CPU a traced run gives a finite value and an
untraced one, or a program without the span log, ``None``; the counts
they divide by, by hand."""
from __future__ import annotations

import importlib
import math
import types

import pytest

from portbench_small import CELLS, SPEC, run_small

from benchmark import harness, spans

NEW = [m for m in SPEC["per_layer"] if m["source"] == "program_span"]


def _cell(metric):
    (cell,) = metric["workloads"]
    return cell


@pytest.mark.parametrize("metric", NEW, ids=[m["name"] for m in NEW])
def test_entry_has_a_reader_and_existing_cells(metric):
    assert callable(harness.load_reader(metric["name"]).read)
    assert set(metric["workloads"]) <= set(CELLS)
    for cell in metric["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
        assert metric["moves"] in e2e


@pytest.fixture(scope="module")
def runs():
    """``{(cell, trace): run}`` of one small run each. The training cell
    takes the per-chunk gradient route it takes at its own size (a bucket
    of nmax 4096 and more), which the small tree does not reach."""
    trainlib = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    mp = pytest.MonkeyPatch()
    mp.setattr(trainlib, "_per_bucket", lambda model: True)
    try:
        out = {}
        for cell in sorted({_cell(m) for m in NEW}):
            for trace in (1, 0):
                result, _, run = run_small(cell, trace=trace)
                assert result["correct"] is True
                out[cell, trace] = run
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("metric", NEW, ids=[m["name"] for m in NEW])
def test_traced_run_reads_and_untraced_run_does_not(metric, runs, monkeypatch):
    reader = harness.load_reader(metric["name"])
    traced, untraced = runs[_cell(metric), 1], runs[_cell(metric), 0]
    value = reader.read(traced)
    assert value is not None and math.isfinite(value) and value > 0
    if metric["unit"] == "%":
        assert value <= 100
    assert reader.read(untraced) is None
    from deepstructuredmixtures_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")  # a program without the log
    assert reader.read(traced) is None


def _rec(name, t0, host_ms, device_ms=None, **attrs):
    return {"name": name, "host_t0_ns": t0, "host_ms": host_ms,
            "device_ms": device_ms, "attrs": attrs}


def test_counts_by_hand(monkeypatch):
    from deepstructuredmixtures_tpu_torch.utils import profiling

    log = [_rec("streamed_predict", 10, 9.0), _rec("factor", 11, 5.0, 4.0, padded_flops=9.0),
           _rec("factor", 12, 5.0, 2.0, padded_flops=9.0), _rec("gram", 13, 1.0),
           _rec("streamed_predict", 20, 9.0), _rec("factor", 21, 5.0, 3.0, padded_flops=9.0),
           _rec("factor", 5, 5.0, 100.0, padded_flops=100.0)]  # before the run
    monkeypatch.setattr(profiling, "records", lambda: log)
    run = types.SimpleNamespace(t0=10e-9, work={"leaf_n": [2, 2]})
    assert spans.per_unit(run, "factor", "streamed_predict") == pytest.approx(4.5)
    assert spans.per_unit(run, "gram", "streamed_predict") == pytest.approx(0.5)
    share = harness.load_reader("chol_useful_share.pass").read(run)
    assert share == pytest.approx(100 * (16 / 3) / 13.5)
    assert spans.host_median(run, "factor") == 5.0
    assert spans.per_unit(run, "solve", "streamed_predict") is None
