"""``BENCHMARK.json`` against the benchmark's contract, and every name it
gives found among the benchmark's files; a new cell, traffic mix and
metric taken as files alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench_small import ROOT, SPEC, small

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"][1].startswith("benchmark/")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(SPEC, cell, True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e


def test_every_name_is_found_as_files():
    for c in SPEC["configs"]:
        cfg = json.load(open(f"{ROOT}/{c['file']}"))
        assert cfg["name"] == c["name"]
        harness.load_reference(cfg)
    for w in SPEC["workloads"]:
        tr = harness.load_traffic(w["traffic"])
        assert hasattr(harness.load_driver(tr["kind"]), "run")
        limits = harness.load_limits(w["name"])
        assert limits["numbers"]["partition"]["limit"] == 0
    for m in SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def test_benchmark_files_are_named_from_name_characters():
    import pathlib

    for p in pathlib.Path(ROOT, "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH_CHARS.match(rel), rel


def test_a_new_cell_traffic_and_metric_as_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with one more traffic mix (the
    refined pass), one more reader and one more limits file; the spec gains
    a cell and a metric. The harness takes them with no code edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(f"{ROOT}/benchmark", copy, ignore=shutil.ignore_patterns("__pycache__"))
    tr = json.load(open(copy / "traffic" / "streamed_pass.json"))
    tr["refine_steps"] = 1
    json.dump(tr, open(copy / "traffic" / "refined_pass.json", "w"))
    shutil.copy(copy / "limits" / "d2_n100k_pass.json", copy / "limits" / "d2_refined.json")
    (copy / "metrics" / "route_calls.refined.py").write_text(
        "def read(run):\n    return float(len(run.rec.spans.get('route', [])))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "d2_refined", "config": spec["workloads"][0]["config"],
                              "traffic": "refined_pass", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "pass_s":
            m["workloads"].append("d2_refined")
    spec["per_layer"].append({"name": "route_calls.refined", "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "host routing: models._route", "moves": "pass_s",
                              "workloads": ["d2_refined"]})
    monkeypatch.setattr(harness, "HERE", copy)
    cfg, _ = small("d2_n100k_pass")  # the traffic file itself, found by name
    res = harness.run_cell(spec, "d2_refined", 7, 0.2, 1, device="cpu", cfg=cfg)
    assert res["correct"] is True
    assert res["metrics"]["route_calls.refined"]["value"] >= 1
