"""Each traffic mix at a small size on the CPU, through the port's plain
paths: a run prints a last line with the contract's keys, correct, in
both modes; and the entry refuses a machine without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench_small import CELLS, ROOT, run_small

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_gives_the_result_line(cell, trace):
    result, numbers, run = run_small(cell, trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(harness.load_spec(), cell, trace)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert "host_build_s" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], name


def test_entry_refuses_without_a_card():
    if _has_cuda():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_entry_fails_in_a_folder_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _has_cuda():
    import torch

    return torch.cuda.is_available()
