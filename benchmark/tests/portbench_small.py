"""Small sizes of the benchmark's cells, for the CPU tests: the same
configuration and traffic files with fewer training points, test points
and clients, run through the harness on the CPU (the port's plain
paths)."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
N_TRAIN = {2: 1500, 4: 1200}


def small(cell):
    """``(cfg, traffic)`` of ``cell`` at a size the CPU runs in a second or
    two."""
    entry = harness.cell_entry(SPEC, cell)
    cfg = harness.load_config(SPEC, entry)
    cfg = dict(cfg, n_train=N_TRAIN[cfg["depth"]], n_test=120)
    tr = harness.load_traffic(entry["traffic"])
    if tr["kind"] == "serve":
        tr = dict(tr, clients=4, points_per_request=16, max_batch_points=64,
                  chunk_points=32, checked_requests=8, warm_rounds=1)
    return cfg, tr


def run_small(cell, seed=20240601, seconds=0.3, trace=0):
    """``(result, numbers, run)`` of one small run of ``cell`` on the CPU."""
    cfg, tr = small(cell)
    return harness.drive(SPEC, cell, seed, seconds, trace, device="cpu", cfg=cfg,
                         traffic=tr)
