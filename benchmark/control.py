#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the chip.

    python3 benchmark/control.py --workload <cell> --seeds S [S ...]
        [--control-seeds S [S ...]] [--seconds 1] [--faults] [--out FILE]

For each seed of ``--seeds``, one run of the cell's timed path at its own
size (a short window) and every number of its comparison with the float64
reference: the program's readings. For each seed of ``--control-seeds``
also the control's readings: the reference computed one step below the
program's float32 with TF32 off (float32 with TF32 allowed; in training
the grams' inner products in TF32), put in the program's place; and with
``--faults``, for a training cell, the readings of the fault that leaves
out half of the leaves (planted in the reference put in the program's
place). One JSON line per seed on standard output
(and appended to ``--out``), then the largest program reading and the
smallest control and fault reading of each number. The benchmark's own
runs do not run this.
"""
import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import check, harness  # noqa: E402


def readings(cell, seeds, control_seeds, seconds, out=None, device="cuda", faults=False,
             **over):
    """Per seed ``{"seed", "program", "control"?, "fault_half"?}`` and the
    summary ``{"lower": {...}, "control": {...}, "fault_half": {...}}``."""
    spec = harness.load_spec()
    rows = []
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)):
        t0 = time.perf_counter()
        result, nums, run = harness.drive(spec, cell, seed, seconds, 0, device, **over)
        row = {"seed": seed, "correct": result["correct"], "program": nums}
        if seed in control_seeds:
            row["control"] = check.control_numbers(run)
            if faults and run.traffic["kind"] == "train":
                row["fault_half"] = check.control_numbers(run, half=True)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
        run.reference = run.outputs = None
        run.free_device()
    summary = {"lower": {}, "control": {}, "fault_half": {}}
    for r in rows:
        if r["seed"] in seeds:
            for k, v in r["program"].items():
                summary["lower"][k] = max(summary["lower"].get(k, 0.0), v)
        for part in ("control", "fault_half"):
            for k, v in r.get(part, {}).items():
                summary[part][k] = min(summary[part].get(k, float("inf")), v)
    return rows, summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.set_cache_dirs()
    _, summary = readings(args.workload, args.seeds, args.control_seeds, args.seconds,
                          args.out, faults=args.faults)
    line = json.dumps({"workload": args.workload, "summary": summary})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
