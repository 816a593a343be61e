#!/usr/bin/env python3
"""Sets of runs of one cell, and their spreads: what the bounds are set
from.

    python3 benchmark/sets.py --workload <cell> --seeds S [S ...] [--sets 2]
        [--seconds N] [--trace 0|1] [--out FILE]

Runs ``benchmark/run.py`` once per seed, each in a new process as the
check runs it, and with ``--sets 2`` the same seeds again as a second set.
Prints each run's result line and then, per set and metric, the median and
the spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median; and the
widest spread over the sets. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    sets = []

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            res = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            emit({"set": s, "seed": seed, "rc": proc.returncode,
                  "wall_s": time.perf_counter() - t0, "result": res,
                  "stderr_tail": proc.stderr[-1500:] if res is None else None})
            if res is not None:
                runs.append(res)
        sets.append(runs)
    summary = {}
    for s, runs in enumerate(sets):
        names = {k for r in runs for k in r["metrics"]}
        for name in sorted(names):
            vals = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if len(vals) >= 2:
                entry = summary.setdefault(name, {"sets": []})
                entry["sets"].append({"median": statistics.median(vals),
                                      "spread": spread(vals), "values": vals})
    for entry in summary.values():
        entry["widest_spread"] = max(x["spread"] for x in entry["sets"])
    emit({"workload": args.workload, "summary": summary,
          "correct": [r["correct"] for runs in sets for r in runs]})


if __name__ == "__main__":
    main()
