#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The cell is a
``workloads`` entry of ``BENCHMARK.json``; its configuration, traffic mix
and per-layer readers are found by name under ``benchmark/``. Prints, as
the last line of standard output, one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference, beside its limit, as also printed on the last lines of standard
error. Exits non-zero, printing no result, without a CUDA device or with
fewer than the cell asks for, if a JAX module was loaded, or on any error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, so that the
# benchmark's modules are ``benchmark.*`` and shadow nothing
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import check, harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              args.trace, device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    check.print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
