"""The benchmark's shared machinery: what ``BENCHMARK.json`` names, found by
name among the benchmark's files; the data made from a seed; the model built
through the program's public builder; spans and counters; the run of one
cell; and the guard against JAX in the process.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own (``configs/``, ``traffic/``,
``metrics/``); a traffic mix names the driver of its kind
(``drivers/<kind>.py``), and a configuration its leaf kernels and its data
recipe (``data/<recipe>.py``). This module reads them by the names the
spec and the configuration give, so that a new cell needs new files and no
edit here: it names no kernel kind and holds no data formula.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
SPEC = REPO / "BENCHMARK.json"

#: top-level module names that must not be loaded in a run: the JAX stack
#: and the JAX package the port was made from (compared whole, so that the
#: port, whose name begins with the JAX package's, passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepstructuredmixtures_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    tops = {str(name).split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its own CUDA libraries under ``build/kernels``)."""
    base = REPO / "build" / "bench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(base / sub)


# -- what the spec names ------------------------------------------------------


def load_spec(path=SPEC):
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_entry(spec, name):
    return _by_name(spec["workloads"], name, "workload")


def load_config(spec, cell):
    entry = _by_name(spec["configs"], cell["config"], "configuration")
    with open(REPO / entry["file"]) as f:
        return json.load(f)


def load_traffic(name):
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_limits(cell_name):
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def _load_file(path, tag):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind):
    return _load_file(HERE / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def load_reader(metric):
    tag = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    return _load_file(HERE / "metrics" / f"{metric}.py", tag)


def load_reference(cfg):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def load_recipe(cfg):
    """The configuration's data recipe, ``data/<cfg["data"]>.py``."""
    name = cfg["data"]
    return _load_file(HERE / "data" / f"{name}.py", f"portbench_data_{name}")


def cell_metrics(spec, cell_name, trace):
    """The metric entries a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones."""
    e2e = spec["end_to_end"]
    mine = {m["name"] for m in e2e
            if "workloads" not in m or cell_name in m["workloads"]}
    if not trace:
        return [m for m in e2e if m["name"] in mine]
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


# -- inputs ------------------------------------------------------------------


def seed_key(seed):
    """Any whole number (the driver's exceed 32 signed bits) as a NumPy
    seed."""
    return int(seed) % (1 << 64)


def make_data(cfg, seed):
    """The configuration's training data ``(x [N, D], y [N])`` from
    ``seed``, by its recipe's ``make``."""
    return load_recipe(cfg).make(cfg, seed)


def test_points(cfg, seed=None):
    """The configuration's test points ``[T, D]``, by its recipe's
    ``test_points``; a recipe whose points depend on the seed needs it."""
    return load_recipe(cfg).test_points(cfg, seed)


def hypers(cfg):
    """The starting hypers in the port's packed layout, written from the
    configuration: for each leaf kernel in order ``[logl..., logsigma,
    log_noise]``, ``logsigma`` 0 for a kind without a variance (whose entry
    has none: :func:`leaf_kernels`)."""
    parts = []
    for k in cfg["kernels"]:
        parts += [*np.atleast_1d(k["logl"]), k.get("logsigma", 0.0), cfg["log_noise"]]
    return np.array(parts, dtype=np.float64)


def leaf_kernels(cfg, dim):
    """The configuration's ``kernels`` list as the port's ``KernelSpec``s,
    in order. Each entry's ``kind`` is one of the port's kinds
    (``kernels.KIND_*``); its ``logl`` is one value or a list of one per
    input dimension (``dim``); a kind with a variance takes ``logsigma`` and
    any other none. Anything else raises ``ValueError``."""
    from deepstructuredmixtures_tpu_torch import kernels

    kinds = sorted(v for n, v in vars(kernels).items() if n.startswith("KIND_"))
    specs = []
    for e in cfg["kernels"]:
        if e["kind"] not in kinds:
            raise ValueError(f"unknown kernel kind {e['kind']!r}; the port's: {kinds}")
        logl = tuple(float(v) for v in np.atleast_1d(e["logl"]))
        if len(logl) not in (1, dim):
            raise ValueError(f"{e['kind']}: {len(logl)} lengthscales for {dim}-D data")
        spec = kernels.KernelSpec(e["kind"], logl, 0.0)
        if spec.has_variance:
            spec = spec._replace(logsigma=float(e["logsigma"]))
        elif "logsigma" in e:
            raise ValueError(f"{e['kind']} has no variance, so no logsigma")
        specs.append(spec)
    if not specs:
        raise ValueError("the configuration names no leaf kernel")
    return specs


def build_model(cfg, x, y, device):
    """The configuration's model through the program's public builder, not
    fitted, without the overlap analysis (no cell reads it): one leaf kernel
    alone, several as a list (a leaf-level mixture)."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    specs = leaf_kernels(cfg, np.shape(x)[1])
    return tdsm.build_dsmgp(
        x, y, V=cfg["V"], K=cfg["K"], M=cfg["M"], depth=cfg["depth"], eps=cfg["eps"],
        kernel=specs[0] if len(specs) == 1 else specs, log_noise=cfg["log_noise"],
        seed=cfg["tree_seed"], device=device, dtype=getattr(torch, cfg["dtype"]),
        do_fit=False, overlap=False)


def work_of(model, tmask=None):
    """What the per-layer readers count operations over: each size
    bucket's padded width and its leaves' sizes, every leaf's size and,
    with ``tmask``, its routed test points."""
    sizes = np.array([o.size for o in model.plan.leaf_obs])
    buckets = [{"nmax": int(nm), "n": sizes[np.asarray(ids)].tolist()}
               for nm, ids in zip(model.bucket_spec.nmaxs, model.bucket_spec.leaf_ids)]
    work = {"dim": int(model.plan.dim), "leaf_n": sizes.tolist(), "buckets": buckets}
    if tmask is not None:
        work["routed"] = np.asarray(tmask).sum(axis=1).tolist()
    return work


# -- spans and counters ---------------------------------------------------------


class Recorder:
    """Host-clock spans and counters the benchmark takes around its calls
    into the program."""

    def __init__(self):
        self.spans = {}
        self.counters = {}

    def add(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def span(self, name, sync=None):
        """Time the block; ``sync`` (a callable) runs before the start and
        before the end, so that device work is inside the span."""
        if sync:
            sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                sync()
            self.add(name, time.perf_counter() - t0)


class Run:
    """One run of one cell: its configuration, traffic, seed, window,
    device and recorder. A driver fills ``setup_s``, ``e2e``, ``attempted``,
    ``failed``, ``memory_peak_bytes``, ``trace`` and ``outputs``."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device, t0):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.traced = seed, seconds, bool(trace)
        self.device, self.t0 = device, t0
        self.rec = Recorder()
        self.setup_s = None
        self.e2e = {}
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.trace = None
        self.work = {}
        self.outputs = None

    def sync(self):
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def mark_setup(self):
        self.setup_s = time.perf_counter() - self.t0

    def read_memory_peak(self):
        if self.device != "cpu":
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free_device(self):
        import gc

        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()


def timed_window(run, step, traced_units, counters=dict, span="unit"):
    """The measured window: ``step()`` (which returns whether its result is
    finite) until ``run.seconds`` have passed, each call a host-clock span
    ``span``. A traced run profiles ``traced_units`` calls after the first
    (spans ``traced_<span>``) and records how ``counters()`` moved over
    them. Returns ``(calls, failed, seconds)``."""
    from benchmark import tracing

    rec, n, bad = run.rec, 0, 0
    t0 = time.perf_counter()
    while True:
        if run.traced and n == 1:
            before = counters()
            with tracing.profiled(run) as stretch:
                for _ in range(traced_units):
                    t1 = time.perf_counter()
                    bad += not step()
                    rec.add(f"traced_{span}", time.perf_counter() - t1)
                    stretch.units += 1
                    n += 1
            after = counters()
            rec.counters.update({k: after[k] - before[k] for k in after})
        else:
            t1 = time.perf_counter()
            bad += not step()
            rec.add(span, time.perf_counter() - t1)
            n += 1
        if time.perf_counter() - t0 >= run.seconds and (not run.traced or n > 1):
            return n, bad, time.perf_counter() - t0


def run_cell(spec, cell_name, seed, seconds, trace, device="cuda", t0=None,
             cfg=None, traffic=None, limits=None):
    """Run one cell once and return the result object (a dict whose keys
    are in the order they are printed). ``cfg``, ``traffic`` and ``limits``
    replace the ones the spec names (the tests' small sizes)."""
    return drive(spec, cell_name, seed, seconds, trace, device, t0, cfg, traffic,
                 limits)[0]


def drive(spec, cell_name, seed, seconds, trace, device="cuda", t0=None,
          cfg=None, traffic=None, limits=None):
    """:func:`run_cell`, returning ``(result, numbers, run)``: every number
    the comparison read, and the run with its outputs and the reference's
    results."""
    from benchmark import check

    t0 = time.perf_counter() if t0 is None else t0
    cell = cell_entry(spec, cell_name)
    cfg = cfg or load_config(spec, cell)
    traffic = traffic or load_traffic(cell["traffic"])
    limits = limits or load_limits(cell_name)
    run = Run(cell, cfg, traffic, seed, seconds, trace, device, t0)
    load_driver(traffic["kind"]).run(run)
    numbers = check.compare(run)
    verdict = check.judge(numbers, limits)
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        if trace:
            value = load_reader(m["name"]).read(run)
        elif m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": verdict["correct"], "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info(run)}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = verdict["checks"]
    return result, numbers, run


def device_info(run):
    if run.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        import torch

        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(run.cell["chips"]),
                "memory_peak_bytes": int(run.memory_peak_bytes),
                "power_limit": power_limit()}
    if run.traced and run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it (None if it
    cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
