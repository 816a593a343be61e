"""The traced stretch of a run: ``torch.profiler`` over a few whole passes,
iterations or batches inside the window, reduced to what the per-layer
readers and the result's ``breakdown`` need.

* ``kernels``: every device kernel's ``(name, start_us, end_us)``, without
  the operators around them, the runtime calls and the runtime's "Command
  Buffer Full" (the host waiting to enqueue);
* ``busy_s``: the union of the kernels' intervals (a kernel on a side
  stream that overlaps another counts once);
* ``window_s``: the traced stretch's length on the host clock;
* ``units``: how many whole passes, iterations or batches it held;
* ``breakdown``: the ten kernels with the most device time, and the ten
  longest idle gaps of the device, each named by the innermost host-side
  event that covers its middle.

Kernels are grouped by a part of their names as the port's own profiling
script groups them.
"""
from __future__ import annotations

import contextlib
import time

#: the CUDA kernels of the blocked Cholesky (``csrc/blocked_cholesky.cu``)
BLOCKED = ("diag_inv_kernel", "panel_kernel", "lookahead_update_kernel",
           "trailing_update_kernel")
FUSED = ("fused_gram_cholesky",)
#: the other groups, by a part of the lower-case name, taken in this order;
#: what matches none is "other" (the gram, masking, casts and copies)
GROUPS = {"cholesky_library": ("potrf", "chol", "getrf", "syrk"),
          "triangular_solves": ("trsm", "trsv"),
          "matrix_products": ("gemm", "cutlass", "xmma")}


def group(name):
    if any(k in name for k in BLOCKED):
        return "blocked_cholesky"
    if any(k in name for k in FUSED):
        return "fused_gram_cholesky"
    low = name.lower()
    for g, parts in GROUPS.items():
        if any(p in low for p in parts):
            return g
    return "other"


def union_s(spans):
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    return (busy + hi - lo) / 1e6


MARK = "portbench.stretch"


class Stretch:
    """What the block profiled by :func:`profiled` is handed: ``units``,
    the whole passes, iterations or batches it ran, and :meth:`start`,
    which a caller whose units begin later than the block (a batch of a
    worker thread) calls at the first unit's start."""

    def __init__(self):
        self.units = 0
        self.t0 = None

    def start(self):
        import torch

        with torch.profiler.record_function(MARK):
            self.t0 = time.perf_counter()


def warm(run):
    """Start and stop the profiler once on a trivial op: its first start in
    a process (CUPTI's set-up) takes seconds, which a window that profiles
    from a thread of its own cannot wait for."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if run.device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cpu" if run.device == "cpu" else "cuda").add_(1)
        run.sync()


@contextlib.contextmanager
def profiled(run):
    """Profile the block, which sets the yielded :class:`Stretch`'s
    ``units``; sets ``run.trace`` from the block's start, or from the
    stretch's :meth:`Stretch.start` if it was called."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if run.device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    stretch = Stretch()
    t0 = time.perf_counter()
    try:
        yield stretch
        run.sync()
        window = time.perf_counter() - (stretch.t0 or t0)
    finally:
        prof.__exit__(None, None, None)
    run.trace = summarize(prof, window, stretch.units, marked=stretch.t0 is not None)


def summarize(prof, window_s, units, marked=False):
    from torch.autograd import DeviceType

    kernels, host, start = [], [], None
    for e in prof.events():
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if e.name.startswith(("aten::", "cuda")) or e.name == "Command Buffer Full":
                continue
            kernels.append((e.name, tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
            if marked and e.name == MARK:
                start = tr.start
    if start is not None:
        kernels = [k for k in kernels if k[1] >= start]
        host = [h for h in host if h[1] >= start]
    busy = union_s([(s, t) for _, s, t in kernels])
    return {"kernels": kernels, "busy_s": busy, "window_s": window_s,
            "units": units, "breakdown": breakdown(kernels, host)}


def breakdown(kernels, host, top=10):
    by_name = {}
    for name, s, t in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, t) for _, s, t in kernels)
    gaps = []
    if spans:
        hi = spans[0][1]
        for s, t in spans[1:]:
            if s > hi:
                gaps.append((hi, s))
            hi = max(hi, t)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        cover = [(t - s, name) for s, t, name in host if s <= mid <= t]
        named.append([min(cover)[1] if cover else "host", (hi - lo) / 1e6])
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": named}


def group_seconds(run, name):
    """Device seconds of the kernel group ``name`` in the traced stretch
    (None without a trace or without such kernels)."""
    if run.trace is None:
        return None
    secs = [(t - s) / 1e6 for n, s, t in run.trace["kernels"] if group(n) == name]
    return sum(secs) if secs else None


def per_unit_ms(run, name):
    """Device milliseconds of the group ``name`` per traced unit."""
    secs = group_seconds(run, name)
    if secs is None or not run.trace["units"]:
        return None
    return 1e3 * secs / run.trace["units"]


def idle_share(run):
    """The device's idle share (%) of the traced stretch: 1 - busy / wall."""
    tr = run.trace
    if tr is None or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def group_union_s(run, name):
    """Seconds covered by the union of the group's kernel intervals: for a
    kernel that runs part of its work on a side stream, the time it holds
    the card."""
    if run.trace is None:
        return None
    spans = [(s, t) for n, s, t in run.trace["kernels"] if group(n) == name]
    return union_s(spans) if spans else None
