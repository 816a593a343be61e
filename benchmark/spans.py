"""The program's own spans (``deepstructuredmixtures_tpu_torch.utils.
profiling``) that a run recorded.

The program records its spans while a ``torch.profiler`` session records,
so the log holds what ran in the traced stretch (``tracing.profiled``):
whole passes, iterations or the last batches of the serving window.
Readers keep the spans that began after the run started, so that runs in
one process (the tests) do not mix, and divide by the count of their own
root spans in that log. A span's time is its device milliseconds (its CUDA
events; its host milliseconds where its work ran on the CPU). A program
without the span log gives nothing: every reader then returns ``None``.
"""
from __future__ import annotations

import statistics


def records(run):
    """The run's span records, or ``None`` if the program recorded none
    (or records none at all)."""
    try:
        from deepstructuredmixtures_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    start = int(run.t0 * 1e9)  # time.perf_counter seconds, as perf_counter_ns
    recs = [r for r in read() if r["host_t0_ns"] >= start]
    return recs or None


def ms(r):
    return r["device_ms"] if r["device_ms"] is not None else r["host_ms"]


def named(run, name):
    recs = records(run)
    return [r for r in recs if r["name"] == name] if recs else []


def per_unit(run, name, unit, value=ms):
    """``Σ value`` over the spans ``name``, per span ``unit`` (None
    without either)."""
    spans, units = named(run, name), named(run, unit)
    if not spans or not units:
        return None
    return sum(value(r) for r in spans) / len(units)


def host_mean(run, name):
    spans = named(run, name)
    return statistics.fmean(r["host_ms"] for r in spans) if spans else None


def host_median(run, name):
    spans = named(run, name)
    return statistics.median(r["host_ms"] for r in spans) if spans else None
