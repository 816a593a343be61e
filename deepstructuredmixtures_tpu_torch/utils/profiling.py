"""Tracing / profiling utilities (counterpart of
``deepstructuredmixtures_tpu/utils/profiling.py``).

The reference's only instrumentation is ``@elapsed`` self-timing of
``fit!``/``fit_naive!`` (``fit.jl:88,121,299,303``). Here timing is a
first-class return (``fit`` returns wall-clock seconds) plus:

* :class:`PhaseTimer` — named per-phase wall-clock accumulation, for
  build/fit/update/predict breakdowns; on a CUDA device it synchronizes
  the device at both ends of a phase, so that a phase is charged the
  device work it enqueued;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (viewable in Perfetto) of the host and, where there is
  one, the CUDA device.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    >>> t = PhaseTimer()          # or PhaseTimer(model.device)
    >>> with t.phase("fit"):
    ...     ...
    >>> t.timings()  # {'fit': 0.0123}
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._now()
        try:
            yield
        finally:
            self._acc[name] += self._now() - t0
            self._count[name] += 1

    def timings(self) -> Dict[str, float]:
        return dict(self._acc)

    def counts(self) -> Dict[str, int]:
        return dict(self._count)

    def report(self) -> str:
        lines = [
            f"{k:>16s}: {v:9.4f}s  (x{self._count[k]})"
            for k, v in sorted(self._acc.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CUDA device
    too where one is available) and write ``logdir/trace.json``. Yields
    the profiler, whose ``key_averages()`` sums time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
