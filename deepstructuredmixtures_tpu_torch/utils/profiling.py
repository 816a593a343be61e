"""Tracing / profiling utilities (counterpart of
``deepstructuredmixtures_tpu/utils/profiling.py``).

The reference's only instrumentation is ``@elapsed`` self-timing of
``fit!``/``fit_naive!`` (``fit.jl:88,121,299,303``). Here timing is a
first-class return (``fit`` returns wall-clock seconds) plus:

* :func:`span` — the program's spans, recorded where the work happens
  (below); they never synchronize the device;
* :class:`PhaseTimer` — the coarse timer: named per-phase wall-clock
  accumulation for build/fit/update/predict breakdowns; on a CUDA device it
  synchronizes the device at both ends of a phase, so that a phase is
  charged the device work it enqueued;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (viewable in Perfetto) of the host and, where there is
  one, the CUDA device.

Spans
-----
The program wraps its layers in ``with span(name, **attrs):``. While
nothing records, a span is one shared no-op context: one flag check, no
object, no CUDA event, no ``RecordFunction`` and no synchronization.
Recording is on while a ``torch.profiler`` session records, in any thread,
and inside :func:`recording`. A recorded span

* enters a ``RecordFunction`` of the operator scope
  (``torch._C._profiler._RecordFunctionFast(name)``), so that it appears
  on a profiler's host rows, on the kernels' clock, as an operator does.
  ``torch.profiler.record_function`` is the user scope, which the profiler
  also projects onto the device as a range over the span's kernels; a
  trace reader that takes the device's events for kernels then counts the
  span as one. The profiler sees only the threads it profiles: the one
  that started it, and autograd's;
* takes its host start and end (``time.perf_counter_ns``);
* where its work is on a CUDA device (``device=``, else the enclosing
  span's), records a start and an end CUDA event on the current stream,
  from a pool of reused events;
* is appended to a bounded in-memory log (:data:`LOG_SIZE` entries; the
  ones past it are counted by :func:`dropped`) with its parent, the
  enclosing span of the same thread.

:func:`record` logs a span whose start and end fall in different threads
(a request put by a client and answered by a worker), from a start taken
with :func:`stamp`. :func:`records` returns the log, each entry's device
milliseconds read from its events once they have completed (synchronize
first); :func:`clear` empties it.

Recording without the profiler::

    from deepstructuredmixtures_tpu_torch.utils import profiling
    with profiling.recording():
        mu, var = model.predict(xt)
    torch.cuda.synchronize()
    for r in profiling.records():
        print(r["name"], r["attrs"], r["host_ms"], r["device_ms"], r["parent"])

On the device timeline: ``with profiling.trace("logdir"): ...`` writes
``logdir/trace.json``, whose host rows hold the spans above the kernels
they launched (open it in https://ui.perfetto.dev).

The program's spans, and their attributes:

* streamed fit and predict (``fit.bucketed_streamed_predict``):
  ``streamed_predict`` (one per call) → ``bucket`` (``nmax``, ``leaves``)
  → ``chunk`` (``leaves``) → ``gram`` (the noisy gram; a second one for the
  cross-gram, its masking and the right-hand side), ``factor``
  (``padded_flops`` = leaves × nmax³ / 3: the fused kernel, which builds
  its gram itself, the blocked kernel or ``cholesky_nosym``), ``solve``
  (the forward solve; under ``fit._kept_recipe`` with both moment sums,
  ``ops.trsm``), ``moments`` (mean, variance, their casts; a second one
  for the leaf mll). The cached predict (``fit.bucketed_hybrid_predict``,
  ``cached_leaf_predict``) gives per forward-solve launch a ``chunk``
  (``leaves``) → ``gram`` per bucket, one ``solve``, ``moments`` per
  bucket, and a ``bucket`` span per streamed bucket;
* ``route`` (``models._route``, host), ``update_weights``
  (``infer.update_weights``), ``moment_match``
  (``models._routed_moment_match``);
* ``build`` (``models.build_dsmgp``, ``build_poe``, ``build_bcm``, without
  the initial fit) → ``tree``, ``plan`` (with the overlap schedule),
  ``buckets``;
* ``fit_shared.phase1``, ``.givens``, ``.continue``, ``.copy``,
  ``.posterior`` (``fit.fit_shared``, whose ``split`` reads them);
* training (``train.make_value_and_grad_bucketed``, ``train._ascend``):
  ``train.value`` (the no-graph pass over every bucket),
  ``train.responsibilities``, per leaf chunk ``train.recompute``
  (``leaves``: the forward with a graph) and ``train.backward`` (its
  ``.backward``), ``train.step`` (the optimizer step);
* serving (``serve.MicroBatcher``, ``serve.Predictor``): ``serve.request``
  (put to reply) and ``serve.queue`` (put to the worker taking it into a
  batch), both with ``request`` and ``batch`` ids; per batch
  ``serve.collect`` (first item taken to the batch closed; ``batch``,
  ``requests``, ``points``) and ``serve.batch`` (the predict of a group;
  ``batch``, ``requests``, ``points``) → ``predict.chunk`` (``points``: one
  ``chunk_points`` slice) → ``route``, the cached predict's spans,
  ``moment_match``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

#: entries the span log keeps; later ones are counted, not kept
LOG_SIZE = 1 << 16

_NOOP = contextlib.nullcontext()


class _Log:
    """The process's span log, the recording switch and the event pool.

    A closed span holds its two CUDA events until their times are read;
    then they go back to the pool. When the pool runs dry the oldest spans
    still holding events are read first, as far as the device has reached
    them, so that events are reused while recording goes on."""

    def __init__(self):
        self.lock = threading.RLock()
        self.entries = []
        self.dropped = 0
        self.forced = 0  # depth of recording() blocks, over all threads
        self.ids = itertools.count(1)
        self.pool: Dict[int, list] = collections.defaultdict(list)  # device index -> free events
        self.holding = collections.deque()  # closed spans holding events, oldest first
        self.streams = {}  # torch._C._cuda_getCurrentStream(index) -> torch.cuda.Stream
        self.local = threading.local()

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def take_event(self, index):
        with self.lock:
            free = self.pool[index]
            while not free and self.holding:
                if not self.holding[0].resolve():
                    break
                self.holding.popleft()
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def append(self, entry):
        with self.lock:
            if len(self.entries) < LOG_SIZE:
                self.entries.append(entry)
            else:
                self.dropped += 1
            if entry.events is not None:
                self.holding.append(entry)


_LOG = _Log()


def _on() -> bool:
    return bool(_LOG.forced) or getattr(_autograd_profiler, "_is_profiler_enabled", False)


class _Span:
    """One recorded span: the log entry and the context that records it."""

    __slots__ = ("id", "parent", "name", "attrs", "thread", "device", "t0", "t1",
                 "events", "stream", "device_ms", "_rf")

    def __init__(self, name, device, attrs, parent=None, t0=None, t1=None):
        self.id = next(_LOG.ids)
        self.name, self.attrs, self.parent = name, attrs, parent
        self.thread = threading.get_ident()
        self.device = device
        self.t0, self.t1 = t0, t1
        self.events = self.stream = None
        self.device_ms = None

    def __enter__(self):
        stack = _LOG.stack()
        up = stack[-1] if stack else None
        if up is not None:
            self.parent = up.id
        dev = self.device if self.device is not None else (up.device if up else None)
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device is not None:
            index = _index(self.device)
            self.stream = _stream(index)
            start = _LOG.take_event(index)
            start.record(self.stream)
            self.events = (index, start)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            index, start = self.events
            end = _LOG.take_event(index)
            end.record(self.stream)
            self.events, self.stream = (index, start, end), None
        self.t1 = time.perf_counter_ns()
        _LOG.stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        _LOG.append(self)
        return False

    def resolve(self, wait: bool = False) -> bool:
        """Read the device milliseconds from the events once the end event
        has completed (with ``wait``, after waiting for it), and give the
        events back to the pool. Returns whether the span holds no events
        now."""
        ev = self.events
        if wait and ev is not None and len(ev) == 3:
            ev[2].synchronize()
        with _LOG.lock:
            ev = self.events
            if ev is None:
                return True
            if len(ev) != 3 or not ev[2].query():
                return False
            index, start, end = ev
            self.device_ms = start.elapsed_time(end)
            self.events = None
            _LOG.pool[index] += (start, end)
            return True

    def seconds(self) -> float:
        """The span's device seconds, waiting for its end on the device;
        its host seconds where its work is not on a CUDA device."""
        self.resolve(wait=True)
        if self.device_ms is not None:
            return self.device_ms / 1e3
        return (self.t1 - self.t0) / 1e9

    def as_dict(self) -> dict:
        self.resolve()
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "attrs": dict(self.attrs), "thread": self.thread,
                "host_t0_ns": self.t0, "host_t1_ns": self.t1,
                "host_ms": (self.t1 - self.t0) / 1e6, "device_ms": self.device_ms}


def _index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _stream(index):
    """The current stream of the device ``index``: ``torch.cuda.current_stream``
    without its cost (8.7 µs a call on an H100 host, the raw handle 0.14 µs),
    one ``Stream`` object kept per handle."""
    key = torch._C._cuda_getCurrentStream(index)
    st = _LOG.streams.get(key)
    if st is None:
        st = _LOG.streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return st


def span(name: str, device=None, **attrs):
    """A span of the program's work named ``name`` with attributes
    ``attrs``; ``device`` (a ``torch.device``) says where its work runs
    (default: the enclosing span's). The shared no-op context unless
    recording is on (module docstring); else the recorded span, which the
    ``with`` statement yields."""
    if not _on():
        return _NOOP
    return _Span(name, None if device is None else torch.device(device), attrs)


def stamp():
    """``time.perf_counter_ns()`` while recording is on, else ``None``: the
    start of a span that :func:`record` closes in another thread."""
    return time.perf_counter_ns() if _on() else None


def record(name: str, t0_ns, t1_ns: int, **attrs):
    """Log a host-only span from ``t0_ns`` (from :func:`stamp`) to ``t1_ns``
    (``time.perf_counter_ns``), taken in different threads; nothing where
    ``t0_ns`` is ``None`` (recording was off at the start)."""
    if t0_ns is None:
        return
    _LOG.append(_Span(name, None, attrs, t0=t0_ns, t1=t1_ns))


@contextlib.contextmanager
def recording():
    """Record spans inside the block (in every thread) without a
    profiler."""
    with _LOG.lock:
        _LOG.forced += 1
    try:
        yield
    finally:
        with _LOG.lock:
            _LOG.forced -= 1


def records() -> list:
    """The log in the order the spans began, each entry a dict: ``id``,
    ``parent`` (the enclosing span's id, or ``None``), ``name``, ``attrs``,
    ``thread``, ``host_t0_ns``, ``host_t1_ns``, ``host_ms`` and
    ``device_ms`` (``None`` for host-only spans and for spans whose end the
    device has not reached: synchronize before reading)."""
    with _LOG.lock:
        entries = list(_LOG.entries)
    return [e.as_dict() for e in sorted(entries, key=lambda e: e.id)]


def dropped() -> int:
    """Spans not logged since the last :func:`clear`: the log was full."""
    return _LOG.dropped


def clear():
    """Empty the log and its count of dropped spans; the events of the
    spans it held go back to the pool."""
    with _LOG.lock:
        for e in _LOG.holding:
            if e.events is not None:
                _LOG.pool[e.events[0]] += e.events[1:]
                e.events = None
        _LOG.holding.clear()
        _LOG.entries, _LOG.dropped = [], 0


class PhaseTimer:
    """Accumulate wall-clock per named phase: the coarse timer, which
    synchronizes a CUDA device at both ends of every phase (:func:`span`
    never does).

    >>> t = PhaseTimer()          # or PhaseTimer(model.device)
    >>> with t.phase("fit"):
    ...     ...
    >>> t.timings()  # {'fit': 0.0123}
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._acc: Dict[str, float] = collections.defaultdict(float)
        self._count: Dict[str, int] = collections.defaultdict(int)

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
    too where one is available) and write ``logdir/trace.json``; the
    program's spans are recorded meanwhile and appear on its host rows.
    Yields the profiler, whose ``key_averages()`` sums time by op and
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))