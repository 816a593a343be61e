"""The port's spans (``utils.profiling``) on the CPU, on a toy tree of 8
leaves in two size buckets: off, they leave no trace and change no bit;
on, the streamed pass, the cached predict, the training gradient and the
serving front give the spans and attributes the module documents, with
their parents, inside a ``torch.profiler`` trace too; the log is
bounded."""
import importlib
import math
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch import serve as tserve
from deepstructuredmixtures_tpu_torch.utils import profiling

from .torch_threads import one_torch_thread  # noqa: F401

# the package attribute ``train`` is the function; the module by name
ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")

#: 2 MiB: one leaf a chunk at nmax 256, four at nmax 128
BUDGET = 1 << 21
XT = torch.linspace(-0.05, 1.05, 40, dtype=torch.float64)[:, None]


def _model():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 500))
    y = np.sin(6 * x) + 0.1 * rng.normal(size=500)
    return tdsm.build_dsmgp(x, y, V=2, K=3, M=30, depth=1, device="cpu", seed=1,
                            overlap=False, do_fit=False)


@pytest.fixture(scope="module")
def model():
    m = _model()
    assert [b.nmax for b in m.bucket_batches] == [128, 256]
    return m


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear()
    yield
    profiling.clear()


def _args(m):
    return (m.layout, m.theta, m.bucket_batches, m.bucket_spec.leaf_ids, m.num_leaves)


def _chunks(m):
    """``(nmax, leaves)`` of every leaf chunk at :data:`BUDGET`."""
    out = []
    for b in m.bucket_batches:
        c = tfit._bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, BUDGET)
        out += [(b.nmax, min(c, b.num_leaves - s)) for s in range(0, b.num_leaves, c)]
    return out


def _streamed(m):
    return tfit.bucketed_streamed_predict(*_args(m), XT, budget=BUDGET)


def _factors(m):
    """``(Lf, alpha)`` of every bucket: the hybrid store's entries."""
    out = []
    for b in m.bucket_batches:
        _, alpha, Lf = tfit.streamed_leaf_factors(m.layout, m.theta, b)
        out.append((Lf, alpha))
    return out


def _cached(m, factors):
    return tfit.bucketed_hybrid_predict(*_args(m), factors, XT, budget=BUDGET)


def _gradient(m):
    vg = ttrain.make_value_and_grad_bucketed(m.layout, m.plan, m.bucket_batches,
                                             m.bucket_spec.leaf_ids, budget=BUDGET)
    return vg(m.theta)


@pytest.fixture(scope="module")
def streamed_log(model):
    profiling.clear()
    with profiling.recording():
        _streamed(model)
    return profiling.records()


def _refuse(*a, **k):
    raise AssertionError("recording is off")


def test_off_leaves_no_trace_and_on_changes_no_bit(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    factors = _factors(model)
    off = [_streamed(model), _cached(model, factors), _gradient(model)]
    assert profiling.records() == [] and profiling.dropped() == 0
    monkeypatch.undo()
    with profiling.recording():
        on = [_streamed(model), _cached(model, factors), _gradient(model)]
    names = Counter(r["name"] for r in profiling.records())
    assert {"streamed_predict", "factor", "train.value", "train.backward"} <= set(names)
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_streamed_pass_span_tree(model, streamed_log):
    by_id = {r["id"]: r for r in streamed_log}

    def parent(r):
        return by_id[r["parent"]]["name"]

    names = Counter(r["name"] for r in streamed_log)
    chunks = _chunks(model)
    assert names == {"streamed_predict": 1, "bucket": 2, "chunk": len(chunks),
                     "gram": 2 * len(chunks), "factor": len(chunks),
                     "solve": len(chunks), "moments": 2 * len(chunks)}
    for r in streamed_log:
        want = {"streamed_predict": None, "bucket": "streamed_predict",
                "chunk": "bucket"}.get(r["name"], "chunk")
        assert (r["parent"] is None if want is None else parent(r) == want), r
        assert r["host_ms"] >= 0 and r["device_ms"] is None
    buckets = [r["attrs"] for r in streamed_log if r["name"] == "bucket"]
    assert buckets == [{"nmax": b.nmax, "leaves": b.num_leaves}
                       for b in model.bucket_batches]
    assert [r["attrs"]["leaves"] for r in streamed_log if r["name"] == "chunk"] == [
        g for _, g in chunks]


def test_factor_spans_carry_the_padded_work(model, streamed_log):
    padded = [r["attrs"]["padded_flops"] for r in streamed_log if r["name"] == "factor"]
    assert padded == [g * n ** 3 / 3 for n, g in _chunks(model)]
    assert math.isclose(sum(padded), sum(b.num_leaves * b.nmax ** 3 / 3
                                         for b in model.bucket_batches))


def test_cached_predict_spans(model):
    """Every cached bucket in as few forward-solve launches as the budget
    allows: per launch a ``chunk`` holding one ``gram`` and one
    ``moments`` per bucket piece and one ``solve``; no streamed bucket."""
    factors = _factors(model)
    total = sum(b.num_leaves for b in model.bucket_batches)
    for budget, launches in ((BUDGET, None), (1 << 30, 1)):
        profiling.clear()
        with profiling.recording():
            tfit.bucketed_hybrid_predict(*_args(model), factors, XT, budget=budget)
        recs = profiling.records()
        ids = {r["id"]: r["name"] for r in recs}
        names = Counter(r["name"] for r in recs)
        assert names["solve"] == names["chunk"] >= 1
        assert names["gram"] == names["moments"] >= max(2, names["chunk"])
        assert launches is None or names["chunk"] == launches
        assert sum(r["attrs"]["leaves"] for r in recs if r["name"] == "chunk") == total
        assert "factor" not in names and "bucket" not in names
        assert all(ids[r["parent"]] == "chunk" for r in recs
                   if r["name"] in ("gram", "solve", "moments"))
    assert names["gram"] == 2  # one cross-gram call per bucket


def test_spans_reach_the_profiler(model):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _streamed(model)
    events = [e for e in prof.events() if getattr(e, "time_range", None) is not None]
    names = {e.name for e in events}
    assert {"streamed_predict", "bucket", "chunk", "gram", "factor", "solve",
            "moments"} <= names
    for span in ("gram", "factor", "solve"):
        outer = [e.time_range for e in events if e.name == span]
        inner = [e.time_range for e in events if e.name.startswith("aten::")]
        assert all(any(o.start <= i.start and i.end <= o.end for i in inner)
                   for o in outer), span
    # the profiler switched recording on
    assert Counter(r["name"] for r in profiling.records())["chunk"] == len(_chunks(model))


def test_training_spans(model):
    theta = model.theta.detach().clone().requires_grad_(True)
    opt = ttrain._adam([theta])
    with profiling.recording():
        _, g = _gradient(model)
        ttrain._ascend(opt, theta, g)
    recs = profiling.records()
    names = Counter(r["name"] for r in recs)
    n = len(_chunks(model))
    assert names["train.value"] == 1 and names["train.responsibilities"] == 1
    assert names["train.recompute"] == n and names["train.backward"] == n
    assert names["train.step"] == 1
    assert [r["attrs"]["leaves"] for r in recs if r["name"] == "train.recompute"] == [
        g for _, g in _chunks(model)]
    assert all(r["parent"] is None for r in recs if r["name"].startswith("train."))


def test_micro_batcher_spans_join_by_request():
    m = _model()
    pred = tserve.Predictor(m, chunk_points=16)
    mb = tserve.MicroBatcher(pred, max_batch_points=48, max_wait_ms=20.0)
    rng = np.random.default_rng(1)
    queries = [rng.uniform(0, 1, (12, 1)) for _ in range(12)]
    try:
        with profiling.recording():
            threads = [threading.Thread(target=lambda q=q: mb.predict(q)) for q in queries]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        mb.close()
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    per = {}
    for r in recs:
        if r["name"] in ("serve.queue", "serve.request"):
            per.setdefault(r["attrs"]["request"], {})[r["name"]] = r
    batches = {r["attrs"]["batch"]: r for r in recs if r["name"] == "serve.batch"}
    assert len(per) == len(queries)
    for spans in per.values():
        q, req = spans["serve.queue"], spans["serve.request"]
        assert q["attrs"]["batch"] == req["attrs"]["batch"]
        b = batches[req["attrs"]["batch"]]
        assert q["host_ms"] + b["host_ms"] <= req["host_ms"]
        assert q["host_t1_ns"] <= b["host_t0_ns"] and b["host_t1_ns"] <= req["host_t1_ns"]
    collects = [r for r in recs if r["name"] == "serve.collect"]
    assert sum(c["attrs"]["requests"] for c in collects) == len(queries)
    assert sum(c["attrs"]["points"] for c in collects) == 12 * len(queries)
    chunks = [r for r in recs if r["name"] == "predict.chunk"]
    assert chunks and all(by_id[r["parent"]]["name"] == "serve.batch" for r in chunks)
    assert sum(r["attrs"]["points"] for r in chunks) == 12 * len(queries)
    for name in ("route", "moment_match", "chunk"):
        assert any(r["name"] == name for r in recs), name


def test_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "LOG_SIZE", 3)
    with profiling.recording():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
        profiling.record("r", profiling.stamp(), 0)
    assert [r["attrs"]["i"] for r in profiling.records()] == [0, 1, 2]
    assert profiling.dropped() == 3
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0
    profiling.record("r", profiling.stamp(), 0)  # recording off: no start
    assert profiling.records() == []


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on a machine without a card:
    complete once recorded, 2 ms between any two."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.stream = None

    def record(self, stream):
        self.stream = stream

    def query(self):
        return self.stream is not None

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 2.0


def test_cuda_events_are_reused(monkeypatch):
    """Spans on a CUDA device record two events each from a pool that
    takes back the events of spans the device has passed."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_stream", lambda index: "stream")
    _FakeEvent.made = 0
    dev = torch.device("cuda", 0)
    with profiling.recording():
        for i in range(50):
            with profiling.span("outer", device=dev, i=i):
                with profiling.span("inner"):
                    pass
    recs = profiling.records()
    assert len(recs) == 100 and all(r["device_ms"] == 2.0 for r in recs)
    assert _FakeEvent.made <= 6
    with profiling.recording(), profiling.span("timed", device=dev) as sp:
        pass
    assert sp.seconds() == 2e-3
