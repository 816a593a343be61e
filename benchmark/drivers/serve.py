"""Driver of the ``serve`` traffic kind: a closed loop of clients against
the program's serving front.

Set-up builds the model and serves it through ``serve.MicroBatcher(
serve.Predictor(model, ...))``: the predictor refits it with the hybrid
store under ``factor_budget_bytes`` (null: every bucket's factors, the
footprint counted from the buckets' shapes), and the posterior weights
are updated from that fit (``model.update``). ``clients`` threads each
send a request of ``points_per_request`` points drawn uniformly on ``[lo,
hi]`` in each of the data's dimensions from the seed (one stream per
client), for the mean and variance, and send the next on reply.
``warm_rounds`` rounds of one request per client run in set-up. The window
runs until ``seconds`` have passed and the requests sent inside it have
their replies. With more clients than the server keeps up with, the loop
holds it at capacity, so the end-to-end metric is ``served_points_per_s``,
the test points of every completed request over the window; each request
is timed by the host clock from the client's call to its reply, for the
per-layer tails. A traced run profiles the last batches of the window,
about ``traced_batches`` + 2 of them.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from benchmark import harness, tracing


#: the traced stretch's timing (:func:`_traced`): timed by the window's
#: first three batches alone and with the profiler started at the stretch,
#: a stretch sometimes began after the last batch and held nothing
ESTIMATE_BEFORE_S = 5.0
PROFILER_LEAD_S = 1.0


def _footprint(model):
    item = model.dtype.itemsize
    return sum(b.num_leaves * b.nmax * b.nmax * item for b in model.bucket_batches)


def run(run):
    from deepstructuredmixtures_tpu_torch import serve
    from deepstructuredmixtures_tpu_torch.ops import build

    cfg, tr, rec = run.cfg, run.traffic, run.rec
    if run.device != "cpu":
        build.build()
    x, y = harness.make_data(cfg, run.seed)
    with rec.span("build"):
        model = harness.build_model(cfg, x, y, run.device)
    run.work = harness.work_of(model)
    budget = tr["factor_budget_bytes"]
    pred = serve.Predictor(model, chunk_points=tr["chunk_points"],
                           factor_budget=_footprint(model) if budget is None else budget)
    model.update()  # the posterior weights from the predictor's fit, as a user serves them
    mb = serve.MicroBatcher(pred, max_batch_points=tr["max_batch_points"],
                            max_wait_ms=tr["max_wait_ms"])
    C, P, D = tr["clients"], tr["points_per_request"], x.shape[1]
    key = harness.seed_key(run.seed)
    streams = [np.random.default_rng([key, 1, c]) for c in range(C)]

    def draw(rng):
        return rng.uniform(tr["lo"], tr["hi"], (P, D))

    try:
        warm = [np.random.default_rng([key, 2, c]) for c in range(C)]
        for _ in range(tr["warm_rounds"]):
            _together([lambda r=r: mb.predict(draw(r)) for r in warm])
        if run.traced:
            tracing.warm(run)
        run.mark_setup()

        done, lock = [], threading.Lock()
        errors = [0]
        stats0 = dict(mb.stats)
        t0 = time.perf_counter()
        deadline = t0 + run.seconds

        def client(rng):
            while time.perf_counter() < deadline:
                q = draw(rng)
                t1 = time.perf_counter()
                try:
                    mean, var, _ = mb.predict(q)
                except Exception:  # a failed request counts against the run
                    with lock:
                        errors[0] += 1
                    continue
                lat = time.perf_counter() - t1
                with lock:
                    done.append((q, mean, var, lat))

        threads = [threading.Thread(target=client, args=(r,)) for r in streams]
        for t in threads:
            t.start()
        if run.traced:
            _traced(run, mb, tr["traced_batches"], t0, deadline, threads)
        for t in threads:
            t.join()
        window = time.perf_counter() - t0
        stats = {k: mb.stats[k] - stats0.get(k, 0) for k in ("requests", "batches",
                                                              "batched_points")}
    finally:
        mb.close()
    lat_ms = np.array([d[3] for d in done]) * 1e3
    run.attempted, run.failed = len(done) + errors[0], errors[0]
    if lat_ms.size:
        run.e2e["served_points_per_s"] = sum(d[0].shape[0] for d in done) / window
    rec.counters.update(stats)
    rec.counters["window_s"] = window
    rec.spans["request_ms"] = lat_ms.tolist()
    run.read_memory_peak()
    run.outputs = {"x": x, "y": y, "requests": [(d[0], d[1], d[2]) for d in done],
                   "leaf_n": np.array(run.work["leaf_n"])}
    del model, pred, mb
    run.free_device()


def _together(calls):
    threads = [threading.Thread(target=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _traced(run, mb, batches, t0, deadline, threads):
    """Profile the window's last batches: from a batch boundary about
    ``batches`` + 2 batches before the deadline until every client has its
    last reply. The profiler stops, and its trace is read, only after the
    clients are done, so that reading it delays no request. The batch time
    is the window's mean over at least three batches and until
    ``ESTIMATE_BEFORE_S`` before the deadline, and the profiler starts
    ``PROFILER_LEAD_S`` before the stretch, whose mark leaves out what it
    records earlier."""
    b_start = mb.stats["batches"]
    # the window's first batch closes early on the clients that came first:
    # average over three at least
    while mb.stats["batches"] - b_start < 3 and time.perf_counter() < deadline:
        time.sleep(0.05)
    time.sleep(max(0.0, deadline - ESTIMATE_BEFORE_S - time.perf_counter()))
    per_batch = (time.perf_counter() - t0) / max(1, mb.stats["batches"] - b_start)
    begin = deadline - (batches + 2) * per_batch
    time.sleep(max(0.0, begin - PROFILER_LEAD_S - time.perf_counter()))
    with tracing.profiled(run) as stretch:
        time.sleep(max(0.0, begin - time.perf_counter()))
        b0 = mb.stats["batches"]
        while mb.stats["batches"] == b0 and any(t.is_alive() for t in threads):
            time.sleep(0.001)
        stretch.start()
        b1 = mb.stats["batches"]
        for t in threads:
            t.join()
        stretch.units = mb.stats["batches"] - b1
