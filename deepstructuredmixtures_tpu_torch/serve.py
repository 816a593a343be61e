"""Serving: a prediction endpoint over a fitted model (counterpart of
``deepstructuredmixtures_tpu/serve.py``).

* :class:`Predictor` wraps a model and, by default, refits it with the
  hybrid store, so that a request runs cross-grams and triangular solves
  against cached factors instead of refactoring every leaf. Requests above
  ``chunk_points`` rows run in chunks of that size; the chunking is exact,
  since each test point's prediction is independent of the others.
* :class:`MicroBatcher` coalesces concurrent requests into one predict.
* an HTTP JSON endpoint (stdlib ``http.server``):
  ``python -m deepstructuredmixtures_tpu_torch.serve --checkpoint m.npz``
  then ``POST /predict {"x": [[...], ...]}`` → ``{"mean": [...], "var":
  [...], "latency_s": ...}``; ``{"x": ..., "variance": false}`` returns the
  mean alone from the alpha cache. ``GET /healthz`` and ``GET /info``
  (model class, leaves, hypers). Bad requests get 400, bodies over the cap
  413, a request the batcher did not serve in time 504, any other failure
  500. The checkpoint may come from the JAX package's ``checkpoint.save``.

One process per device. The JAX package pads requests to power-of-two
size classes and warms them up, which only avoids XLA recompiles; PyTorch
runs eagerly, so the port does neither.
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import json
import queue
import threading
import time

import numpy as np

from .config import as_2d
from .utils import profiling


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


class Predictor:
    """Serve-many wrapper around ``model.predict``.

    ``store``: with the default ``'auto'``, construction refits the passed
    model with the hybrid store (``model.fit(store='hybrid',
    factor_budget=...)``) when the budget admits any bucket or the model
    was never fitted, unless it already holds the full store: the largest
    buckets' factors are kept, the rest stream. Other holders of the same model object see that refit.
    ``'hybrid'`` refits in any case; ``'full'`` refits with the monolithic
    store unless the model already holds it; ``'light'`` leaves the model
    as it is (requests then refactor what it does not cache).

    ``chunk_points``: requests above this many rows run in chunks of it.
    """

    #: default memory budget of the cached factors, as in the JAX package
    FACTOR_BUDGET = 8 << 30

    def __init__(self, model, chunk_points: int = 256, store: str = "auto",
                 factor_budget: int = FACTOR_BUDGET):
        self.model = model
        self.chunk_points = int(chunk_points)
        self.dim = int(model.plan.dim)
        self._lock = threading.Lock()  # one request on the device at a time
        if store not in ("auto", "full", "hybrid", "light"):
            raise ValueError(f"unknown store {store!r}")
        if store == "full":
            if model.posterior is None:
                model.fit(store="full")
        elif store == "hybrid" or (
                store == "auto" and model.posterior is None
                and (any(model._hybrid_cached_flags(factor_budget))
                     or model._leaf_mll is None)):
            model.fit(store="hybrid", factor_budget=factor_budget)

    @property
    def _mean_only(self) -> bool:
        """Whether ``return_var=False`` takes the model's alpha-cache path."""
        m = self.model
        return (m._alpha_cache is not None
                and "return_var" in inspect.signature(m.predict).parameters)

    def _predict(self, x, return_var: bool):
        T = x.shape[0]
        if T > self.chunk_points:
            means, vars_ = [], []
            for s in range(0, T, self.chunk_points):
                m, v = self._predict(x[s:s + self.chunk_points], return_var)
                means.append(m)
                vars_.append(v)
            return (np.concatenate(means),
                    np.concatenate(vars_) if return_var else None)
        with profiling.span("predict.chunk", device=self.model.device, points=T):
            if not return_var and self._mean_only:
                return _host(self.model.predict(x, return_var=False)), None
            mean, var = self.model.predict(x)
            return _host(mean), (_host(var) if return_var else None)

    def _validate(self, x) -> np.ndarray:
        x = as_2d(np.asarray(x, dtype=np.float64))
        if x.shape[1] != self.dim:
            raise ValueError(
                f"expected {self.dim}-dimensional inputs, got {x.shape[1]}")
        if not np.all(np.isfinite(x)):
            raise ValueError("non-finite prediction inputs")
        return x

    def predict(self, x, return_var: bool = True):
        """``x [T, D]`` (or ``[T]`` for 1-D models) → ``(mean [T], var [T],
        seconds)`` as NumPy arrays; ``var`` is ``None`` when
        ``return_var=False``."""
        x = self._validate(x)
        with self._lock:
            t0 = time.perf_counter()
            mean, var = self._predict(x, return_var)
            dt = time.perf_counter() - t0
        return mean, var, dt

    def info(self) -> dict:
        m = self.model
        return {
            "class": type(m).__name__,
            "num_leaves": int(m.num_leaves),
            "dim": self.dim,
            "dtype": str(m.dtype).replace("torch.", ""),
            "theta": m.theta.cpu().numpy().tolist(),
            "num_mixtures": int(m.num_mixtures()),
        }


class _Pending:
    """A request in the queue: ``id`` and ``batch`` (the id of the batch
    that served it) join its spans; ``t_put`` is the span start
    (``profiling.stamp``) of its put."""

    __slots__ = ("id", "x", "want_var", "event", "mean", "var", "error",
                 "latency_s", "batched_with", "batch", "t_put")

    def __init__(self, x, want_var, id=None):
        self.id = id
        self.x = x
        self.want_var = want_var
        self.event = threading.Event()
        self.mean = self.var = self.error = None
        self.latency_s = 0.0
        self.batched_with = 1
        self.batch = None
        self.t_put = None


class MicroBatcher:
    """Coalesce concurrent predict requests into one routed predict.

    Each test point's prediction is independent (routing is per point,
    ``common.jl:101-122``), so concatenating requests and splitting the
    result rows is exact, and the part of a predict that does not depend
    on the request (refactoring the buckets the store does not cache) is
    paid once for the whole batch.

    A worker thread drains the queue: the first item opens a batch, then
    up to ``max_wait_ms`` is spent collecting more, at most
    ``max_batch_points`` rows in all (an item that would pass the cap opens
    the next batch). Mean-only and variance requests run as separate
    predicts. ``stats`` counts requests, batches, rows and the largest
    batch. :meth:`close` fails every request not served yet, the batch in
    flight included, instead of leaving it to wait out
    ``request_timeout_s``. Spans (``utils.profiling``): per request
    ``serve.queue`` and ``serve.request``, per batch ``serve.collect`` and
    ``serve.batch``.
    """

    def __init__(self, predictor: Predictor, max_batch_points: int = 1024,
                 max_wait_ms: float = 5.0, request_timeout_s: float = 600.0):
        self.pred = predictor
        self.max_batch_points = int(max_batch_points)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.request_timeout_s = float(request_timeout_s)
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._held = None  # item deferred by the row cap
        self._inflight = []  # the batch the worker is serving
        self._fail_lock = threading.Lock()
        self._stop = False
        self.stats = {"requests": 0, "batches": 0, "batched_points": 0,
                      "largest_batch": 0}
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def predict(self, x, return_var: bool = True):
        """Drop-in for :meth:`Predictor.predict`. Validation runs in the
        calling thread, so a malformed request raises to its own caller and
        never reaches a batch."""
        x = self.pred._validate(x)
        item = _Pending(x, bool(return_var), next(self._request_ids))
        t0 = time.perf_counter()
        item.t_put = profiling.stamp()
        self._q.put(item)
        if not item.event.wait(timeout=self.request_timeout_s):
            raise TimeoutError(
                f"prediction not served within {self.request_timeout_s} s")
        if item.error is not None:
            raise item.error
        item.latency_s = time.perf_counter() - t0
        return item.mean, item.var, item.latency_s

    def info(self) -> dict:
        return self.pred.info()

    def _fail(self, items):
        err = RuntimeError("MicroBatcher closed before request was served")
        for it in items:
            if not it.event.is_set():
                it.error = err
                it.event.set()

    def _fail_pending(self):
        """Fail the held item and everything still queued."""
        with self._fail_lock:
            held, self._held = self._held, None
            items = [] if held is None else [held]
            while True:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._fail(items)

    def close(self, timeout: float = 5.0):
        """Stop the worker and fail every request it has not served: the
        queued ones, the held one and, if the worker is still busy after
        ``timeout`` seconds, the batch in flight."""
        self._stop = True
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            self._fail(list(self._inflight))
        self._fail_pending()

    @staticmethod
    def _take(item, batch_id):
        """``item`` joins the batch ``batch_id``: its ``serve.queue`` span
        ends."""
        item.batch = batch_id
        profiling.record("serve.queue", item.t_put, time.perf_counter_ns(),
                         request=item.id, batch=batch_id)

    def _collect(self, first: "_Pending"):
        batch_id = next(self._batch_ids)
        t_first = profiling.stamp()
        self._take(first, batch_id)
        batch, rows = [first], first.x.shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch_points and not self._stop:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if rows + item.x.shape[0] > self.max_batch_points:
                self._held = item  # opens the next batch
                break
            self._take(item, batch_id)
            batch.append(item)
            rows += item.x.shape[0]
        profiling.record("serve.collect", t_first, time.perf_counter_ns(),
                         batch=batch_id, requests=len(batch), points=rows)
        return batch

    def _serve(self, group, want_var):
        """One predict for ``group``; any failure goes to every waiter of
        the group, so that one bad batch never kills the worker."""
        try:
            xs = np.concatenate([it.x for it in group], axis=0)
            with profiling.span("serve.batch", batch=group[0].batch,
                                requests=len(group), points=int(xs.shape[0])):
                mean, var, _ = self.pred.predict(xs, return_var=want_var)
            self.stats["requests"] += len(group)
            self.stats["batches"] += 1
            self.stats["batched_points"] += int(xs.shape[0])
            self.stats["largest_batch"] = max(self.stats["largest_batch"],
                                              int(xs.shape[0]))
            off = 0
            for it in group:
                t = it.x.shape[0]
                it.mean = mean[off:off + t]
                it.var = var[off:off + t] if want_var else None
                it.batched_with = len(group)
                profiling.record("serve.request", it.t_put, time.perf_counter_ns(),
                                 request=it.id, batch=it.batch)
                it.event.set()
                off += t
        except Exception as e:  # delivered to every waiter
            for it in group:
                if not it.event.is_set():
                    it.error = e
                    it.event.set()

    def _loop(self):
        while not self._stop:
            if self._held is not None:
                first, self._held = self._held, None
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            self._inflight = self._collect(first)
            for want_var in (True, False):
                group = [it for it in self._inflight if it.want_var == want_var]
                if group:
                    self._serve(group, want_var)
            self._inflight = []
        self._fail_pending()


#: default request-body cap in bytes (about 500k float literals)
MAX_BODY_BYTES = 16 << 20


def make_handler(predictor, max_body_bytes: int = MAX_BODY_BYTES):
    """An HTTP request handler class over ``predictor`` (a
    :class:`Predictor`, a :class:`MicroBatcher`, or anything with their
    ``predict`` and ``info``)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/info":
                self._send(200, predictor.info())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    self._send(413, {"error": f"request body {n} bytes exceeds "
                                              f"limit {max_body_bytes}"})
                    return
                req = json.loads(self.rfile.read(n))
                want_var = bool(req.get("variance", True))
                mean, var, dt = predictor.predict(np.asarray(req["x"]),
                                                  return_var=want_var)
                out = {"mean": mean.tolist(), "latency_s": dt}
                if want_var:
                    out["var"] = var.tolist()
                self._send(200, out)
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # device or runtime errors
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(predictor, host: str = "127.0.0.1", port: int = 8000,
          max_body_bytes: int = MAX_BODY_BYTES):
    """A threading HTTP server over ``predictor``; call ``serve_forever``."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer((host, port),
                               make_handler(predictor, max_body_bytes))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="npz file from checkpoint.save (the port's or the "
                         "JAX package's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-body-bytes", type=int, default=MAX_BODY_BYTES)
    ap.add_argument("--no-batching", action="store_true",
                    help="serialize requests instead of micro-batching them")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="micro-batch collection window")
    ap.add_argument("--request-timeout-s", type=float, default=600.0,
                    help="bound on a coalesced request's wait (HTTP 504)")
    ap.add_argument("--max-batch-points", type=int, default=1024,
                    help="cap on the rows of one coalesced batch")
    args = ap.parse_args(argv)

    from . import checkpoint

    model = checkpoint.load(args.checkpoint, device=args.device)
    pred = Predictor(model)
    if not args.no_batching:
        pred = MicroBatcher(pred, max_wait_ms=args.batch_window_ms,
                            request_timeout_s=args.request_timeout_s,
                            max_batch_points=args.max_batch_points)
    server = serve(pred, args.host, args.port, args.max_body_bytes)
    print(f"serving {type(model).__name__} on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
