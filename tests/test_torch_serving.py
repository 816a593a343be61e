"""The port's factor-cached serving path against the JAX package, in
float64 on the CPU: the hybrid store (partial and full budget), the alpha
cache with mean-only prediction, the PoE/gPoE/rBCM fusions and checkpoints
written by the JAX package, all at 1e-10 relative on the N=2000 headline
tree; then the port's ``Predictor``, ``MicroBatcher`` and HTTP handler on
a small model.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
from deepstructuredmixtures_tpu import checkpoint as jax_checkpoint

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import checkpoint, convert
from deepstructuredmixtures_tpu_torch.serve import (
    MicroBatcher,
    Predictor,
    _Pending,
    serve,
)

from .test_torch_slice import RTOL, _data

COMMON = dict(M=30, log_noise=-1.0, seed=0, do_fit=False)
XT = np.linspace(-0.05, 1.05, 400).reshape(-1, 1)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, jax, atol=1e-12):
    np.testing.assert_allclose(_np(port), _np(jax), rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def pair():
    x, y = _data()
    jm = dsm.build_dsmgp(x, y, V=3, K=4, kernel=dsm.IsoSE(0.0, 0.0),
                         overlap=False, **COMMON)
    tm = tdsm.build_dsmgp(x, y, V=3, K=4, kernel=tdsm.IsoSE(0.0, 0.0),
                          device="cpu", **COMMON)
    convert.from_jax_arrays(tm, np.asarray(jm.theta))
    sizes = [b.num_leaves * b.nmax * b.nmax * 8 for b in tm.bucket_batches]
    big = max(range(len(sizes)), key=lambda k: tm.bucket_batches[k].nmax)
    return jm, tm, sizes[big] + min(sizes) // 2


@pytest.mark.parametrize("budget", ["partial", "full"])
def test_hybrid_store_matches_jax(pair, budget):
    jm, tm, partial = pair
    B = partial if budget == "partial" else None
    jm.fit(store="hybrid", factor_budget=B)
    tm.fit(store="hybrid", factor_budget=B)
    flags = tuple(f is not None for f in tm._bucket_factors)
    assert flags == tuple(f is not None for f in jm._bucket_factors)
    assert all(flags) == (budget == "full") and any(flags)
    assert tm.last_fit_diagnostics == {
        k: jm.last_fit_diagnostics[k] for k in ("cached_buckets", "cached_bytes")}
    _close(tm.leaf_mlls(), jm.leaf_mlls())
    for a_t, a_j in zip(tm._alpha_cache, jm._alpha_cache):
        _close(a_t, a_j)
    for f_t, f_j in zip(tm._bucket_factors, jm._bucket_factors):
        if f_t is not None:
            _close(f_t[0], f_j[0])
    _close(tm.update(), jm.update())
    for p, j in zip(tm.predict(XT), jm.predict(XT)):
        _close(p, j)


def test_alpha_cache_mean_only_matches_jax(pair):
    jm, tm, _ = pair
    jm.fit(store="light", cache_alpha=True)
    tm.fit(store="light", cache_alpha=True)
    assert tm._bucket_factors is None and tm._alpha_cache is not None
    for a_t, a_j in zip(tm._alpha_cache, jm._alpha_cache):
        _close(a_t, a_j)
    _close(tm.update(), jm.update())
    mean = tm.predict(XT, return_var=False)
    assert mean.shape == (len(XT),)
    _close(mean, jm.predict(XT, return_var=False))
    tm.set_params(tm.get_params())
    assert tm._alpha_cache is None and tm._leaf_mll is None


@pytest.mark.parametrize("kind", ["poe", "gpoe", "rbcm"])
def test_poe_family_and_checkpoint_match_jax(kind, tmp_path):
    x, y = _data()
    kw = dict(M=30, K=4, log_noise=-1.0, seed=0)
    if kind == "rbcm":
        jm = dsm.build_bcm(x, y, kernel=dsm.IsoSE(0.0, 0.0), **kw)
        tm = tdsm.build_bcm(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                            **kw)
    else:
        g = kind == "gpoe"
        jm = dsm.build_poe(x, y, generalized=g, kernel=dsm.IsoSE(0.0, 0.0), **kw)
        tm = tdsm.build_poe(x, y, generalized=g, kernel=tdsm.IsoSE(0.0, 0.0),
                            device="cpu", **kw)
    assert type(tm).__name__ == type(jm).__name__
    ref = jm.predict(XT)
    tm.fit(store="light")
    for p, j in zip(tm.predict(XT), ref):  # streamed
        _close(p, j)
    tm.fit(store="hybrid")
    for p, j in zip(tm.predict(XT), ref):  # from the cached factors
        _close(p, j)
    path = str(tmp_path / f"{kind}.npz")
    jax_checkpoint.save(jm, path)
    loaded = checkpoint.load(path, device="cpu")
    assert type(loaded) is type(tm)
    loaded.fit(store="light")
    for p, j in zip(loaded.predict(XT), ref):  # streamed
        _close(p, j)


def test_jax_checkpoint_loads_in_port_and_round_trips(pair, tmp_path):
    jm, _, _ = pair
    jm.fit(store="light")
    jm.update()
    ref = jm.predict(XT)
    path = str(tmp_path / "dsmgp.npz")
    jax_checkpoint.save(jm, path)
    tm = checkpoint.load(path, device="cpu")
    assert tm.dtype == torch.float64 and tm.plan.pad_multiple == jm.plan.pad_multiple
    for p, j in zip(tm.predict(XT), ref):
        _close(p, j)
    path2 = str(tmp_path / "port.npz")
    checkpoint.save(tm, path2)
    again = checkpoint.load(path2, device="cpu")
    np.testing.assert_array_equal(again.theta.numpy(), tm.theta.numpy())
    np.testing.assert_array_equal(again.logweights.numpy(), tm.logweights.numpy())
    for p, j in zip(again.predict(XT), ref):
        _close(p, j)


# -- serving on the port ------------------------------------------------------


def _model():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 150)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 5) + 0.1 * rng.standard_normal(150)
    return tdsm.build_dsmgp(x, y, V=2, K=2, M=20, kernel=tdsm.IsoSE(0.0, 0.0),
                            log_noise=-1.0, seed=1, device="cpu")


def _direct(m, x):
    mean, var = m.predict(x)
    return mean.numpy(), var.numpy()


def test_predictor_caches_factors_and_chunks_exactly():
    m = _model()
    m.fit(store="light")  # the build fitted the full store, which 'auto' keeps
    p = Predictor(m, chunk_points=16)
    assert all(f is not None for f in m._bucket_factors)
    xt = np.linspace(0, 1, 53).reshape(-1, 1)  # 4 chunks: 16+16+16+5
    mean, var, dt = p.predict(xt)
    mean_d, var_d = _direct(m, xt)
    np.testing.assert_allclose(mean, mean_d, rtol=0, atol=1e-12)
    np.testing.assert_allclose(var, var_d, rtol=0, atol=1e-12)
    assert dt > 0 and p.info()["class"] == "DSMGP"
    for bad in (np.full((3, 1), np.nan), np.zeros((3, 2))):
        with pytest.raises(ValueError):
            p.predict(bad)
    Predictor(m, store="full")  # the monolithic store, now ported
    assert m.posterior is not None and m._bucket_factors is None
    full_mean, full_var, _ = p.predict(xt)
    np.testing.assert_allclose(full_mean, mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(full_var, var, rtol=0, atol=1e-12)


def test_predictor_auto_keeps_full_store():
    """A model that holds the full store keeps its posterior under
    ``Predictor(store='auto')``, as in the JAX package; a light one is
    refitted with the hybrid store."""
    m = _model()
    post = m.posterior
    assert post is not None and m._bucket_factors is None
    xt = np.linspace(0, 1, 40).reshape(-1, 1)
    mean, var, _ = Predictor(m, chunk_points=16).predict(xt)
    assert m.posterior is post and m._bucket_factors is None
    np.testing.assert_allclose(mean, _direct(m, xt)[0], rtol=0, atol=1e-12)
    m.fit(store="light")
    Predictor(m)
    assert m.posterior is None and all(f is not None for f in m._bucket_factors)
    hmean, hvar, _ = Predictor(m).predict(xt)
    np.testing.assert_allclose(hmean, mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(hvar, var, rtol=0, atol=1e-12)


def test_predictor_light_store_mean_only():
    m = _model()
    m.fit(store="light")
    p = Predictor(m, store="light", chunk_points=16)
    assert m._bucket_factors is None and p._mean_only
    xt = np.linspace(0, 1, 40).reshape(-1, 1)
    mean, var, _ = p.predict(xt, return_var=False)
    assert var is None
    np.testing.assert_allclose(mean, _direct(m, xt)[0], rtol=0, atol=1e-12)
    # a model class without return_var (PoE) drops the variance instead
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 150))
    poe = tdsm.build_poe(x, np.sin(5 * x), M=20, device="cpu", seed=1)
    pp = Predictor(poe)
    assert not pp._mean_only
    mean, var, _ = pp.predict(xt, return_var=False)
    assert var is None
    np.testing.assert_allclose(mean, poe.predict(xt)[0].numpy(), atol=1e-12)


def _post(port, payload, raw=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=raw or json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _http_code(port, payload, raw=None):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, payload, raw)
    assert "error" in json.loads(e.value.read())
    return e.value.code


def _running(pred, **kw):
    server = serve(pred, port=0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_round_trip_and_errors():
    m = _model()
    p = Predictor(m)
    server, port = _running(p, max_body_bytes=4096)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read())["ok"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                    timeout=10) as r:
            info = json.loads(r.read())
        assert info["class"] == "DSMGP" and info["dim"] == 1
        assert info["dtype"] == "float64"
        xt = np.linspace(0, 1, 9).reshape(-1, 1)
        out = _post(port, {"x": xt.tolist()})
        mean_d, var_d = _direct(m, xt)
        np.testing.assert_allclose(out["mean"], mean_d, atol=1e-12)
        np.testing.assert_allclose(out["var"], var_d, atol=1e-12)
        out = _post(port, {"x": xt.tolist(), "variance": False})
        assert "var" not in out
        np.testing.assert_allclose(out["mean"], mean_d, atol=1e-12)
        assert _http_code(port, {"x": [[1, 2, 3]]}) == 400
        assert _http_code(port, {"y": [[0.5]]}) == 400
        assert _http_code(port, None, json.dumps({"x": [[0.5]] * 2000})
                          .encode()) == 413
    finally:
        server.shutdown()


def test_http_batched_errors_are_structured():
    class Timesout:
        def predict(self, x, return_var=True):
            raise TimeoutError("prediction not served within 0.1 s")

        def info(self):
            return {}

    class Explodes(Timesout):
        def predict(self, x, return_var=True):
            raise RuntimeError("device lost")

    for impl, code in ((Timesout(), 504), (Explodes(), 500)):
        server, port = _running(impl)
        try:
            assert _http_code(port, {"x": [[0.5]]}) == code
        finally:
            server.shutdown()


def _concurrent(mb, xs, want_var=None):
    results = [None] * len(xs)
    barrier = threading.Barrier(len(xs))

    def worker(i):
        barrier.wait()
        rv = True if want_var is None else want_var[i]
        results[i] = mb.predict(xs[i], return_var=rv)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def test_microbatcher_coalesces_exactly():
    m = _model()
    mb = MicroBatcher(Predictor(m), max_wait_ms=300.0)
    try:
        rng = np.random.default_rng(7)
        xs = [np.sort(rng.uniform(0, 1, 5)).reshape(-1, 1) for _ in range(6)]
        want = [True, True, True, True, False, False]
        results = _concurrent(mb, xs, want)
        for x, w, (mean, var, dt) in zip(xs, want, results):
            mean_d, var_d = _direct(m, x)
            np.testing.assert_allclose(mean, mean_d, atol=1e-12)
            if w:
                np.testing.assert_allclose(var, var_d, atol=1e-12)
            else:
                assert var is None
            assert dt > 0
        assert mb.stats["requests"] == 6
        assert 2 <= mb.stats["batches"] < 6  # variance and mean run apart
        with pytest.raises(ValueError):  # raises in its caller, pre-queue
            mb.predict(np.zeros((3, 2)))
    finally:
        mb.close()


def test_microbatcher_strict_row_cap():
    m = _model()
    mb = MicroBatcher(Predictor(m), max_wait_ms=300.0, max_batch_points=12)
    try:
        xs = [np.sort(np.random.default_rng(i).uniform(0, 1, 5)).reshape(-1, 1)
              for i in range(4)]
        results = _concurrent(mb, xs)
        for x, (mean, _, _) in zip(xs, results):
            np.testing.assert_allclose(mean, _direct(m, x)[0], atol=1e-12)
        # 2 x 5 rows fit the cap of 12, 3 x 5 do not
        assert mb.stats["batches"] >= 2
        assert mb.stats["largest_batch"] <= 12
        assert mb.stats["batched_points"] == 20
    finally:
        mb.close()


def test_microbatcher_close_fails_queued_and_inflight():
    class Stuck:
        def __init__(self):
            self.entered = threading.Event()
            self.release = threading.Event()

        def _validate(self, x):
            return np.asarray(x, dtype=np.float64).reshape(-1, 1)

        def predict(self, x, return_var=True):
            self.entered.set()
            self.release.wait(timeout=30)
            return np.zeros(len(x)), np.zeros(len(x)), 0.0

    stuck = Stuck()
    mb = MicroBatcher(stuck, max_wait_ms=1.0, request_timeout_s=60.0)
    errors = []

    def request():
        try:
            mb.predict(np.zeros(2))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=request)
    t.start()
    assert stuck.entered.wait(timeout=10)  # the batch is in flight
    queued = _Pending(np.zeros((2, 1)), True)
    mb._q.put(queued)
    t0 = time.perf_counter()
    mb.close(timeout=0.2)
    t.join(timeout=10)
    assert time.perf_counter() - t0 < 5
    assert len(errors) == 1 and "closed" in str(errors[0])
    assert queued.event.is_set() and isinstance(queued.error, RuntimeError)
    stuck.release.set()
