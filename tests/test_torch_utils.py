"""The port's host-side utilities against the JAX package's, on the CPU:
introspection (``blockmatrix``, ``blockindecies``, ``observation_counts``,
``get_log_noise``, ``left_gp`` / ``right_gp``, ``rand_init``), metrics,
``nonstationary``, plotting and ``kernelid_function``, ``PhaseTimer`` and
``trace``, ``SPNPlan.path_matrix``, ``native.intersect_counts`` and the
``prediction`` alias. The checks of ``tests/test_introspect.py``,
``tests/test_metrics_datasets.py`` and the plotting half of
``tests/test_checkpoint_plot.py``, each held against the JAX function on
the same model (same data, seed and hypers, float64)."""
import os

import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu.plotting import kernelid_function as j_kernelid
from deepstructuredmixtures_tpu.utils import native as jnative
from deepstructuredmixtures_tpu_torch import plotting as tplot
from deepstructuredmixtures_tpu_torch.utils import native as tnative
from deepstructuredmixtures_tpu_torch.utils.profiling import PhaseTimer, trace

from .torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(0)
N = 200
X = np.sort(rng.uniform(0, 1, N)).reshape(-1, 1)
Y = np.sin(X[:, 0] * 5) + rng.normal(0, 0.1, N)
XT = np.linspace(0.1, 0.9, 23).reshape(-1, 1)
COMMON = dict(V=2, K=2, M=25, log_noise=-1.0, seed=1)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def pair():
    """The same model in both packages, fitted and updated."""
    jm = dsm.build_dsmgp(X, Y, kernel=dsm.IsoSE(0.0, 0.0), **COMMON)
    tm = tdsm.build_dsmgp(X, Y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                          **COMMON)
    jm.update()
    tm.update()
    np.testing.assert_allclose(_np(tm.logweights), _np(jm.logweights),
                               rtol=1e-10, atol=1e-12)
    return jm, tm


@pytest.fixture(scope="module")
def mixture_pair():
    """A kernel-mixture model (IsoSE + IsoLinear) in both packages."""
    kw = dict(V=2, K=2, M=40, seed=8, log_noise=-1.0)
    jm = dsm.build_dsmgp(X, Y, kernel=[dsm.IsoSE(0.0, 0.0), dsm.IsoLinear(0.0)],
                         **kw)
    tm = tdsm.build_dsmgp(X, Y, kernel=[tdsm.IsoSE(0.0, 0.0),
                                        tdsm.IsoLinear(0.0)], device="cpu", **kw)
    jm.update()
    tm.update()
    return jm, tm


# -- introspection ------------------------------------------------------------


@pytest.mark.parametrize("best", [False, True])
def test_blockmatrix_matches_jax(pair, best):
    jm, tm = pair
    B = tdsm.blockmatrix(tm, best=best)
    assert B.shape == (N, N)
    np.testing.assert_allclose(B, dsm.blockmatrix(jm, best=best), rtol=1e-10,
                               atol=1e-12)
    if best:
        assert set(np.unique(B)).issubset({0.0, 1.0, 2.0, 3.0, 4.0})
    else:
        assert np.allclose(B, B.T) and np.all(np.diag(B) > 0)


def test_observation_counts_and_blockindecies_match_jax(pair):
    jm, tm = pair
    P = tdsm.observation_counts(tm)
    assert P.dtype == np.int64 and not np.diag(P).any()
    np.testing.assert_array_equal(P, dsm.observation_counts(jm))
    ix = tdsm.blockindecies(tm)
    assert ix == dsm.blockindecies(jm)
    assert all(n in ix[n] for n in range(N))


def test_get_log_noise_matches_jax(pair, mixture_pair):
    for jm, tm in (pair, mixture_pair):
        ln = tdsm.get_log_noise(tm, XT)
        np.testing.assert_allclose(ln, dsm.get_log_noise(jm, XT), rtol=1e-10)
    # tied hypers + normalized mixture weights: logsumexp(pw + c) = c
    np.testing.assert_allclose(tdsm.get_log_noise(pair[1], XT), -1.0, atol=1e-10)


@pytest.mark.parametrize("side", ["left", "right"])
def test_leaf_gps_match_jax(pair, side):
    jm, tm = pair
    j = getattr(dsm, f"{side}_gp")(jm)
    t = getattr(tdsm, f"{side}_gp")(tm)
    leaf = 0 if side == "left" else tm.num_leaves - 1
    assert isinstance(t, tdsm.GaussianProcess) and t.device == tm.device
    assert t.n == j.n == tm.plan.leaf_obs[leaf].size
    logl, logsigma, lognoise = t.params()
    np.testing.assert_allclose(np.concatenate([logl, [logsigma, lognoise]]),
                               tm.get_params())
    np.testing.assert_allclose(t.mll(), j.mll(), rtol=1e-10)
    # the leaf's mll as the model computes it
    assert abs(t.mll() - float(tm.leaf_mlls()[leaf])) < 1e-9
    for p, q in zip(t.predict(XT), j.predict(XT)):
        np.testing.assert_allclose(_np(p), _np(q), rtol=1e-10, atol=1e-12)


def test_rand_init_matches_jax():
    jm = dsm.build_dsmgp(X, Y, kernel=dsm.IsoSE(0.0, 0.0), **COMMON)
    tm = tdsm.build_dsmgp(X, Y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                          **COMMON)
    before = tm.get_params().copy()
    dsm.rand_init(jm, seed=0)
    assert tdsm.rand_init(tm, seed=0) is tm
    assert not np.allclose(tm.get_params(), before)
    np.testing.assert_array_equal(tm.get_params(), _np(jm.theta))
    np.testing.assert_allclose(tm.mll(), jm.mll(), rtol=1e-10)


# -- metrics and datasets ------------------------------------------------------


@pytest.mark.parametrize("name", ["mse", "sse", "mae", "sae"])
def test_metrics_match_jax(name):
    r = np.random.default_rng(0)
    y = r.normal(size=100)
    p = y + r.normal(0, 0.3, 100)
    assert getattr(tdsm, name)(y, p) == getattr(dsm, name)(y, p)


def test_nlpd_matches_jax_and_scipy():
    from scipy import stats as sps

    r = np.random.default_rng(1)
    y = r.normal(size=50)
    mu = y + r.normal(0, 0.1, 50)
    var = r.uniform(0.5, 2.0, 50)
    assert tdsm.nlpd(y, mu, var) == dsm.nlpd(y, mu, var)
    want = -np.mean(sps.norm.logpdf(y, mu, np.sqrt(var)))
    assert abs(tdsm.nlpd(y, mu, var) - want) < 1e-12


def test_nonstationary_matches_jax():
    for a, b in zip(tdsm.nonstationary(500, seed=0),
                    dsm.nonstationary(500, seed=0)):
        np.testing.assert_array_equal(a, b)
    x, _, noise = tdsm.nonstationary(500, seed=0)
    assert x.shape == (500, 1) and abs(x.std(ddof=1) - 10.0) < 1e-8
    assert noise.max() / noise.min() > 2.0


# -- plotting ------------------------------------------------------------------


def test_plot_model_and_gp(tmp_path):
    pytest.importorskip("matplotlib")
    m = tdsm.build_dsmgp(X, Y, V=2, K=2, M=30, seed=6, log_noise=-1.0,
                         device="cpu")
    out = str(tmp_path / "model.png")
    tplot.plot_model(m, show_splits=True, path=out)
    assert os.path.getsize(out) > 1000
    gp = tdsm.GaussianProcess(X, Y, kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0,
                              device="cpu")
    out2 = str(tmp_path / "gp.png")
    tplot.plot_gp(gp, path=out2)
    assert os.path.getsize(out2) > 1000


def test_plot_model_2d(tmp_path):
    pytest.importorskip("matplotlib")
    r = np.random.default_rng(7)
    X2 = r.uniform(0, 1, (150, 2))
    Y2 = np.sin(X2[:, 0] * 5) * np.cos(X2[:, 1] * 5)
    m = tdsm.build_dsmgp(X2, Y2, V=2, K=2, M=30, seed=7, log_noise=-1.0,
                         device="cpu")
    out = str(tmp_path / "model2d.png")
    tplot.plot_model(m, n_grid=100, path=out)
    assert os.path.getsize(out) > 1000


def test_kernelid_function_matches_jax(mixture_pair):
    jm, tm = mixture_pair
    kids = tdsm.kernelid_function(tm, XT)
    assert kids.shape == (len(XT),) and set(np.unique(kids)) <= {0, 1}
    np.testing.assert_array_equal(kids, j_kernelid(jm, XT))
    np.testing.assert_array_equal(tdsm.kernelid_function(tm, XT[:, 0]), kids)


# -- profiling, plan and native helpers, the alias ------------------------------


def test_phase_timer_and_trace(tmp_path):
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("a"):
            pass
    assert t.counts()["a"] == 2 and t.timings()["a"] >= 0.0
    assert "a" in t.report()
    with trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_path_matrix_matches_jax_and_sparse_gather(pair):
    from deepstructuredmixtures_tpu_torch import infer

    jm, tm = pair
    P = tm.plan.path_matrix
    np.testing.assert_array_equal(P, jm.plan.path_matrix)
    lw = np.random.default_rng(3).normal(size=tm.plan.n_sum_edges)
    np.testing.assert_allclose(
        P @ lw, _np(infer.path_logweights(tm.plan, torch.as_tensor(lw))),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(17, 301), (5, 64), (1, 7)])
def test_intersect_counts_matches_jax_and_fallback(shape, monkeypatch):
    masks = np.random.default_rng(0).random(shape) < 0.3
    want = masks.astype(np.int64) @ masks.astype(np.int64).T
    got = tnative.intersect_counts(masks)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.intersect_counts(masks))
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(tnative.intersect_counts(masks), want)


def test_prediction_alias_and_exports(pair):
    _, tm = pair
    for a, b in zip(tdsm.prediction(tm, XT), tm.predict(XT)):
        assert torch.equal(a, b)
    import deepstructuredmixtures_tpu as j

    assert set(tdsm.__all__) == set(j.__all__)
    assert all(hasattr(tdsm, n) for n in tdsm.__all__)
