"""The port's other model families against the JAX package, in float64 on
the CPU, on toy trees: the PoE / gPoE / rBCM fits and fusions, kernel-
mixture leaves (IsoSE, ArdSE and IsoLinear; fit, predict, a tied training
gradient and a fine-tune through the sparse ``MixtureOverlap``), and the
4-D ArdSE workflow of BASELINE config 5 (warm start on a subsample model,
light fit, one bucketed fine-tune iteration, routed predict). Also the
float64 NumPy oracles and the fusion replica that ``chip_smoke.py``
phases 13-15 hold the card to, against ``bench.py``'s and the packages'.

Each JAX model is built and run once per module; torch runs on one thread.
"""
import functools
import importlib

import numpy as np
import optax
import pytest
import torch

import bench
import chip_smoke
import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu import infer as jinfer
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch import infer as tinfer
from deepstructuredmixtures_tpu_torch.ops import potrf

from .session_refs import once
from .torch_threads import one_torch_thread  # noqa: F401

jtrain = importlib.import_module("deepstructuredmixtures_tpu.train")
ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")

RTOL = 1e-10
XT = np.linspace(-0.05, 1.05, 60).reshape(-1, 1)
# the families' data: bench.make_data's draw at a toy N
X, Y = chip_smoke.make_data(1200)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


def _tuned(model):
    """The fine-tune's candidates: the first and the last leaf (every leaf
    would cost both packages seconds per candidate here)."""
    return [0, model.num_leaves - 1]


# ---------------------------------------------------------------------------
# PoE / gPoE / rBCM
# ---------------------------------------------------------------------------

def _poe_pair(kind, dtype=None):
    kw = dict(K=4, M=30, log_noise=-1.0, seed=0, do_fit=False)
    jm = (dsm.build_bcm(X, Y, kernel=dsm.IsoSE(0.0, 0.0), **kw) if kind == "rbcm"
          else dsm.build_poe(X, Y, generalized=kind == "gpoe",
                             kernel=dsm.IsoSE(0.0, 0.0), **kw))
    tm = chip_smoke.poe_model(kind, X, Y, dtype or torch.float64, "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def poe_runs():
    """Per kind: JAX's and the port's ``fit_naive`` → ``predict``, leaf
    mlls and leaf moments at every test point."""
    out = {}
    for kind in ("poe", "gpoe", "rbcm"):
        jm, tm = _poe_pair(kind)
        jm.fit_naive()
        tm.fit_naive()
        jmu, jvar = jm._leaf_predict_all(jm._as_test(XT))
        tmu, tvar = tm._leaf_predict_all(tm._as_test(XT))
        out[kind] = dict(jm=jm, tm=tm, jpred=jm.predict(XT), tpred=tm.predict(XT),
                         jleaf=(jmu, jvar), tleaf=(tmu, tvar))
    return out


@pytest.mark.parametrize("kind", ["poe", "gpoe", "rbcm"])
def test_poe_family_fit_naive_and_fusion_match_jax(poe_runs, kind):
    """``fit_naive`` keeps the full store; leaf mlls, every leaf's moments
    at every test point and the fused moments are JAX's; the fusion equals
    its float64 replica on the port's own leaf moments."""
    r = poe_runs[kind]
    jm, tm = r["jm"], r["tm"]
    assert tm.posterior is not None and type(tm).__name__ == type(jm).__name__
    _close(tm.leaf_mlls(), jm.leaf_mlls())
    for t, j in zip(r["tleaf"], r["jleaf"]):
        _close(t, j)
    for t, j in zip(r["tpred"], r["jpred"]):
        _close(t, j)
    prior = chip_smoke._rbcm_prior(tm, XT.shape[0]) if kind == "rbcm" else None
    rep = chip_smoke.fusion_replica(kind, *(_np(a) for a in r["tleaf"]),
                                    tm.plan.root_child_id, prior)
    for t, p in zip(r["tpred"], rep):
        _close(t, p, rtol=1e-12, atol=1e-14)


def test_fusion_replica_matches_both_packages_fusions(poe_runs):
    """The replica against ``infer.predict_poe`` / ``predict_gpoe`` /
    ``predict_rbcm`` of both packages on the same leaf moments."""
    r = poe_runs["rbcm"]
    tm = r["tm"]
    mu, var = (_np(a) for a in r["tleaf"])
    prior = chip_smoke._rbcm_prior(tm, XT.shape[0])
    calls = {
        "poe": (lambda: jinfer.predict_poe(mu, var),
                lambda: tinfer.predict_poe(torch.as_tensor(mu), torch.as_tensor(var))),
        "gpoe": (lambda: jinfer.predict_gpoe(tm.plan, mu, var),
                 lambda: tinfer.predict_gpoe(tm.plan, torch.as_tensor(mu),
                                             torch.as_tensor(var))),
        "rbcm": (lambda: jinfer.predict_rbcm(tm.plan, mu, var, prior),
                 lambda: tinfer.predict_rbcm(tm.plan, torch.as_tensor(mu),
                                             torch.as_tensor(var),
                                             torch.as_tensor(prior))),
    }
    for kind, (jcall, tcall) in calls.items():
        rep = chip_smoke.fusion_replica(kind, mu, var, tm.plan.root_child_id,
                                        prior)
        for a, b, p in zip(jcall(), tcall(), rep):
            _close(a, p, rtol=1e-12, atol=1e-14)
            _close(b, p, rtol=1e-12, atol=1e-14)


def test_rbcm_float32_fusion_matches_float64_replica():
    """A float32 rBCM fuses its leaf moments in float64, prior included:
    within ``chip_smoke.FUSION_TOL`` of the replica. With the prior in
    float32, as the JAX package computes it, the mean moved 4.7e-10 (N=3000)
    and missed the 1e-10 gate."""
    _, tm = _poe_pair("rbcm", torch.float32)
    tm.fit_naive()
    xt = np.linspace(-0.05, 1.05, 400).reshape(-1, 1)
    mean, var = tm.predict(xt)
    mu, v = (_np(a).astype(np.float64)
             for a in tm._leaf_predict_all(tm._as_test(xt)))
    rep = chip_smoke.fusion_replica("rbcm", mu, v, tm.plan.root_child_id,
                                    chip_smoke._rbcm_prior(tm, xt.shape[0]))
    errs = chip_smoke._moment_errors(mean, var, *rep)
    assert errs["mean_abs"] <= chip_smoke.FUSION_TOL["mean_abs"], errs
    assert errs["var_rel"] <= chip_smoke.FUSION_TOL["var_rel"], errs


# ---------------------------------------------------------------------------
# The float64 NumPy oracles of the phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["iso_se", "ard_se", "iso_linear", "ard_linear"])
def test_np_gram_matches_bench(kind):
    rng = np.random.default_rng(5)
    x1, x2 = rng.uniform(0, 1, (9, 3)), rng.uniform(0, 1, (7, 3))
    logl = np.array([0.1, -0.3, 0.2])[:1 if kind.startswith("iso") else 3]
    np.testing.assert_array_equal(chip_smoke.np_gram(kind, logl, 0.3, x1, x2),
                                  bench._np_gram_general(kind, logl, 0.3, x1, x2))
    diag = np.diagonal(chip_smoke.np_gram(kind, logl, 0.3, x1, x1))
    np.testing.assert_allclose(chip_smoke.np_gram_diag(kind, logl, 0.3, x1),
                               diag, rtol=1e-14)


def test_oracle_leaf_matches_bench_and_jax(poe_runs):
    """``oracle_leaf``: the mll and moments of ``bench.py``'s oracles, and
    the JAX model's own leaf mlls and moments, on the sampled leaves."""
    r = poe_runs["poe"]
    jm = r["jm"]
    theta = np.asarray(jm.theta)
    sizes = np.array([o.size for o in jm.plan.leaf_obs])
    picks = chip_smoke._oracle_picks(sizes, small=2)
    assert len(picks) >= 3
    jmll = np.asarray(jm.leaf_mlls())
    jmu, jvar = (np.asarray(a) for a in r["jleaf"])
    for l in picks:
        mll, mu, var = chip_smoke.oracle_leaf(X, Y, jm.plan, jm.layout, theta,
                                              l, XT)
        ref = bench._cpu_leaf_moments_f64(X, Y, jm.plan, theta, l, XT)
        np.testing.assert_allclose([mll, *mu, *var], np.concatenate(
            [[ref[0]], ref[1], ref[2]]), rtol=1e-12)
        np.testing.assert_allclose(chip_smoke.oracle_leaf(
            X, Y, jm.plan, jm.layout, theta, l), bench._cpu_leaf_mll_general(
                X, Y, jm.plan, jm.layout, theta, l), rtol=1e-12)
        np.testing.assert_allclose([mll, *mu, *var],
                                   [jmll[l], *jmu[l], *jvar[l]], rtol=RTOL)


# ---------------------------------------------------------------------------
# Kernel-mixture leaves
# ---------------------------------------------------------------------------

#: the phase's mixture on 300 of the toy points (V=2, K=2, M=40), both
#: packages with the sparse ``MixtureOverlap``
MIXTURE_KW = dict(V=2, K=2, M=40, log_noise=-1.0, seed=0, do_fit=False,
                  overlap_format="sparse")


def mixture_port():
    return tdsm.build_dsmgp(X[::4], Y[::4], kernel=chip_smoke.mixture_kernels(),
                            device="cpu", **MIXTURE_KW)


def mixture_jax_refs():
    """JAX's mixture: light fit → update → predict; the tied value and
    gradient; one bucketed fine-tune iteration (sparse pair list) and its
    per-leaf hypers. Shared by ``tests/test_torch_objective.py`` through
    ``session_refs.once(..., "mixture_jax", ...)``."""
    jm = dsm.build_dsmgp(X[::4], Y[::4], kernel=[
        dsm.IsoSE(0.0, 0.0), dsm.ArdSE([0.0], 0.0), dsm.IsoLinear(0.0)],
        **MIXTURE_KW)
    jm.fit(store="light")
    jz = jm.update()
    mean, var = jm.predict(XT)
    vg = jtrain.make_value_and_grad_bucketed(jm.layout, jm.plan, jm.bucket_batches,
                                             jm.bucket_spec.leaf_ids)
    jv, jg = vg(jm.theta)
    jhist = dsm.finetune(jm, optax.adam(1e-2), iterations=1, lam=1e-9,
                         bucketed=True, sparse=True, leaves=_tuned(jm),
                         progress=False)
    return dict(z=jz, mean=mean, var=var, v=jv, g=jg, hist=jhist,
                theta=jm.theta)


@pytest.fixture(scope="module")
def mixture_runs(tmp_path_factory):
    return once(tmp_path_factory, "mixture_jax", mixture_jax_refs)


def test_mixture_fit_predict_train_and_finetune_match_jax(mixture_runs):
    r = mixture_runs
    tm = mixture_port()
    assert isinstance(tm.plan.overlap, tdsm.plan.MixtureOverlap)
    assert tm.layout.kinds == ("iso_se", "ard_se", "iso_linear")
    tm.fit(store="light")
    _close(tm.update(), r["z"])
    for t, j in zip(tm.predict(XT), (r["mean"], r["var"])):
        _close(t, j)
    vg = ttrain.make_value_and_grad_bucketed(tm.layout, tm.plan,
                                             tm.bucket_batches,
                                             tm.bucket_spec.leaf_ids)
    v, g = vg(tm.theta)
    _close(v, r["v"])
    _close(g, r["g"])
    hist = tdsm.finetune(tm, _adam(1e-2), iterations=1, lam=1e-9, bucketed=True,
                         sparse=True, leaves=_tuned(tm), progress=False)
    _close(hist, r["hist"])
    _close(tm.theta, r["theta"])


@pytest.mark.parametrize("kernels", ["mixture", "iso_se"])
def test_streamed_route_off_iso_se_is_the_hybrid_stores(monkeypatch, kernels):
    """Where the card streams a float32 bucket above nmax 1024 (here every
    float32 bucket, the blocked kernel's plain version in the kernel's
    place), every kernel set factors with the blocked kernel and solves in
    float64 (``fit._kept_recipe``; cuSOLVER's float32 factor missed the
    mll of IsoLinear and ArdSE leaves by 21-75% on an H100, and of the
    IsoSE leaves of the depth-4 trees at N=500k and N=1M by up to 7.8e-3),
    and stays within the float32 bounds of the float64 run."""
    calls = []

    def counting(a):
        calls.append(tuple(a.shape))
        return potrf.blocked_cholesky_reference(a)

    monkeypatch.setattr(potrf, "supported",
                        lambda nmax, dtype, device: dtype == torch.float32)
    monkeypatch.setattr(potrf, "blocked_cholesky", counting)
    kern = (chip_smoke.mixture_kernels() if kernels == "mixture"
            else tdsm.IsoSE(0.0, 0.0))
    runs = {}
    for dt in (torch.float32, torch.float64):
        m = tdsm.build_dsmgp(X, Y, V=2, K=2, M=60, kernel=kern, log_noise=-1.0,
                             seed=0, device="cpu", dtype=dt, do_fit=False,
                             overlap=False)
        m.fit(store="light")
        runs[dt] = {"z": m.update(), "preds": {1: m.predict(XT)}}
        if dt == torch.float32:
            assert all(tfit._kept_recipe(b) for b in m.bucket_batches)
            # one factor per leaf chunk in the fit and again in the predict
            chunks = sum(-(-b.num_leaves // tfit._bucket_chunk(
                b.nmax, b.num_leaves, dt)) for b in m.bucket_batches)
            assert len(calls) == 2 * chunks
    assert len(calls) == 2 * chunks
    errs = chip_smoke.slice_errors(runs[torch.float32], runs[torch.float64],
                                   sizes=(1,))
    for key, tol in chip_smoke.SLICE_TOL.items():
        assert errs[key] <= tol, errs


def test_mixture_hybrid_store_matches_light(mixture_runs):
    """The phase's N=20k path on the toy tree: the hybrid store (every
    bucket cached) predicts what the light store predicts."""
    tm = mixture_port()
    tm.fit(store="hybrid")
    assert all(f is not None for f in tm._bucket_factors)
    _close(tm.update(), mixture_runs["z"])
    for t, j in zip(tm.predict(XT), (mixture_runs["mean"], mixture_runs["var"])):
        _close(t, j)


# ---------------------------------------------------------------------------
# BASELINE config 5: additive ArdSE on 4-D data
# ---------------------------------------------------------------------------

#: config 5's data at a toy size
CONFIG5_TOY = chip_smoke.config5_data(n=500, sub=200, t=40)


def _config5(pkg, x, y, device=None, **kw):
    kernel = pkg.ArdSE([0.0] * x.shape[1], 0.0)
    extra = {"device": device} if device else {}
    return pkg.build_dsmgp(x, y, M=30, kernel=kernel, log_noise=-1.0,
                           do_fit=False, **kw, **extra)


@pytest.fixture(scope="module")
def config5_runs(tmp_path_factory):
    return once(tmp_path_factory, "config5_jax", _config5_jax_refs)


def _config5_jax_refs():
    """JAX's config-5 workflow on a toy tree: a 2-iteration warm start
    (Adam 5e-2) on the subsample model, the hypers carried across trees,
    light fit → update → predict, one bucketed fine-tune iteration (Adam
    1e-2, sparse pair list) and predict again."""
    x, y, idx, xt = CONFIG5_TOY
    jm = _config5(dsm, x, y, V=2, K=2, seed=0)
    jsub = _config5(dsm, x[idx], y[idx], V=2, K=2, seed=1)
    whist = dsm.train(jsub, optax.adam(5e-2), iterations=2, lam=1e-9,
                      randinit=False, progress=False)
    jm.set_params(jsub.get_params())
    jm.fit(store="light")
    z = jm.update()
    pred = jm.predict(xt)
    hist = dsm.finetune(jm, optax.adam(1e-2), iterations=1, lam=1e-9,
                        bucketed=True, sparse=True, leaves=_tuned(jm),
                        progress=False)
    (mean, var), (mean_ft, var_ft) = pred, jm.predict(xt)
    return dict(whist=whist, warm=jsub.get_params(), z=z, mean=mean, var=var,
                hist=hist, theta=jm.theta, mean_ft=mean_ft, var_ft=var_ft)


def test_config5_workflow_matches_jax(config5_runs):
    r = config5_runs
    x, y, idx, xt = CONFIG5_TOY
    tm = _config5(tdsm, x, y, device="cpu", V=2, K=2, seed=0)
    tsub = _config5(tdsm, x[idx], y[idx], device="cpu", V=2, K=2, seed=1)
    whist = tdsm.train(tsub, _adam(5e-2), iterations=2, lam=1e-9,
                       randinit=False, progress=False)
    _close(whist, r["whist"])
    _close(tsub.get_params(), r["warm"])
    tm.set_params(tsub.get_params())
    np.testing.assert_array_equal(tm.get_params(), tsub.get_params())
    tm.fit(store="light")
    _close(tm.update(), r["z"])
    for t, j in zip(tm.predict(xt), (r["mean"], r["var"])):
        _close(t, j)
    hist = tdsm.finetune(tm, _adam(1e-2), iterations=1, lam=1e-9, bucketed=True,
                         sparse=True, leaves=_tuned(tm), progress=False)
    _close(hist, r["hist"])
    _close(tm.theta, r["theta"])
    mean, var = tm.predict(xt)
    for t, j in zip((mean, var), (r["mean_ft"], r["var_ft"])):
        _close(t, j)
    assert torch.isfinite(mean).all() and (var > 0).all()


def test_config5_data_follows_bench_draw_order():
    """``config5_data`` draws x, y, the subsample and the test points from
    one seed-1 generator in ``bench.py``'s order."""
    x, y, idx, xt = chip_smoke.config5_data(n=300, sub=40, t=7)
    rng = np.random.default_rng(1)
    x_ref = rng.uniform(0.0, 1.0, (300, 4))
    rng.standard_normal(300)
    idx_ref = np.sort(rng.choice(300, 40, replace=False))
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(idx, idx_ref)
    np.testing.assert_array_equal(xt, rng.uniform(0.0, 1.0, (7, 4)))
    assert y.shape == (300,) and np.isfinite(y).all()
