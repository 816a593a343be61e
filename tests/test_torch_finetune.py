"""The port's fine-tuning against the JAX package, in float64 on the CPU:
the stop-gradient surrogate ``_weighted_root_mll``, the candidate engine
``make_finetune_vg_bucketed`` (dense and sparse pair-list backwards, the
size buckets and the monolithic batch, a diagonal-only weighting row, a
kernel mixture with its ``MixtureOverlap``), ``finetune`` (history and
per-leaf hypers on both routes, ``leaves=``, CSR D) and the PoE family
predicting after it.

The toy data of ``tests/test_train.py``; JAX's ``finetune`` runs once, its
candidate gradients come from one jitted ``_weighted_root_mll`` per model.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import convert

from .torch_threads import one_torch_thread  # noqa: F401

# the modules (each package's ``train`` attribute is the function)
jtrain = importlib.import_module("deepstructuredmixtures_tpu.train")
ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")

VALUE_TOL, GRAD_TOL, TRAJ_TOL = 1e-10, 1e-9, 1e-8

# the data of tests/test_train.py
_rng = np.random.default_rng(0)
X = np.sort(_rng.uniform(0, 1, 250)).reshape(-1, 1)
Y = np.sin(X[:, 0] * 4 * np.pi) + _rng.normal(0, 0.2, 250)
_rng4 = np.random.default_rng(3)
X4 = np.sort(_rng4.uniform(0, 1, 400)).reshape(-1, 1)
Y4 = np.sin(X4[:, 0] * 5) + 0.1 * _rng4.standard_normal(400)
MIXTURE = ((dsm.IsoSE(0.0, 0.0), dsm.IsoLinear(0.0)),
           (tdsm.IsoSE(0.0, 0.0), tdsm.IsoLinear(0.0)))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(builder="build_dsmgp", x=X, y=Y, kernels=None, tkw=None, **kw):
    """The JAX model and the port's, built alike (``do_fit=False``);
    ``tkw`` adds options of the port's build only."""
    kw.setdefault("M", 20)
    kw.setdefault("log_noise", -1.0)
    jk, tk = kernels or (dsm.IsoSE(0.0, 0.0), tdsm.IsoSE(0.0, 0.0))
    jm = getattr(dsm, builder)(x, y, kernel=jk, do_fit=False, **kw)
    tm = getattr(tdsm, builder)(x, y, kernel=tk, do_fit=False, device="cpu",
                                **kw, **(tkw or {}))
    return jm, tm


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


def _candidates(m, spread=0.3):
    """Per-leaf hypers with distinct lengthscales and the weighting rows of
    every candidate (D with unit diagonal), candidate 0 diagonal-only."""
    L = m.num_leaves
    H = np.tile(np.asarray(m.theta), (L, 1))
    H[:, 0] += np.linspace(-spread, spread, L)
    Dd = np.array(m.plan.overlap, dtype=np.float64)
    np.fill_diagonal(Dd, 1.0)
    Dd[0, 1:] = 0.0
    return H, Dd


def _jax_candidates(jm, H, Dd):
    """JAX's candidate mlls ``[C, L]`` and weighted gradients ``[C, P]``,
    candidate by candidate through its ``_weighted_root_mll`` on the
    monolithic batch (one jitted program; JAX's own tests hold its
    bucketed engine to this form at 1e-10 / 1e-9)."""
    f = jax.jit(jax.value_and_grad(
        lambda th, w: jtrain._weighted_root_mll(jm.layout, jm.plan, jm.batch,
                                                th, w), has_aux=True))
    out = [f(jnp.asarray(h), jnp.asarray(w)) for h, w in zip(H, Dd)]
    return (np.stack([np.asarray(lm) for (_, lm), _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


@pytest.fixture(scope="module")
def candidates():
    """The N=400 data with M=100 (two size buckets, 12 leaves): JAX's
    candidate mlls and gradients for the first (its row diagonal-only), a
    middle and the last leaf's candidate, and for one more hyper vector
    under graded weights."""
    jm, tm = _pair(x=X4, y=Y4, V=2, K=2, M=100, kernels=None, seed=4)
    assert len(tm.bucket_batches) == 2
    H, Dd = _candidates(jm)
    pick = np.array([0, tm.num_leaves // 2, tm.num_leaves - 1])
    theta = np.asarray(jm.theta) + np.array([-0.4, 0.1, 0.2])
    w = np.linspace(0.0, 1.0, tm.num_leaves)
    mll, g = _jax_candidates(jm, np.vstack([H[pick], theta]),
                             np.vstack([Dd[pick], w]))
    return tm, H, Dd, pick, mll[:-1], g[:-1], (theta, w, mll[-1], g[-1])


def test_weighted_root_mll_matches_jax(candidates):
    """Value, leaf mlls and the weighted gradient of the surrogate against
    JAX's; with unit weights the gradient is the root mll's own."""
    tm, (theta, w, lm, g_ref) = candidates[0], candidates[-1]
    th = torch.tensor(theta, requires_grad=True)
    troot, tlm = ttrain._weighted_root_mll(tm.layout, tm.plan, tm.batch, th,
                                           torch.as_tensor(w))
    np.testing.assert_allclose(_np(tlm), lm, rtol=VALUE_TOL)
    root = tdsm.infer.root_mll(tm.plan, tlm.detach())
    np.testing.assert_allclose(float(troot.detach()), float(root),
                               rtol=VALUE_TOL)
    troot.backward()
    np.testing.assert_allclose(_np(th.grad), g_ref, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    th1 = torch.tensor(theta, requires_grad=True)
    ones = torch.ones(tm.num_leaves, dtype=torch.float64)
    ttrain._weighted_root_mll(tm.layout, tm.plan, tm.batch, th1,
                              ones)[0].backward()
    f = ttrain.make_mll_fn(tm.layout, tm.plan, tm.batch)
    g_plain = ttrain._value_and_grad(f)(torch.as_tensor(theta))[1]
    np.testing.assert_allclose(_np(th1.grad), _np(g_plain), rtol=VALUE_TOL)


@pytest.mark.parametrize("batches", ["buckets", "monolithic"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_candidate_grads_match_jax(candidates, sparse, batches):
    """The dense backward (every pair) and the sparse pair list (nonzero
    weights only, with candidate 0's diagonal-only row), through the size
    buckets and through the monolithic batch, against JAX's engine."""
    tm, H, Dd, pick, mll_ref, g_ref, _ = candidates
    if batches == "buckets":
        bb, ids = tm.bucket_batches, tm.bucket_spec.leaf_ids
    else:
        bb, ids = [tm.batch], [np.arange(tm.num_leaves)]
    vg = ttrain.make_finetune_vg_bucketed(tm.layout, tm.plan, bb, ids,
                                          sparse=sparse, cand_map=3)
    mll, g = vg(torch.as_tensor(H), torch.as_tensor(Dd))
    np.testing.assert_allclose(_np(mll)[pick], mll_ref, rtol=VALUE_TOL)
    np.testing.assert_allclose(_np(g)[pick], g_ref, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    assert 0.0 < (Dd != 0).mean() < 1.0  # the sparse list skips pairs
    # every candidate's row is its own: each alone gives the same
    j = int(pick[1])
    mj, gj = vg(torch.as_tensor(H[j:j + 1]), torch.as_tensor(Dd[j:j + 1]))
    np.testing.assert_allclose(_np(mj)[0], _np(mll)[j], rtol=VALUE_TOL)
    np.testing.assert_allclose(_np(gj)[0], _np(g)[j], rtol=VALUE_TOL)


def test_kernel_mixture_candidates_and_finetune():
    """``[IsoSE, IsoLinear]`` leaves, the port's D a ``MixtureOverlap``
    (JAX's dense, the same rows): one ``finetune`` step (SGD, lr 1e-3) from
    the tied start unties the whole two-block vector of every leaf by its
    candidate gradient, which matches JAX's, and its value is the sum of
    the candidates' own mlls."""
    jm, tm = _pair(V=2, K=2, M=60, kernels=MIXTURE, seed=13,
                   tkw={"overlap_format": "sparse"})
    assert isinstance(tm.plan.overlap, tdsm.plan.MixtureOverlap)
    L = tm.num_leaves
    W = tm.plan.overlap.rows(np.arange(L))
    W[np.arange(L), np.arange(L)] = 1.0
    Dd = np.array(jm.plan.overlap, dtype=np.float64)
    np.fill_diagonal(Dd, 1.0)
    np.testing.assert_array_equal(W, Dd)
    theta0 = _np(tm.theta).copy()
    H0 = np.tile(theta0, (L, 1))
    tvg = ttrain.make_finetune_vg_bucketed(tm.layout, tm.plan, tm.bucket_batches,
                                           tm.bucket_spec.leaf_ids)
    mll, g = (_np(a) for a in tvg(torch.as_tensor(H0), torch.as_tensor(W)))
    pick = np.array([0, L // 2, L - 1])
    mll_ref, g_ref = _jax_candidates(jm, H0[pick], W[pick])
    np.testing.assert_allclose(mll[pick], mll_ref, rtol=VALUE_TOL)
    np.testing.assert_allclose(g[pick], g_ref, rtol=GRAD_TOL, atol=GRAD_TOL)

    hist = tdsm.finetune(tm, torch.optim.SGD, iterations=1)  # lr 1e-3
    assert tm.theta.shape == (L, tm.layout.total)
    np.testing.assert_allclose(hist, [mll.diagonal().sum()], rtol=VALUE_TOL)
    np.testing.assert_allclose(_np(tm.theta) - theta0, 1e-3 * g, rtol=1e-9,
                               atol=1e-15)


@pytest.fixture(scope="module")
def finetuned():
    """JAX's ``finetune`` (monolithic route, Adam 1e-2, 2 iterations) on the
    N=250 data with M=60 (12 leaves)."""
    jm, _ = _pair(V=2, K=2, M=60, seed=7)
    hist = dsm.finetune(jm, optax.adam(1e-2), iterations=2, lam=1e-9,
                        progress=False)
    return hist, np.asarray(jm.theta), np.asarray(jm.leaf_mlls())


@pytest.mark.parametrize("bucketed", [None, True], ids=["monolithic", "buckets"])
def test_finetune_matches_jax(finetuned, bucketed):
    """History and per-leaf hypers within 1e-8 of JAX's run on both routes
    (JAX's own test holds its two routes to each other at 1e-8); the final
    refit's leaf mlls are JAX's."""
    hist_ref, H_ref, mll_ref = finetuned
    _, tm = _pair(V=2, K=2, M=60, seed=7)
    hist = tdsm.finetune(tm, _adam(1e-2), iterations=2, lam=1e-9,
                         bucketed=bucketed, progress=False)
    assert tm.theta.shape == (tm.num_leaves, 3)
    np.testing.assert_allclose(hist, hist_ref, rtol=TRAJ_TOL)
    np.testing.assert_allclose(_np(tm.theta), H_ref, rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(_np(tm.leaf_mlls()), mll_ref, rtol=TRAJ_TOL)
    assert hist[-1] > hist[0]


def test_finetune_leaf_subset():
    """After training, ``leaves=`` tunes only those rows (the others keep
    the tied start),
    tracks the tuned leaves' own-mll sum and improves it; out-of-range and
    empty subsets raise. ``overlap=False`` and ``mesh=`` raise too."""
    _, tm = _pair(V=2, K=2, seed=32)
    tdsm.train(tm, _adam(5e-2), iterations=20, lam=1e-6, randinit=False)
    L = tm.num_leaves
    theta0 = _np(tm.theta).copy()
    pick = np.array([L - 1, 0, 0])
    hist = tdsm.finetune(tm, _adam(1e-2), iterations=6, lam=1e-9, leaves=pick)
    H = _np(tm.theta)
    untouched = np.setdiff1d(np.arange(L), pick)
    np.testing.assert_array_equal(H[untouched], np.broadcast_to(
        theta0, (untouched.size, theta0.size)))
    assert not np.allclose(H[[0, L - 1]], theta0)
    assert hist[-1] > hist[0]
    for bad in ([L], [-1], []):
        with pytest.raises(ValueError, match="leaves"):
            tdsm.finetune(tm, iterations=1, leaves=bad)
    m = tdsm.build_dsmgp(X, Y, V=2, K=2, M=20, device="cpu", seed=1,
                         do_fit=False, overlap=False)
    with pytest.raises(ValueError, match="overlap=False"):
        tdsm.finetune(m, iterations=1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdsm.finetune(tm, mesh=object())


def test_finetune_csr_overlap_equals_dense():
    """D stored as scipy CSR gives exactly the dense-D run."""
    import scipy.sparse as sp

    runs = []
    for fmt in ("dense", "sparse"):
        _, tm = _pair(V=2, K=2, M=60, seed=31, tkw={"overlap_format": fmt})
        assert sp.issparse(tm.plan.overlap) == (fmt == "sparse")
        runs.append((tdsm.finetune(tm, _adam(1e-2), iterations=2, lam=1e-9),
                     _np(tm.theta)))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("builder,kw", [
    ("build_poe", {}), ("build_poe", {"generalized": True}), ("build_bcm", {}),
], ids=["poe", "gpoe", "rbcm"])
def test_finetuned_poe_family_predicts_as_jax(builder, kw):
    """PoE, gPoE and rBCM predict after ``finetune`` (per-leaf hypers; the
    rBCM prior from leaf 0's row) as JAX's model does under the same
    hypers, carried over with ``convert.from_jax_arrays``."""
    jm, tm = _pair(builder, K=3, M=25, seed=12, **kw)
    tdsm.finetune(tm, _adam(1e-2), iterations=1)
    H = _np(tm.theta)
    assert H.shape == (tm.num_leaves, 3)
    jm.set_params(jnp.asarray(H))
    convert.from_jax_arrays(tm, np.asarray(jm.theta))
    xt = np.linspace(0, 1, 21).reshape(-1, 1)
    for p, j in zip(tm.predict(xt), jm.predict(xt)):
        np.testing.assert_allclose(_np(p), np.asarray(j), rtol=VALUE_TOL)
    assert (_np(tm.predict(xt)[1]) > 0).all()
