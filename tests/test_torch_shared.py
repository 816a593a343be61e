"""The port's whole-model fit paths against the JAX package, in float64 on
the CPU: the leaf-overlap matrix D (dense, sparse CSR, kernel-mixture
``MixtureOverlap``), the shared-Cholesky schedule, the Givens row
deletion and continued Cholesky, ``fit_shared`` against ``fit_batched``,
the full store (routed predict, PoE/gPoE/rBCM), ``infer``,
``reset_weights``, ``leaf_responsibilities``, ``rebuild_schedule``, the
untied-hypers guard, checkpoints, and a failed Cholesky coming back NaN
as from XLA (float32 for the leaf case).

Toy sizes only: N=200 built trees and the hand-built trees of
``tests/test_fit.py`` (a sum node over four leaves that hits every
schedule case, and a delete-then-continue pair). Each JAX reference is
computed once per module.
"""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
from deepstructuredmixtures_tpu import checkpoint as jax_checkpoint
from deepstructuredmixtures_tpu import fit as jfit
from deepstructuredmixtures_tpu import infer as jinfer
from deepstructuredmixtures_tpu import leafgp as jleafgp
from deepstructuredmixtures_tpu import plan as jplan
from deepstructuredmixtures_tpu.hyper import initial_vector as j_initial_vector
from deepstructuredmixtures_tpu.hyper import make_layout as j_make_layout
from deepstructuredmixtures_tpu.models import DSMGP as JDSMGP
from deepstructuredmixtures_tpu.ops import cholesky as jchol
from deepstructuredmixtures_tpu.tree import LeafNode as JLeaf
from deepstructuredmixtures_tpu.tree import SumNode as JSum

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import checkpoint, convert
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch import infer as tinfer
from deepstructuredmixtures_tpu_torch import plan as tplan
from deepstructuredmixtures_tpu_torch.hyper import initial_vector, make_layout
from deepstructuredmixtures_tpu_torch.leafgp import LeafBatch
from deepstructuredmixtures_tpu_torch.models import DSMGP
from deepstructuredmixtures_tpu_torch.ops import cholesky as tchol
from deepstructuredmixtures_tpu_torch.ops import fused_chol
from deepstructuredmixtures_tpu_torch.tree import LeafNode, SumNode

from .torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10

# the data of tests/test_fit.py
_rng = np.random.default_rng(0)
X60 = np.sort(_rng.uniform(0, 1, 60)).reshape(-1, 1)
Y60 = np.sin(X60[:, 0] * 6) + _rng.normal(0, 0.1, 60)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, ref, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=rtol, atol=atol)


def _data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 6) + rng.normal(0.0, 0.1, n)
    return x, y


def _leaves(leaf_cls, obs_sets):
    return [leaf_cls(obs=np.asarray(o, dtype=np.int64), lb=np.array([-np.inf]),
                     ub=np.array([np.inf]), kernelid=0,
                     mean=float(Y60[np.asarray(o)].mean())) for o in obs_sets]


#: the hand-built trees of tests/test_fit.py, as observation sets under one
#: sum node: every schedule case (main, copy, subset, prefix superset), and
#: the delete-then-continue pair
TREES = {
    "every_case": [np.arange(40), np.arange(40), np.delete(np.arange(40), 7),
                   np.arange(60)],
    "delete_then_continue": [np.arange(40), np.concatenate(
        [np.delete(np.arange(40), 7), np.arange(40, 60)])],
}


def _pair_from_obs(name):
    """``(jax model, port model)`` on the hand-built tree ``name``, IsoSE
    (0.1, 0.2), log noise -1, float64."""
    obs = TREES[name]
    w = np.full(len(obs), -np.log(len(obs)))
    jroot = JSum(children=_leaves(JLeaf, obs), logweights=w)
    troot = SumNode(children=_leaves(LeafNode, obs), logweights=w.copy())
    jp = jplan.compile_tree(jroot, X60)
    kj = (dsm.IsoSE(0.1, 0.2),)
    jm = JDSMGP(jroot, jp, jplan.build_schedule(jp), j_make_layout(kj), None,
                j_initial_vector(kj, -1.0), jnp.float64, X=X60, y=Y60)
    tp = tplan.compile_tree(troot, X60)
    kt = (tdsm.IsoSE(0.1, 0.2),)
    tm = DSMGP(troot, tp, make_layout(kt), initial_vector(kt, -1.0),
               torch.float64, "cpu", X60, Y60,
               schedule=tplan.build_schedule(tp))
    return jm, tm


@pytest.fixture(scope="module", params=sorted(TREES))
def hand(request):
    """Per hand-built tree: both models and the JAX package's batched and
    shared posteriors."""
    jm, tm = _pair_from_obs(request.param)
    pb = jfit.fit_batched(jm.layout, jm.theta, jm.batch)
    ps, (dfb, cfb) = jfit.fit_shared(jm.layout, jm.theta, jm.batch, jm.schedule,
                                     with_diagnostics=True)
    return request.param, jm, tm, pb, ps, (int(dfb), int(cfb))


def _schedules_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.fixture(scope="module")
def built():
    """A built DSMGP (N=200, V=3, K=3, M=8, seed 5) on both sides, the
    port's hypers from the JAX model; full store, shared fit, update."""
    x, y = _data()
    common = dict(V=3, K=3, M=8, log_noise=-1.0, seed=5, do_fit=False)
    jm = dsm.build_dsmgp(x, y, kernel=dsm.IsoSE(0.0, 0.0), **common)
    tm = tdsm.build_dsmgp(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                          **common)
    convert.from_jax_arrays(tm, np.asarray(jm.theta))
    jm.fit(method="shared")
    tm.fit(method="shared")
    return jm, tm


# ---------------------------------------------------------------------------
# A failed Cholesky comes back NaN, as from XLA
# ---------------------------------------------------------------------------

#: the singular and the indefinite matrix, each beside a positive-definite
#: one
FAILING = {
    "singular": np.array([[1.0, 1, 0], [1, 1, 0], [0, 0, 4]]),
    "indefinite": np.array([[1.0, 2, 0], [2, 1, 0], [0, 0, 4]]),
}
GOOD = np.diag([2.0, 3.0, 4.0]) + 0.5


@pytest.mark.parametrize("case", sorted(FAILING))
def test_cholesky_nosym_failed_factor_is_nan_as_in_jax(case):
    K = np.stack([FAILING[case], GOOD])
    port = tchol.cholesky_nosym(torch.from_numpy(K)).numpy()
    ref = np.asarray(jchol.cholesky_nosym(jnp.asarray(K)))
    assert not np.isfinite(ref[0]).all() and not np.isfinite(port[0]).all()
    np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=1e-15)
    # the behaviour before the repair: cholesky_ex alone gives a finite
    # partial factor there, which this check rejects
    old = torch.linalg.cholesky_ex(torch.from_numpy(K))[0].numpy()
    assert np.isfinite(old[0]).all()


def _duplicate_leaf_batch(npdt):
    """A float32-style leaf batch: leaf 0 has every point twice, leaf 1 is
    well posed."""
    rng = np.random.default_rng(3)
    x = np.zeros((2, 8, 1), npdt)
    x[0, :, 0] = np.repeat(np.linspace(0, 1, 4), 2)
    x[1, :3, 0] = [0.0, 0.5, 1.0]
    y = rng.normal(size=(2, 8)).astype(npdt)
    y[1, 3:] = 0.0
    mask = np.arange(8)[None, :] < np.array([8, 3])[:, None]
    n = np.array([8, 3], np.int32)
    return x, y, mask, n, np.zeros(2, npdt), np.zeros(2, np.int32)


def test_singular_leaf_mll_is_nan_in_float32_as_in_jax():
    """Duplicated points and log noise -30 in float32: ``1 + EPS`` rounds
    to 1, so the gram is exactly singular. The JAX package gives that leaf
    a NaN mll, and so does the port on the light, batched and streamed
    paths; the other leaf agrees. The failed factor fails the PSD guard."""
    arrays = _duplicate_leaf_batch(np.float32)
    kj = (dsm.IsoSE(-1.0, 0.0),)
    kt = (tdsm.IsoSE(-1.0, 0.0),)
    jb = jleafgp.LeafBatch(*(jnp.asarray(a) for a in arrays))
    tb = LeafBatch(*(torch.from_numpy(a) for a in arrays))
    jth = jnp.asarray(j_initial_vector(kj, -30.0), jnp.float32)
    tth = torch.tensor(initial_vector(kt, -30.0), dtype=torch.float32)
    ref = np.asarray(jfit.fit_batched(j_make_layout(kj), jth, jb).mll)
    assert np.isnan(ref[0]) and np.isfinite(ref[1])
    lay = make_layout(kt)
    for mll in (tfit.fit_light(lay, tth, tb), tfit.fit_batched(lay, tth, tb).mll,
                tfit.streamed_leaf_predict(lay, tth, tb, torch.zeros(3, 1))[2]):
        mll = mll.numpy()
        assert np.isnan(mll[0])
        np.testing.assert_allclose(mll[1], ref[1], rtol=1e-5)
    # before the repair the singular leaf's factor was finite with a zero
    # pivot, which the shared fit's PSD guard accepted; now it fails it
    Kn = tfit._noisy_gram(lay, tth, tb)
    old = torch.linalg.cholesky_ex(Kn)[0]
    assert tchol.factor_is_valid(old, tb.mask).tolist() == [True, True]
    assert tchol.factor_is_valid(tchol.cholesky_nosym(Kn),
                                 tb.mask).tolist() == [False, True]


def test_fused_plain_version_not_positive_definite_is_nan():
    """The fused kernel's plain version keeps the kernel's contract: a leaf
    whose gram is not positive definite (negative noise) comes back
    non-finite without raising; the other leaf is its factor."""
    x = torch.linspace(0, 1, 128, dtype=torch.float64).reshape(1, 128, 1)
    x = x.repeat(2, 1, 1)
    n = torch.tensor([128, 100], dtype=torch.int32)
    logl = torch.full((2,), -1.0, dtype=torch.float64)
    logsigma = torch.zeros(2, dtype=torch.float64)
    noise = torch.tensor([-2.0, 0.1], dtype=torch.float64)
    out = fused_chol.fused_gram_cholesky(x, n, logl, logsigma, noise)
    assert not torch.isfinite(out[0]).all()
    assert torch.isfinite(out[1]).all()
    solo = fused_chol.fused_gram_cholesky(x[1:], n[1:], logl[1:], logsigma[1:],
                                          noise[1:])
    assert torch.equal(out[1], solo[0])


# ---------------------------------------------------------------------------
# The overlap matrix and the schedule
# ---------------------------------------------------------------------------


def test_overlap_dense_equals_jax(built):
    jm, tm = built
    assert isinstance(tm.D, np.ndarray) and tm.D.shape == (tm.num_leaves,) * 2
    np.testing.assert_array_equal(tm.D, np.asarray(jm.D))
    assert (tm.D > 0).sum() > tm.num_leaves  # off-diagonal overlap exists


def test_overlap_sparse_csr_equals_jax():
    import scipy.sparse as sp

    x, y = _data()
    common = dict(V=3, K=3, M=8, log_noise=-1.0, seed=5, do_fit=False,
                  overlap_format="sparse")
    jm = dsm.build_dsmgp(x, y, kernel=dsm.IsoSE(0.0, 0.0), **common)
    tm = tdsm.build_dsmgp(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                          **common)
    assert sp.issparse(tm.D) and sp.issparse(jm.D)
    np.testing.assert_array_equal(tm.D.toarray(), jm.D.toarray())
    _schedules_equal(tm.schedule, jm.schedule)


def test_overlap_mixture_sparse_equals_jax_dense_row_by_row():
    """A two-kernel tree: the port's sparse ``MixtureOverlap`` against the
    JAX package's dense D, every row and column, the partner argmax and
    the schedule built from either."""
    x, y = _data()
    common = dict(V=3, K=2, M=25, log_noise=-1.0, seed=4, do_fit=False)
    jm = dsm.build_dsmgp(x, y, kernel=[dsm.IsoSE(0.0, 0.0), dsm.IsoLinear(0.0)],
                         overlap_format="dense", **common)
    tm = tdsm.build_dsmgp(x, y, kernel=[tdsm.IsoSE(0.0, 0.0),
                                        tdsm.IsoLinear(0.0)],
                          device="cpu", overlap_format="sparse", **common)
    D = np.asarray(jm.D)
    assert isinstance(tm.D, tplan.MixtureOverlap)
    kid = tm.plan.leaf_kernelid
    assert ((kid[:, None] != kid[None, :]) & (D == 1.0)).any()
    for j in range(tm.num_leaves):
        np.testing.assert_array_equal(tm.D.row(j), D[j, :])
        np.testing.assert_array_equal(tm.D.col(j), D[:, j])
    np.testing.assert_array_equal(tm.D.rows(np.arange(0, tm.num_leaves, 3)),
                                  D[::3])
    np.testing.assert_array_equal(tm.D.main_partners(), np.argmax(D * D.T, 0))
    _schedules_equal(tm.schedule, jm.schedule)


def test_schedule_equals_jax_built(built):
    jm, tm = built
    _schedules_equal(tm.schedule, jm.schedule)
    assert tm.schedule.num_derived > 0


def test_schedule_equals_jax_hand_built(hand):
    name, jm, tm, *_ = hand
    _schedules_equal(tm.schedule, jm.schedule)
    s = tm.schedule
    if name == "every_case":
        assert (s.copy_j.size, s.del_j.size, s.cont_j.size, s.full_idx.size) == (
            1, 1, 1, 1)
    else:
        assert s.cont_del_ndel.tolist() == [1] and s.cont_p.tolist() == [39]


def test_overlap_off_has_no_schedule():
    x, y = _data()
    tm = tdsm.build_dsmgp(x, y, M=8, device="cpu", seed=5, overlap=False,
                          do_fit=False)
    assert tm.D is None and tm.schedule is None
    with pytest.raises(ValueError, match="overlap=False"):
        tm.fit(method="shared")
    with pytest.raises(ValueError, match="overlap=False"):
        tm.rebuild_schedule()


# ---------------------------------------------------------------------------
# Givens row deletion and the continued Cholesky
# ---------------------------------------------------------------------------


def _spd(G, n, seed):
    rng = np.random.default_rng(seed)
    A = np.zeros((G, n, n))
    for g in range(G):
        x = np.sort(rng.uniform(0, 1, n))
        A[g] = np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / 0.05) + 0.1 * np.eye(n)
    return A, np.linalg.cholesky(A)


def test_givens_delete_rows_matches_jax():
    A, L = _spd(3, 40, 0)
    pos = np.array([[3, 10, 0], [5, 0, 0], [1, 2, 30]], np.int32)
    nd = np.array([2, 1, 3], np.int32)
    ref = np.stack([np.asarray(jchol.givens_delete_rows(
        jnp.asarray(L[g]), jnp.asarray(pos[g]), nd[g])) for g in range(3)])
    port = tchol.givens_delete_rows(torch.from_numpy(L), torch.from_numpy(pos),
                                    torch.from_numpy(nd))
    _close(port, ref, rtol=0, atol=1e-10)
    # and the kept rows' factor is the factor of the kept block
    keep = np.setdiff1d(np.arange(40), pos[2, :3])
    np.testing.assert_allclose(
        np.tril(port.numpy()[2][np.ix_(keep, keep)]),
        np.linalg.cholesky(A[2][np.ix_(keep, keep)]), atol=1e-10)


def test_chol_continue_matches_jax():
    A, L = _spd(3, 40, 1)
    P = np.array([10, 0, 25])
    ref = np.stack([np.asarray(jchol.chol_continue(
        jnp.asarray(A[g]), jnp.asarray(L[g]), P[g])) for g in range(3)])
    port = tchol.chol_continue(torch.from_numpy(A), torch.from_numpy(L),
                               torch.from_numpy(P))
    _close(port, ref, rtol=0, atol=1e-10)
    _close(port, L, rtol=0, atol=1e-10)


def test_factor_is_valid_matches_jax():
    _, L = _spd(3, 12, 2)
    L[1, 4, 4] = -1e-3
    L[2, 7, 7] = np.nan
    mask = np.ones((3, 12), bool)
    mask[2, 7:] = False  # a NaN on a padded row does not count
    ref = np.asarray(jchol.factor_is_valid(jnp.asarray(L), jnp.asarray(mask)))
    port = tchol.factor_is_valid(torch.from_numpy(L), torch.from_numpy(mask))
    np.testing.assert_array_equal(port.numpy(), ref)
    assert ref.tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# fit_shared and fit_batched
# ---------------------------------------------------------------------------


def test_fit_shared_matches_batched_and_jax(hand):
    """The bounds of tests/test_fit.py:64-75: mll 1e-8, alpha 1e-7 and
    factors 1e-8 on the valid blocks, against the port's own batched fit
    and against the JAX package's shared fit."""
    _, jm, tm, _, ps, jfb = hand
    post, fb = tfit.fit_shared(tm.layout, tm.theta, tm.batch, tm.schedule,
                               with_diagnostics=True)
    pb = tfit.fit_batched(tm.layout, tm.theta, tm.batch)
    assert fb == jfb == (0, 0)
    for ref in (pb, ps):
        _close(post.mll, ref.mll, rtol=0, atol=1e-8)
        _close(post.alpha, ref.alpha, rtol=0, atol=1e-7)
        for l in range(tm.num_leaves):
            k = int(tm.batch.n[l])
            _close(post.chol[l, :k, :k], np.asarray(ref.chol)[l, :k, :k],
                   rtol=0, atol=1e-8)


def test_fit_batched_matches_jax(hand):
    _, jm, tm, pb, _, _ = hand
    post = tfit.fit_batched(tm.layout, tm.theta, tm.batch)
    _close(post.mll, pb.mll)
    _close(post.alpha, pb.alpha, atol=1e-10)
    _close(post.chol, pb.chol)
    chunked = tfit.fit_batched(tm.layout, tm.theta, tm.batch, chunk=3)
    for a, b in zip(chunked, post):
        _close(a, b, rtol=0, atol=1e-13)
    # the JAX package's torch.linalg-free counterpart, its ``factorize``
    for a, b in zip(post, jleafgp.factorize(jm.layout, jm.theta, jm.batch)):
        _close(a, b)


def test_fit_shared_split_and_fallback(hand, monkeypatch):
    """``split`` times every phase; a derived factor that fails the PSD
    guard is refactored and counted."""
    name, _, tm, pb, _, _ = hand
    split = {}
    tfit.fit_shared(tm.layout, tm.theta, tm.batch, tm.schedule, split=split)
    assert {"phase1", "givens", "continue", "copy", "posterior"} <= set(split)
    assert all(v >= 0 for v in split.values())
    monkeypatch.setattr(tchol, "chol_continue",
                        lambda A, Ltop, P: torch.full_like(A, torch.nan))
    post, (dfb, cfb) = tfit.fit_shared(tm.layout, tm.theta, tm.batch,
                                       tm.schedule, with_diagnostics=True)
    assert (dfb, cfb) == (0, tm.schedule.cont_j.size) and cfb == 1
    _close(post.mll, pb.mll, rtol=0, atol=1e-8)
    unsafe = tfit.fit_shared(tm.layout, tm.theta, tm.batch, tm.schedule,
                             safe=False)
    assert not torch.isfinite(unsafe.mll).all()


def test_fit_shared_refuses_untied_hypers(hand):
    _, _, tm, _, _, _ = hand
    H = tm.theta.repeat(tm.num_leaves, 1)
    with pytest.raises(ValueError, match="tied"):
        tfit.fit_shared(tm.layout, H, tm.batch, tm.schedule)


def test_leaf_predict_matches_jax(hand):
    _, jm, tm, pb, _, _ = hand
    xt = np.linspace(-0.1, 1.1, 9).reshape(-1, 1)
    post = tfit.fit_batched(tm.layout, tm.theta, tm.batch)
    jmu, jvar = jleafgp.leaf_predict(jm.layout, jm.theta, jm.batch, pb,
                                     jnp.asarray(xt))
    # the full store serves through the cached path's float64 solve
    cmu, cvar = tfit.cached_leaf_predict(tm.layout, tm.theta, tm.batch,
                                         post.chol, torch.from_numpy(xt))
    _close(cmu, jmu)
    _close(cvar, jvar)


# ---------------------------------------------------------------------------
# The model surface on the full store
# ---------------------------------------------------------------------------

XT = np.linspace(-0.05, 1.05, 300).reshape(-1, 1)


def test_build_overlap_true_matches_jax(built):
    """``build_dsmgp(overlap=True)``, now the default, builds the plan, D
    and the schedule as the JAX package does."""
    jm, tm = built
    assert tm.plan.overlap is not None and tm.schedule is not None
    assert tm.plan.nmax == jm.plan.nmax and tm.plan.pad_multiple == 8
    keys = ("gps", "sumnodes", "splitnodes", "ndata")
    assert [tm.stats()[k] for k in keys] == [jm.stats()[k] for k in keys]
    np.testing.assert_array_equal(tm.D, np.asarray(jm.D))


def test_fit_method_shared_matches_jax(built):
    """``fit(method='shared')`` on the full store: leaf mlls at 1e-10 of
    the JAX package's shared fit, root mll at 1e-8 of the batched fit."""
    jm, tm = built
    assert tm.posterior is not None and tm._alpha_cache is None
    assert tm.last_fit_diagnostics == {"delete_fallbacks": 0,
                                       "continue_fallbacks": 0}
    _close(tm.leaf_mlls(), jm.leaf_mlls())
    shared = tm.mll()
    tm.fit_naive()
    assert abs(tm.mll() - shared) < 1e-8
    _close(tm.leaf_mlls(), jm.leaf_mlls(), rtol=1e-9)
    tm.fit(method="shared")


def test_fit_store_full_matches_jax(built):
    """``fit(store='full')`` and ``'auto'`` (which is full on a small
    model): the monolithic posterior equal to the JAX package's."""
    jm, tm = built
    jm.fit(store="full", method="batched")
    for store in ("full", "auto"):
        tm.fit(store=store, method="batched")
        assert tm.posterior is not None and tm._bucket_factors is None
        assert tm._factor_bytes() == jm._factor_bytes()
        for a, b in zip(tm.posterior, jm.posterior):
            _close(a, b)
    assert tm.batch.nmax == tm.plan.nmax
    jm.fit(method="shared")
    tm.fit(method="shared")


def test_full_store_routed_predict_matches_jax(built):
    jm, tm = built
    jz, tz = jm.update(), tm.update()
    _close(tz, jz)
    _close(tm.logweights, jm.logweights)
    (jmean, jvar), (tmean, tvar) = jm.predict(XT), tm.predict(XT)
    _close(tmean, jmean)
    _close(tvar, jvar)
    _close(tm.predict(XT[:7], return_var=False), jmean[:7])


def test_infer_and_reset_weights_match_jax(built):
    jm, tm = built
    _close(tm.infer(), jm.infer())
    _close(tm.logweights, jm.logweights)
    assert tm.logweights.dtype == torch.float64
    jm.reset_weights()
    tm.reset_weights()
    _close(tm.logweights, jm.logweights)
    tm.update()
    jm.update()


def test_leaf_responsibilities_match_jax(built):
    jm, tm = built
    ref = np.asarray(jinfer.leaf_responsibilities(jm.plan, jm.leaf_mlls()))
    port = tinfer.leaf_responsibilities(tm.plan, tm.leaf_mlls())
    _close(port, ref)
    assert port.dtype == torch.float64 and not port.requires_grad
    member = tinfer.leaf_membership(tm.plan, torch.from_numpy(XT))
    np.testing.assert_array_equal(
        member.numpy(), np.asarray(jinfer.leaf_membership(jm.plan,
                                                          jnp.asarray(XT))))


def test_rebuild_schedule_matches_jax(hand):
    """A τ change rebuilds the schedule as in the JAX package; the shared
    fit's mll stays within 1e-8 of the batched one."""
    name, jm, tm, pb, _, _ = hand
    jm.rebuild_schedule(tau=1e-12)
    tm.rebuild_schedule(tau=1e-12)
    _schedules_equal(tm.schedule, jm.schedule)
    if name == "every_case":
        assert tm.schedule.del_j.size == 0
    tm.fit(method="shared")
    assert abs(tm.mll() - float(jinfer.root_mll(jm.plan, pb.mll))) < 1e-8
    jm.rebuild_schedule()
    tm.rebuild_schedule()


def test_untied_hypers_guard_matches_jax(hand, caplog):
    """Per-leaf hypers take the batched path with a warning, as in the JAX
    package, and match its fit."""
    _, jm, tm, _, _, _ = hand
    theta0 = np.asarray(jm.theta)
    H = np.tile(theta0, (tm.num_leaves, 1))
    H[:, 0] += np.linspace(-0.5, 0.5, tm.num_leaves)
    jm.set_params(H)
    tm.set_params(H)
    with caplog.at_level(logging.WARNING):
        tm.fit(method="shared")
    assert "untied" in caplog.text
    jm.fit(method="shared")
    _close(tm.leaf_mlls(), jm.leaf_mlls())
    jm.set_params(theta0)
    tm.set_params(theta0)


def test_light_store_shared_falls_back_to_batched(built, caplog):
    jm, tm = built
    with caplog.at_level(logging.WARNING):
        tm.fit(method="shared", store="light")
    assert "store='light'" in caplog.text
    assert tm.posterior is None and tm._alpha_cache is not None
    _close(tm.leaf_mlls(), jm.leaf_mlls(), rtol=1e-9)
    with pytest.raises(ValueError, match="hybrid"):
        tm.fit(method="shared", store="hybrid")
    tm.fit(method="shared")


@pytest.mark.parametrize("kind", ["poe", "gpoe", "rbcm"])
def test_poe_family_on_full_store_matches_jax(kind):
    x, y = _data()
    common = dict(K=3, M=20, log_noise=-1.0, seed=2)
    if kind == "rbcm":
        jm = dsm.build_bcm(x, y, kernel=dsm.IsoSE(0.0, 0.0), **common)
        tm = tdsm.build_bcm(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                            **common)
    else:
        g = kind == "gpoe"
        jm = dsm.build_poe(x, y, kernel=dsm.IsoSE(0.0, 0.0), generalized=g,
                           **common)
        tm = tdsm.build_poe(x, y, kernel=tdsm.IsoSE(0.0, 0.0), generalized=g,
                            device="cpu", **common)
    assert jm.posterior.chol is not None and tm.posterior is not None
    assert tm.schedule is not None
    for a, b in zip(tm.predict(XT), jm.predict(XT)):
        _close(a, b)


def test_checkpoint_overlap_flag(built, tmp_path):
    """A JAX-written checkpoint of an overlap model loads with D and the
    schedule; a port-written one stores the flag and loads back the same."""
    jm, tm = built
    p = str(tmp_path / "m.npz")
    jax_checkpoint.save(jm, p)
    m = checkpoint.load(p, device="cpu")
    assert m.schedule is not None
    _schedules_equal(m.schedule, jm.schedule)
    q = str(tmp_path / "t.npz")
    checkpoint.save(m, q)
    m2 = jax_checkpoint.load(q)
    assert m2.schedule is not None
    off = tdsm.build_dsmgp(*_data(), M=8, seed=5, device="cpu", overlap=False,
                           do_fit=False)
    checkpoint.save(off, q)
    assert checkpoint.load(q, device="cpu").schedule is None


def test_pad_multiple_rule():
    from deepstructuredmixtures_tpu_torch.models import _resolve_pad_multiple

    iso, lin = (tdsm.IsoSE(0.0, 0.0),), (tdsm.IsoLinear(0.0),)
    assert _resolve_pad_multiple(None, torch.float32, iso, "cuda") == 128
    assert _resolve_pad_multiple(None, torch.float64, iso, "cuda") == 8
    assert _resolve_pad_multiple(None, torch.float32, lin, "cuda") == 8
    assert _resolve_pad_multiple(None, torch.float32, iso, "cpu") == 8
    assert _resolve_pad_multiple(16, torch.float32, iso, "cuda") == 16
    # the pad multiple moves the global nmax only, never the buckets
    x, y = _data()
    a = tdsm.build_dsmgp(x, y, M=8, seed=5, device="cpu", do_fit=False)
    b = tdsm.build_dsmgp(x, y, M=8, seed=5, device="cpu", do_fit=False,
                         pad_multiple=128)
    assert b.plan.nmax % 128 == 0 and a.plan.nmax % 8 == 0
    assert a.bucket_spec.nmaxs == b.bucket_spec.nmaxs
    for ba, bb in zip(a.bucket_batches, b.bucket_batches):
        for u, v in zip(ba, bb):
            assert torch.equal(u, v)
