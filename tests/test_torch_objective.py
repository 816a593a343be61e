"""The training objective's kept route (``train._KeptLeafMll``: the blocked
Cholesky's factor, the light fit's leaf mll, a closed-form float64
backward) against the JAX package, in float64 on the CPU.

On the card the objective takes that route under ``fit._kept_recipe``
(CUDA, float32, nmax above 1024, whatever the kernel set). Here
the route is forced (``ops.potrf.supported`` patched), so the objective
factors with the blocked kernel's plain version, and held to JAX's
``train._chunk_leaf_mll`` and ``jax.grad`` at 1e-10 on padded toy leaves
(IsoSE, IsoLinear, ArdSE D=2, a mixture; tied and per-leaf hypers), to
``gradcheck``, to JAX's NaN on a leaf that is not positive definite, and
through ``make_value_and_grad_bucketed`` and one ``finetune`` iteration
on a mixture tree to JAX at 1e-8; ``GaussianProcess`` (IsoLinear, IsoSE)
on the same route to JAX's at 1e-10; ``chip_smoke.py``'s launch counts of the
objective to the calls. Each JAX reference is computed once per test
session (``session_refs.once``); torch runs on one thread.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
from deepstructuredmixtures_tpu import leafgp as jleafgp
from deepstructuredmixtures_tpu.hyper import initial_vector as j_initial_vector
from deepstructuredmixtures_tpu.hyper import make_layout as j_make_layout

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch.hyper import initial_vector, make_layout
from deepstructuredmixtures_tpu_torch.leafgp import LeafBatch
from deepstructuredmixtures_tpu_torch.ops import potrf

from .session_refs import once
from .test_torch_families import _tuned, mixture_jax_refs, mixture_port
from .test_torch_shared import _duplicate_leaf_batch
from .torch_threads import one_torch_thread  # noqa: F401

jtrain = importlib.import_module("deepstructuredmixtures_tpu.train")
ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")

RTOL, TRAJ_TOL = 1e-10, 1e-8
#: the leaf counts of the toy batch: one full leaf, three padded
NVALID = (24, 19, 13, 7)


def _kernels(pkg, kind):
    return {"iso_se": [pkg.IsoSE(-0.5, 0.2)],
            "iso_linear": [pkg.IsoLinear(0.3)],
            "ard_se": [pkg.ArdSE([0.2, -0.4], 0.1)],
            "mixture": [pkg.IsoSE(-0.5, 0.2), pkg.ArdSE([-0.3], 0.0),
                        pkg.IsoLinear(-0.2)]}[kind]


def _batch_arrays(kind, nvalid=NVALID, seed=0):
    """A padded leaf batch ``(x, y, mask, n, mean, kernelid)`` in float64:
    sorted inputs, leaf ``l`` of kernel ``l mod 3`` for the mixture."""
    rng = np.random.default_rng(seed)
    L, N, D = len(nvalid), max(nvalid), 2 if kind == "ard_se" else 1
    x, y = np.zeros((L, N, D)), np.zeros((L, N))
    for l, k in enumerate(nvalid):
        x[l, :k] = np.sort(rng.uniform(0.0, 1.0, (k, D)), axis=0)
        y[l, :k] = np.sin(4.0 * x[l, :k].sum(-1)) + rng.normal(0.0, 0.2, k)
    mask = np.arange(N)[None, :] < np.asarray(nvalid)[:, None]
    kid = np.arange(L) % 3 if kind == "mixture" else np.zeros(L)
    return (x, y, mask, np.asarray(nvalid, np.int32), rng.normal(0.0, 0.3, L),
            kid.astype(np.int32))


def _thetas(kind):
    """``{"tied": [P], "per_leaf": [C, P]}`` around the kernels' start."""
    theta = j_initial_vector(_kernels(dsm, kind), -1.0)
    rng = np.random.default_rng(1)
    return {"tied": theta,
            "per_leaf": theta + rng.normal(0.0, 0.1, (len(NVALID), theta.size))}


#: the weights of the leaf mlls in the differentiated sum
WEIGHTS = np.array([0.7, -1.3, 0.4, 2.1])

CASES = [(k, h) for k in ("iso_se", "iso_linear", "ard_se", "mixture")
         for h in ("tied", "per_leaf")]
#: the GP's data: 30 points in 2-D (``tests/test_torch_gp.py``'s shape)
_rng = np.random.default_rng(5)
GP_DATA = (_rng.normal(size=(30, 2)), _rng.normal(size=30))
#: the GP's kernels
GP_KERNELS = {"iso_linear": lambda pkg: pkg.IsoLinear(0.4),
              "iso_se": lambda pkg: pkg.IsoSE(0.1, 0.2)}


def _jax_refs():
    """Per case JAX's leaf mlls and the gradient of their ``WEIGHTS`` sum;
    JAX's NaN case (float32, a duplicated-point leaf, log noise -30)."""
    out = {}
    for kind, hypers in CASES:
        layout = j_make_layout(_kernels(dsm, kind))
        jb = jleafgp.LeafBatch(*(jnp.asarray(a) for a in _batch_arrays(kind)))
        f = functools.partial(jtrain._chunk_leaf_mll, layout)

        def vg(th, jb=jb, f=f):
            return f(th, jb), jax.grad(lambda t: jnp.sum(f(t, jb) * WEIGHTS))(th)

        mll, g = jax.jit(vg)(jnp.asarray(_thetas(kind)[hypers]))
        out[f"{kind}_{hypers}_mll"], out[f"{kind}_{hypers}_grad"] = mll, g
    kern = (dsm.ArdSE([-1.0], 0.0),)
    jb = jleafgp.LeafBatch(*(jnp.asarray(a)
                             for a in _duplicate_leaf_batch(np.float32)))
    th = jnp.asarray(j_initial_vector(kern, -30.0), jnp.float32)
    f = functools.partial(jtrain._chunk_leaf_mll, j_make_layout(kern))
    out["nan_mll"] = jax.jit(f)(th, jb)
    out["nan_grad"] = jax.jit(jax.grad(lambda t: jnp.sum(f(t, jb))))(th)
    x, y = GP_DATA
    for kind in GP_KERNELS:
        gp = dsm.GaussianProcess(x, y, kernel=GP_KERNELS[kind](dsm),
                                 log_noise=-1.0)
        out[f"gp_{kind}_mll"], out[f"gp_{kind}_grad"] = gp.mll(), gp.grad_mll()
        out[f"gp_{kind}_mean"], out[f"gp_{kind}_var"] = gp.predict(x[:5])
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return once(tmp_path_factory, "objective_jax", _jax_refs)


@pytest.fixture
def kept(monkeypatch):
    """Forces the kept route on the CPU (every dtype, every nmax) and
    records the shape of every blocked-Cholesky call."""
    calls = []

    def counting(a):
        calls.append(tuple(a.shape))
        return a.copy_(potrf.blocked_cholesky_reference(a))

    monkeypatch.setattr(potrf, "supported", lambda nmax, dtype, device: True)
    monkeypatch.setattr(potrf, "blocked_cholesky", counting)
    return calls


def _port_batch(kind, arrays=None):
    arrays = _batch_arrays(kind) if arrays is None else arrays
    return (make_layout(_kernels(tdsm, kind)),
            LeafBatch(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("kind,hypers", CASES)
def test_kept_objective_matches_jax(refs, kept, kind, hypers):
    """Leaf mlls and the hyper gradient of their weighted sum, through one
    blocked factor of the whole (padded) batch."""
    layout, batch = _port_batch(kind)
    assert tfit._kept_recipe(batch)
    th = torch.tensor(_thetas(kind)[hypers], requires_grad=True)
    mll = ttrain._chunk_leaf_mll(layout, th, batch)
    assert mll.grad_fn.name() == "_KeptLeafMllBackward"
    (mll * torch.from_numpy(WEIGHTS)).sum().backward()
    assert kept == [(4, 24, 24)]
    np.testing.assert_allclose(mll.detach().numpy(), refs[f"{kind}_{hypers}_mll"],
                               rtol=RTOL)
    np.testing.assert_allclose(th.grad.numpy(), refs[f"{kind}_{hypers}_grad"],
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("kind", ["iso_linear", "ard_se"])
def test_kept_objective_gradcheck(kept, kind):
    """``gradcheck`` of the objective in the hypers on a 12-point leaf
    padded to 16 rows (and of the per-leaf form on two leaves)."""
    layout, batch = _port_batch(kind, _batch_arrays(kind, nvalid=(12, 16)))
    theta = _thetas(kind)["tied"]
    th = torch.tensor(theta, requires_grad=True)
    one = batch.rows(0, 1)
    assert torch.autograd.gradcheck(
        lambda t: ttrain._chunk_leaf_mll(layout, t, one), (th,))
    H = torch.tensor(np.stack([theta, theta + 0.1]), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: ttrain._chunk_leaf_mll(layout, t, batch), (H,))
    assert kept and all(s[1:] == (16, 16) for s in kept)


def test_kept_objective_nan_on_a_leaf_not_positive_definite(refs, kept):
    """Duplicated points and log noise -30 in float32 (``1 + EPS`` rounds to
    1): the kept route gives that leaf a NaN mll, as JAX does, the other
    leaf JAX's, and a NaN gradient, as JAX's."""
    kern = (tdsm.ArdSE([-1.0], 0.0),)
    tb = LeafBatch(*(torch.from_numpy(a) for a in _duplicate_leaf_batch(np.float32)))
    th = torch.tensor(initial_vector(kern, -30.0), dtype=torch.float32,
                      requires_grad=True)
    layout = make_layout(kern)
    assert tfit._kept_recipe(tb)
    mll = ttrain._chunk_leaf_mll(layout, th, tb)
    mll.sum().backward()
    assert kept == [(2, 8, 8)]
    ref = refs["nan_mll"]
    assert np.isnan(ref[0]) and np.isnan(mll.detach().numpy()[0])
    np.testing.assert_allclose(mll.detach().numpy()[1], ref[1], rtol=1e-5)
    assert np.isnan(refs["nan_grad"]).all() and torch.isnan(th.grad).all()


def _gp_matches_jax(refs, kept, kind):
    x, y = GP_DATA
    gp = tdsm.GaussianProcess(x, y, kernel=GP_KERNELS[kind](tdsm),
                              log_noise=-1.0, device="cpu")
    np.testing.assert_allclose(gp.mll(), refs[f"gp_{kind}_mll"], rtol=RTOL)
    np.testing.assert_allclose(gp.grad_mll().numpy(), refs[f"gp_{kind}_grad"],
                               rtol=RTOL, atol=RTOL)
    for p, j in zip(gp.predict(x[:5]), (refs[f"gp_{kind}_mean"],
                                        refs[f"gp_{kind}_var"])):
        np.testing.assert_allclose(p.numpy(), j, rtol=RTOL, atol=1e-12)
    assert kept == [(1, 30, 30)] * 2  # the fit, then grad_mll


def test_kept_gp_matches_jax(refs, kept):
    """``GaussianProcess(IsoLinear)`` on the kept route (``gp._fit``
    through ``train._KeptLeafMll``): its mll, ``grad_mll`` and predict from
    the blocked factor are JAX's."""
    _gp_matches_jax(refs, kept, "iso_linear")


def test_kept_gp_iso_se_matches_jax(refs, kept):
    """``GaussianProcess(IsoSE)`` takes the same route as every other
    kernel (``gp._fit`` reads no kernel kind) and matches JAX's."""
    _gp_matches_jax(refs, kept, "iso_se")


@pytest.fixture(scope="module")
def mixture_refs(tmp_path_factory):
    return once(tmp_path_factory, "mixture_jax", mixture_jax_refs)


def test_kept_value_and_grad_and_finetune_match_jax(mixture_refs, kept):
    """The mixture tree of ``tests/test_torch_families.py`` with the kept
    route forced on every bucket: ``make_value_and_grad_bucketed`` (one
    blocked factor per leaf chunk in the no-graph pass and again in the
    graph pass) and one ``finetune`` iteration match JAX at 1e-8."""
    r = mixture_refs
    tm = mixture_port()
    assert all(tfit._kept_recipe(b) for b in tm.bucket_batches)
    vg = ttrain.make_value_and_grad_bucketed(tm.layout, tm.plan,
                                             tm.bucket_batches,
                                             tm.bucket_spec.leaf_ids)
    v, g = vg(tm.theta)
    assert len(kept) == 2 * len(tm.bucket_batches)
    np.testing.assert_allclose(float(v), r["v"], rtol=TRAJ_TOL)
    np.testing.assert_allclose(g.numpy(), r["g"], rtol=TRAJ_TOL, atol=TRAJ_TOL)
    kept.clear()
    hist = tdsm.finetune(tm, functools.partial(torch.optim.Adam, lr=1e-2),
                         iterations=1, lam=1e-9, bucketed=True, sparse=True,
                         leaves=_tuned(tm), progress=False)
    assert kept
    np.testing.assert_allclose(hist, r["hist"], rtol=TRAJ_TOL)
    np.testing.assert_allclose(tm.theta.numpy(), r["theta"], rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)


def test_chip_smoke_launch_counts_follow_the_plan(kept):
    """The objective's blocked launches that ``chip_smoke.py`` counts from
    the plan (``_train_launches``, ``_finetune_launches``) are the blocked
    calls of one evaluation with the kept route forced: ``train._train_vg``
    (one graph through every bucket), ``make_value_and_grad_bucketed`` and
    the fine-tune engine over every fifth candidate (sparse pair list)."""
    import chip_smoke

    tm = mixture_port()
    L = tm.num_leaves
    ttrain._train_vg(tm)(tm.theta)
    assert (0, len(kept)) == chip_smoke._train_launches(tm) != (0, 0)
    kept.clear()
    ttrain.make_value_and_grad_bucketed(tm.layout, tm.plan, tm.bucket_batches,
                                        tm.bucket_spec.leaf_ids)(tm.theta)
    assert (0, len(kept)) == chip_smoke._train_launches(tm, per_bucket=True)
    kept.clear()
    cand = np.arange(0, L, 5)
    assert cand.size > 8  # two groups of the engine's 8 candidates
    W = ttrain._candidate_rows(tm.plan.overlap, cand)
    W[np.arange(cand.size), cand] = 1.0
    ttrain.make_finetune_vg_bucketed(
        tm.layout, tm.plan, tm.bucket_batches, tm.bucket_spec.leaf_ids,
        sparse=True)(tm.theta.expand(cand.size, -1), torch.as_tensor(W))
    assert (0, len(kept)) == chip_smoke._finetune_launches(tm, cand, W)
