"""The port's training against the JAX package, in float64 on the CPU: the
ARD-SE gram's hand-written backward (``gradcheck``, ``jax.grad`` at
1e-10), the training objective and its three gradient routes, ``train``
(trajectory, ``randinit``, early stop, PoE, a non-finite first
iteration), ``train_gp`` and a failed leaf factor coming back NaN.

The toy data of ``tests/test_train.py`` (N=250, and its N=400 model for
the bucketed routes). Each JAX reference is computed once per module.
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
from deepstructuredmixtures_tpu import kernels as jkernels
from deepstructuredmixtures_tpu import leafgp as jleafgp
from deepstructuredmixtures_tpu.hyper import initial_vector as j_initial_vector
from deepstructuredmixtures_tpu.hyper import make_layout as j_make_layout

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import convert
from deepstructuredmixtures_tpu_torch.hyper import initial_vector, make_layout
from deepstructuredmixtures_tpu_torch.kernels import _ArdSEGram, gram
from deepstructuredmixtures_tpu_torch.leafgp import LeafBatch

from .test_torch_shared import _duplicate_leaf_batch
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


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(builder="build_dsmgp", x=X, y=Y, **kw):
    """The JAX model and the port's, built alike (``do_fit=False``)."""
    kw.setdefault("M", 20)
    kw.setdefault("log_noise", -1.0)
    jk = kw.pop("kernel", (0.0, 0.0))
    jm = getattr(dsm, builder)(x, y, kernel=dsm.IsoSE(*jk), do_fit=False, **kw)
    tm = getattr(tdsm, builder)(x, y, kernel=tdsm.IsoSE(*jk), do_fit=False,
                                device="cpu", **kw)
    return jm, tm


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


# ---------------------------------------------------------------------------
# the ARD-SE gram's backward
# ---------------------------------------------------------------------------


def _ard_inputs(L=3, N=6, M=5, D=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L, D)) * 0.3, rng.normal(size=L) * 0.2,
            rng.normal(size=(L, N, D)), rng.normal(size=(L, M, D)),
            rng.normal(size=(L, N, M)))


def _leaf(a):
    return torch.tensor(a, dtype=torch.float64, requires_grad=True)


def test_ard_se_function_gradcheck():
    """Per-leaf and broadcast (tied ``logl [D]``, one ``logsigma``) inputs,
    and ``x1 is x2`` as in a training gram."""
    logl, logsigma, x1, x2, _ = _ard_inputs(L=2, N=4, M=3)
    args = (_leaf(logl), _leaf(logsigma), _leaf(x1), _leaf(x2))
    assert torch.autograd.gradcheck(_ArdSEGram.apply, args)
    tied = (_leaf(logl[0]), _leaf(logsigma[0]), _leaf(x1))
    assert torch.autograd.gradcheck(
        lambda l, s, x: gram("ard_se", l, s, x, x), tied)


@pytest.mark.parametrize("hypers", ["tied", "per-leaf"])
def test_ard_se_backward_matches_jax_custom_vjp(hypers):
    logl, logsigma, x1, x2, w = _ard_inputs()
    if hypers == "tied":
        logl, logsigma = logl[0], logsigma[0]
        axes = (None, None, 0, 0)
    else:
        axes = (0, 0, 0, 0)
    jg = jax.vmap(lambda l, s, a, b: jkernels.gram("ard_se", l, s, a, b),
                  in_axes=axes)

    def jloss(*args):
        return jnp.sum(jg(*args) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(logl, logsigma, x1,
                                                          x2)
    args = [_leaf(a) for a in (logl, logsigma, x1, x2)]
    L = x1.shape[0]
    ll, ls = args[:2]
    if hypers == "tied":  # as leafgp._theta_for expands tied hypers
        ll, ls = ll.expand(L, -1), ls.expand(L)
    K = gram("ard_se", ll, ls, args[2], args[3])
    np.testing.assert_allclose(_np(K), np.asarray(jg(logl, logsigma, x1, x2)),
                               rtol=VALUE_TOL)
    (K * torch.from_numpy(w)).sum().backward()
    for a, g in zip(args, want):
        assert a.grad.shape == a.shape
        np.testing.assert_allclose(_np(a.grad), np.asarray(g),
                                   rtol=VALUE_TOL, atol=1e-13)


def test_kernel_spec_has_variance_and_init_params():
    for jk, tk in ((dsm.IsoSE(0.3, 0.1), tdsm.IsoSE(0.3, 0.1)),
                   (dsm.ArdSE([0.1, 0.2], -0.4), tdsm.ArdSE([0.1, 0.2], -0.4)),
                   (dsm.IsoLinear(0.4), tdsm.IsoLinear(0.4)),
                   (dsm.ArdLinear([0.1, 0.2]), tdsm.ArdLinear([0.1, 0.2]))):
        assert tk.has_variance == jk.has_variance
        jp = jkernels.init_params(jk)
        tp = tdsm.kernels.init_params(tk, device="cpu")
        for key in ("logl", "logsigma"):
            assert tp[key].dtype == torch.float64
            np.testing.assert_array_equal(_np(tp[key]), np.asarray(jp[key]))


# ---------------------------------------------------------------------------
# the objective and its gradient routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mono():
    """The N=250 model's monolithic objective, value and gradient by JAX
    (unchunked: JAX's own test holds its ``chunk=3`` form to it at 1e-10 /
    1e-9)."""
    jm, tm = _pair(V=2, K=2, seed=8)
    f = jtrain.make_mll_fn(jm.layout, jm.plan, jm.batch)
    return jm, tm, jax.jit(jax.value_and_grad(f))(jm.theta)


@pytest.mark.parametrize("chunk", [None, 3], ids=["unchunked", "chunk3"])
def test_make_mll_fn_matches_jax(mono, chunk):
    """Unchunked and in leaf chunks of 3 (each recomputed in the
    backward), against JAX's objective; it equals the fit's root mll."""
    jm, tm, (v_ref, g_ref) = mono
    f = ttrain.make_mll_fn(tm.layout, tm.plan, tm.batch, chunk=chunk)
    val, g = ttrain._value_and_grad(f)(tm.theta)
    np.testing.assert_allclose(float(val), float(v_ref), rtol=VALUE_TOL)
    np.testing.assert_allclose(_np(g), np.asarray(g_ref), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    tm.fit(store="light")
    np.testing.assert_allclose(float(val), tm.mll(), rtol=VALUE_TOL)


@pytest.fixture(scope="module")
def bucketed():
    """The N=400 data of ``tests/test_train.py:141-145`` with M=100: two
    size buckets (4 leaves at nmax 128, 8 at 256). JAX's bucketed
    objective under autograd at the model's hypers."""
    jm, tm = _pair(x=X4, y=Y4, V=2, K=2, M=100, kernel=(0.1, -0.1), seed=4)
    assert [b.num_leaves for b in tm.bucket_batches] == [4, 8]
    f = jtrain.make_mll_fn_bucketed(jm.layout, jm.plan, jm.bucket_batches,
                                    jm.bucket_spec.leaf_ids)
    return jm, tm, jax.jit(jax.value_and_grad(f))(jm.theta)


#: the default workspace budget (every bucket in one chunk) and 1 MiB, which
#: cuts both buckets into leaf chunks (2 and 1 leaves in float64)
BUDGETS = {"one_chunk": 2 << 30, "chunked": 1 << 20}


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("route", ["autograd", "per_bucket"])
def test_bucketed_value_and_grad_match_jax(bucketed, route, budget):
    """``make_mll_fn_bucketed`` under autograd and the per-bucket engine
    ``make_value_and_grad_bucketed`` (the responsibilities as cotangents),
    whole buckets and leaf chunks, against ``jax.value_and_grad`` of JAX's
    bucketed objective; per-leaf hypers (all rows equal) give the same."""
    jm, tm, (v_ref, g_ref) = bucketed
    args = (tm.layout, tm.plan, tm.bucket_batches, tm.bucket_spec.leaf_ids,
            BUDGETS[budget])
    if route == "autograd":
        vg = ttrain._value_and_grad(ttrain.make_mll_fn_bucketed(*args))
    else:
        vg = ttrain.make_value_and_grad_bucketed(*args)
    val, g = vg(tm.theta)
    np.testing.assert_allclose(float(val), float(v_ref), rtol=GRAD_TOL)
    np.testing.assert_allclose(_np(g), np.asarray(g_ref), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    H = tm.theta.expand(tm.num_leaves, -1).clone()
    val_h, g_h = vg(H)
    np.testing.assert_allclose(float(val_h), float(v_ref), rtol=GRAD_TOL)
    np.testing.assert_allclose(_np(g_h.sum(0)), np.asarray(g_ref),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_nan_leaf_gives_nan_mll_not_an_exception():
    """A singular leaf (duplicated points, log noise -30, float32) gives a
    NaN mll in the training objective, as in JAX's, and its backward runs:
    the objective's factor puts the NaN out of place."""
    arrays = _duplicate_leaf_batch(np.float32)
    jb = jleafgp.LeafBatch(*(jnp.asarray(a) for a in arrays))
    tb = LeafBatch(*(torch.from_numpy(a) for a in arrays))
    jth = jnp.asarray(j_initial_vector((dsm.IsoSE(-1.0, 0.0),), -30.0),
                      jnp.float32)
    th = torch.tensor(initial_vector((tdsm.IsoSE(-1.0, 0.0),), -30.0),
                      dtype=torch.float32, requires_grad=True)
    ref = np.asarray(jax.jit(functools.partial(
        jtrain._chunk_leaf_mll, j_make_layout((dsm.IsoSE(-1.0, 0.0),))))(jth, jb))
    mll = ttrain._chunk_leaf_mll(make_layout((tdsm.IsoSE(-1.0, 0.0),)), th, tb)
    assert np.isnan(ref[0]) and np.isnan(_np(mll)[0])
    np.testing.assert_allclose(_np(mll)[1], ref[1], rtol=1e-5)
    mll.sum().backward()
    assert th.grad.shape == th.shape


# ---------------------------------------------------------------------------
# train and train_gp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """``train`` on the N=250 model by both packages from a seeded random
    start, Adam 5e-2 (optax's in JAX), with an early-stop threshold no step
    can miss (λ = 1e6, earlystop 2): it stops after 12 iterations."""
    jm, tm = _pair(V=2, K=2, seed=2)
    kw = dict(iterations=500, lam=1e6, earlystop=2, seed=4, progress=False)
    jhist = dsm.train(jm, optax.adam(5e-2), **kw)
    thist = tdsm.train(tm, _adam(5e-2), **kw)
    return (jhist, np.asarray(jm.theta)), (thist, tm)


def test_train_trajectory_matches_optax_adam(trained):
    """Every Adam step within 1e-8 of optax's (torch's update equals
    optax's in exact arithmetic), and the final hypers."""
    (jhist, jtheta), (hist, tm) = trained
    assert hist.shape[0] >= 10
    np.testing.assert_allclose(hist, jhist[:hist.shape[0]], rtol=TRAJ_TOL)
    np.testing.assert_allclose(_np(tm.theta), jtheta, rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)
    assert hist[-1] > hist[0]


def test_train_randinit_start_and_early_stop_match_jax(trained):
    """The run stops where JAX's does (the eleventh δ is the first, the
    twelfth the second below λ), and its first value is the objective at
    the seeded standard-normal draw."""
    (jhist, _), (hist, tm) = trained
    assert hist.shape == jhist.shape == (12,)
    start = np.random.default_rng(4).standard_normal(tm.layout.total)
    f = ttrain.make_mll_fn_bucketed(tm.layout, tm.plan, tm.bucket_batches,
                                    tm.bucket_spec.leaf_ids)
    np.testing.assert_allclose(hist[0], float(f(torch.from_numpy(start))),
                               rtol=VALUE_TOL)
    # the refit after training is the fit at the final hypers
    np.testing.assert_allclose(tm.mll(), float(f(tm.theta)), rtol=VALUE_TOL)


def test_train_chunked_route_and_poe():
    """``train(chunk=3)`` (the monolithic route) and the bucketed route
    take the same trajectory; a PoE model trains and improves."""
    _, a = _pair(V=2, K=2, seed=5)
    _, b = _pair(V=2, K=2, seed=5)
    ha = tdsm.train(a, _adam(5e-2), iterations=4, lam=1e-9, randinit=False)
    hb = tdsm.train(b, _adam(5e-2), iterations=4, lam=1e-9, randinit=False,
                    chunk=3)
    np.testing.assert_allclose(ha, hb, rtol=TRAJ_TOL)
    _, p = _pair("build_poe", K=3, seed=10)
    p.fit()
    before = p.mll()
    tdsm.train(p, _adam(5e-2), iterations=15, lam=1e-6, randinit=False)
    assert p.mll() > before


def test_train_non_finite_first_iteration_raises():
    """A NaN log noise makes the first mll non-finite: ``train`` raises and
    leaves the hypers as they were; so does ``train_gp``. ``mesh=`` refuses
    anything but a ``DeviceMesh``."""
    _, tm = _pair(V=2, K=2, seed=1)
    theta0 = np.array([0.0, 0.0, np.nan])
    tm.set_params(theta0)
    with pytest.raises(RuntimeError, match="first iteration"):
        tdsm.train(tm, iterations=3, randinit=False)
    np.testing.assert_array_equal(_np(tm.theta), theta0)
    gp = tdsm.GaussianProcess(X[:30], Y[:30], device="cpu")
    gp.set_params(theta0)
    with pytest.raises(RuntimeError, match="first iteration"):
        tdsm.train_gp(gp, iterations=3, randinit=False)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdsm.train(tm, mesh=object())


#: train_gp against optax.rmsprop, both at their defaults (lr 1e-3, decay
#: 0.9, eps 1e-8): torch's RMSprop adds eps outside the square root, optax
#: inside, so the steps differ by about eps / sqrt(nu) relative. From the
#: IsoSE(0, 0) start every gradient is O(1) or more and the hypers agree to
#: 8e-10 after 30 steps; from the seeded random start below, whose
#: lengthscale gradient is 6e-4, they part by 2e-3, so only its first value
#: is held
GP_TRAJ_TOL = 1e-8


def test_train_gp_matches_optax_rmsprop():
    """``train_gp`` with the default optimizers of both packages, 30
    iterations, the port's GP carried over from JAX's; a seeded random
    start's first value is JAX's mll at the seeded draw."""
    jgp = dsm.GaussianProcess(X[::5], Y[::5], kernel=dsm.IsoSE(0.0, 0.0),
                              log_noise=-1.0)
    tgp = convert.gp_from_jax_arrays(jgp.kernel, np.asarray(jgp.theta),
                                     np.asarray(jgp.x), np.asarray(jgp.yc),
                                     jgp.mean_value, device="cpu")
    want = dsm.train_gp(jgp, iterations=30, lam=1e-9, randinit=False,
                        progress=False)
    got = tdsm.train_gp(tgp, iterations=30, lam=1e-9, randinit=False,
                        progress=False)
    assert got.shape == want.shape == (30,)
    np.testing.assert_allclose(got, want, rtol=GP_TRAJ_TOL)
    np.testing.assert_allclose(_np(tgp.theta), np.asarray(jgp.theta),
                               rtol=GP_TRAJ_TOL, atol=GP_TRAJ_TOL)
    np.testing.assert_allclose(tgp.mll(), jgp.mll(), rtol=GP_TRAJ_TOL)
    got = tdsm.train_gp(tgp, iterations=1, seed=3, progress=False)
    jgp.set_params(np.random.default_rng(3).standard_normal(3))
    np.testing.assert_allclose(got[0], jgp.mll(), rtol=VALUE_TOL)


class _NaNAfterTwoSteps(torch.optim.SGD):
    """SGD whose second step writes NaN into the log noise."""

    def step(self, closure=None):
        super().step(closure)
        self.state["steps"] = self.state.get("steps", 0) + 1
        if self.state["steps"] == 2:
            with torch.no_grad():
                self.param_groups[0]["params"][0][-1] = np.nan


def test_train_gp_nan_rolls_back():
    """A NaN mll at the third iteration rolls the hypers back to the
    second iteration's (those after one step) and keeps two values."""
    def gp():
        return tdsm.GaussianProcess(X[::5], Y[::5], kernel=tdsm.IsoSE(0.0, 0.0),
                                    log_noise=-1.0, device="cpu")

    one_step = gp()
    tdsm.train_gp(one_step, iterations=1, randinit=False,
                  optimizer=functools.partial(torch.optim.SGD, lr=1e-3))
    rolled = gp()
    hist = tdsm.train_gp(rolled, iterations=10, randinit=False, lam=1e-12,
                         optimizer=functools.partial(_NaNAfterTwoSteps, lr=1e-3))
    assert hist.shape == (2,) and np.isfinite(hist).all()
    np.testing.assert_array_equal(_np(rolled.theta), _np(one_step.theta))
