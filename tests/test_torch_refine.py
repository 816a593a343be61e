"""Mixed-precision refinement in the port (``ops/refine.py``,
``refine_steps`` of the streamed predict and of ``DSMGP.predict``) against
the JAX package in float64 on the CPU, and the refined predict's store
dispatch.

The toy tree of ``tests/test_refine.py``: N=1200 sorted 1-D points, V=2,
K=2, M=60, IsoSE(0, 0), log noise -3 (small noise, so the float32 floor
shows), seed 3. Float64 models are held to JAX at 1e-10 (normwise).
``tests/test_torch_refine_f32.py`` holds float32 leaves to the gates of
``tests/test_refine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu import fit as jfit
from deepstructuredmixtures_tpu.ops import refine as jrefine
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch.ops import cholesky as tchol
from deepstructuredmixtures_tpu_torch.ops import refine as trefine

from .test_refine import LOG_NOISE, X, Y
from .torch_threads import one_torch_thread  # noqa: F401

COMMON = dict(V=2, K=2, M=60, log_noise=LOG_NOISE, seed=3, do_fit=False)
XT = np.linspace(0.02, 0.98, 17).reshape(-1, 1)
XT31 = np.linspace(0.02, 0.98, 31).reshape(-1, 1)
# held normwise: relative to the largest element of the JAX result, since at
# log noise -3 (condition ~2e5) elements that cancel to ~1e-2 differ by
# ~1e-10 of themselves with the BLAS threading alone
RTOL = 1e-10


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, jax):
    jax = _np(jax)
    np.testing.assert_allclose(_np(port), jax, rtol=0,
                               atol=RTOL * np.abs(jax).max())


def _jax_model(dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return dsm.build_dsmgp(X, Y, kernel=dsm.IsoSE(0.0, 0.0), **COMMON, **kw)


def _port_model(dtype=None):
    return tdsm.build_dsmgp(X, Y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu",
                            dtype=dtype, **COMMON)


def _streamed(m, steps, xt, jax_side):
    args = (m.layout, m.theta, m.bucket_batches, m.bucket_spec.leaf_ids,
            m.num_leaves)
    if jax_side:  # one program for every bucket, as the JAX models run it
        layout, _, _, ids, L = args
        out = jax.jit(lambda th, bs, x: jfit.bucketed_streamed_predict(
            layout, th, bs, ids, L, x, refine_steps=steps))(
                m.theta, m.bucket_batches, jnp.asarray(xt, m.dtype))
    else:
        out = tfit.bucketed_streamed_predict(
            *args, torch.as_tensor(xt, dtype=m.dtype), refine_steps=steps)
    return tuple(_np(a) for a in out)


@pytest.fixture(scope="module")
def f64():
    """Float64 models of both packages: the streamed refined leaf moments at
    17 points, and ``predict(refine_steps=2)`` after a fit and an update at
    31 points."""
    jm, tm = _jax_model(), _port_model()
    res = {"streamed": (_streamed(jm, 2, XT, True), _streamed(tm, 2, XT, False))}
    jm.fit(method="batched")
    jm.update()
    tm.fit(store="light")
    tm.update()
    res["predict"] = (tuple(_np(a) for a in jm.predict(XT31, refine_steps=2)),
                      tuple(_np(a) for a in tm.predict(XT31, refine_steps=2)))
    return jm, tm, res


# ---------------------------------------------------------------------------
# float64: the port against JAX at 1e-10
# ---------------------------------------------------------------------------


def test_refine_joint_matches_jax(f64):
    """Both packages' ``refine_joint`` on the same inputs: one bucket's leaf
    chunk and, in float64, a perturbed start (the float32 factor and
    solves cast up), so that the two steps do real work."""
    jm, tm, _ = f64
    k = int(np.argmax([b.num_leaves for b in tm.bucket_batches]))
    tb, jb = tm.bucket_batches[k], jm.bucket_batches[k]
    Kn = tfit._noisy_gram(tm.layout, tm.theta, tb)
    Lf = tchol.cholesky_nosym(Kn.float()).double()
    xt = torch.as_tensor(XT)
    Knt = torch.where(tb.mask[:, :, None],
                      tfit.leaf_gram(tm.layout, tm.theta, tb, xt), 0.0)
    rhs = torch.cat([tfit.centered_y(tb)[..., None], Knt], dim=-1)
    Z = tchol.solve_lower(Lf.float(), rhs.float()).double()
    z, V = Z[..., 0], Z[..., 1:]
    port = trefine.refine_joint(tm.layout, tm.theta, tb, Lf, z, V, xt, 2)
    jax_refine = jax.jit(jrefine.refine_joint, static_argnums=(0, 7))
    jax_out = jax_refine(jm.layout, jm.theta, jb, jnp.asarray(_np(Lf)),
                         jnp.asarray(_np(z)), jnp.asarray(_np(V)),
                         jnp.asarray(XT), 2)
    for p, j in zip(port, jax_out):
        assert p.dtype == torch.float64
        _close(p, j)
    # the start was 1e-4 off; refinement moved the mean by about that much
    mu0 = tb.mean[:, None] + torch.einsum("cnt,cn->ct", V, z)
    assert float((port[0] - mu0).abs().max()) > 1e-7


@pytest.mark.parametrize("what", ["mu", "var", "mll"])
def test_bucketed_streamed_predict_refined_matches_jax(f64, what):
    _, _, res = f64
    j, p = res["streamed"]
    i = ["mu", "var", "mll"].index(what)
    assert p[i].dtype == np.float64
    _close(p[i], j[i])


@pytest.mark.parametrize("what", ["mean", "var"])
def test_predict_refined_matches_jax(f64, what):
    _, _, res = f64
    j, p = res["predict"]
    i = ["mean", "var"].index(what)
    _close(p[i], j[i])


def test_row_chunk_does_not_change_the_result(f64):
    """Row blocks of 7 rows (every bucket's gram in many blocks, the last
    one short) give the default's result."""
    _, tm, _ = f64
    b = tm.bucket_batches[0]
    xt = torch.as_tensor(XT)
    Lf = tfit._factor(tm.layout, tm.theta, b)
    Knt = torch.where(b.mask[:, :, None],
                      tfit.leaf_gram(tm.layout, tm.theta, b, xt), 0.0)
    Z = tchol.solve_lower(Lf, torch.cat([tfit.centered_y(b)[..., None], Knt], -1))
    args = (tm.layout, tm.theta, b, Lf, Z[..., 0], Z[..., 1:], xt, 1)
    for a, c in zip(trefine.refine_joint(*args),
                    trefine.refine_joint(*args, row_chunk=7)):
        _close(c, a)
    assert trefine._row_chunk(16, 896, 2048) == 896
    assert trefine._row_chunk(1, 16232, 2048) == 2048
    # a block that would pass the budget takes fewer rows
    assert trefine._row_chunk(64, 16232, 2048) < 2048


# ---------------------------------------------------------------------------
# store dispatch
# ---------------------------------------------------------------------------


def test_refined_predict_streams_on_every_store(f64, monkeypatch):
    """``predict(refine_steps=1)`` takes the streamed path on the full and
    hybrid stores too (the same prediction as on the light store), and
    ``return_var=False`` with an alpha cache does not take the mean-only
    path."""
    _, tm, _ = f64
    tm.fit(store="light")
    tm.update()
    want = tm.predict(XT31, refine_steps=1)
    for store in ("full", "hybrid"):
        tm.fit(store=store)  # the weights stay those of the light fit
        got = tm.predict(XT31, refine_steps=1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tm.fit(store="light", cache_alpha=True)
    assert tm._alpha_cache is not None

    def refuse(*a, **k):
        raise AssertionError("the mean-only alpha path ran under refinement")

    monkeypatch.setattr(tfit, "bucketed_alpha_mean", refuse)
    mean = tm.predict(XT31, refine_steps=1, return_var=False)
    assert torch.equal(mean, want[0])
