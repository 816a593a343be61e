"""The port's standalone ``GaussianProcess`` against the JAX package's, in
float64 on the CPU: mll, marginal and full-covariance prediction for the
four kernels at 1e-10 (the data of ``tests/test_gp.py``), ``grad_mll``
against ``jax.grad`` at 1e-8 and a central finite difference, a failed
factor NaN as in JAX, and ``gp_from_jax_arrays``."""
import jax
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import convert

from .oracle import OracleGP
from .torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(1)
N = 40
X = np.sort(rng.uniform(0, 1, N)).reshape(-1, 1)
Y = np.sin(X[:, 0] * 4 * np.pi) + rng.normal(0, 0.2, N)
XT = np.linspace(-0.2, 1.2, 13).reshape(-1, 1)
X2 = rng.normal(size=(30, 2))
Y2 = X2[:, 0] + np.sin(X2[:, 1]) + rng.normal(0, 0.1, 30)
RTOL = 1e-10

#: (JAX kernel, port kernel, x, y, log noise, test points)
CASES = {
    "iso_se": (dsm.IsoSE(0.3, 0.1), tdsm.IsoSE(0.3, 0.1), X, Y, -1.0, XT),
    "ard_se": (dsm.ArdSE([0.3, -0.2], 0.1), tdsm.ArdSE([0.3, -0.2], 0.1), X2,
               Y2, -1.0, X2[:5]),
    "iso_linear": (dsm.IsoLinear(0.4), tdsm.IsoLinear(0.4), X2, Y2, -1.0,
                   X2[:5]),
    "ard_linear": (dsm.ArdLinear([0.1, 0.2]), tdsm.ArdLinear([0.1, 0.2]), X2,
                   Y2, -1.0, X2[:5]),
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(kind):
    jk, tk, x, y, ln, xt = CASES[kind]
    jgp = dsm.GaussianProcess(x, y, kernel=jk, log_noise=ln)
    tgp = tdsm.GaussianProcess(x, y, kernel=tk, log_noise=ln, device="cpu")
    return jgp, tgp, xt


@pytest.mark.parametrize("kind", list(CASES))
def test_mll_and_predict_match_jax(kind):
    jgp, tgp, xt = _pair(kind)
    assert tgp.theta.dtype == torch.float64 and tgp.n == jgp.n
    np.testing.assert_allclose(tgp.mll(), jgp.mll(), rtol=RTOL)
    for full_cov in (False, True):
        for p, j in zip(tgp.predict(xt, full_cov=full_cov),
                        jgp.predict(xt, full_cov=full_cov)):
            np.testing.assert_allclose(_np(p), _np(j), rtol=RTOL, atol=1e-12)
    og = OracleGP(jgp.x, jgp.yc + jgp.mean_value, kind,
                  list(CASES[kind][0].logl), CASES[kind][0].logsigma, -1.0)
    assert abs(tgp.mll() - og.mll()) < 1e-9


def test_full_covariance_diagonal_is_the_marginal_variance():
    gp = tdsm.GaussianProcess(X, Y, kernel=tdsm.IsoSE(0.0, 0.0),
                              log_noise=-0.5, device="cpu")
    mu, var = gp.predict(XT)
    mu2, Sigma = gp.predict(XT, full_cov=True)
    assert Sigma.shape == (len(XT), len(XT))
    np.testing.assert_allclose(_np(mu2), _np(mu), atol=1e-12)
    np.testing.assert_allclose(np.diag(_np(Sigma)), _np(var), atol=1e-9)


@pytest.mark.parametrize("kind", ["iso_se", "ard_se"])
def test_grad_mll_matches_jax_grad_and_finite_differences(kind):
    jk, tk, x, y, _, _ = CASES[kind]
    jgp = dsm.GaussianProcess(x, y, kernel=jk, log_noise=-0.8)
    tgp = tdsm.GaussianProcess(x, y, kernel=tk, log_noise=-0.8, device="cpu")
    g = _np(tgp.grad_mll())
    np.testing.assert_allclose(g, _np(jgp.grad_mll()), rtol=1e-8, atol=1e-10)
    assert not tgp.theta.requires_grad
    theta0 = _np(tgp.theta).copy()
    h = 1e-6
    for i in range(theta0.size):
        tp, tm = theta0.copy(), theta0.copy()
        tp[i] += h
        tm[i] -= h
        tgp.set_params(tp)
        fp = tgp.mll()
        tgp.set_params(tm)
        fm = tgp.mll()
        fd = (fp - fm) / (2 * h)
        assert abs(g[i] - fd) < 1e-4 * max(1.0, abs(fd))
    tgp.set_params(theta0)
    np.testing.assert_allclose(tgp.mll(), jgp.mll(), rtol=RTOL)


def test_params_set_params_and_refit():
    jgp, tgp, xt = _pair("ard_se")
    logl, logsigma, lognoise = tgp.params()
    np.testing.assert_allclose(logl, [0.3, -0.2])
    assert (logsigma, lognoise) == (0.1, -1.0)
    new = np.array([0.1, 0.0, -0.3, -1.5])
    tgp.set_params(new)
    jgp.set_params(new)
    np.testing.assert_allclose(tgp.mll(), jgp.mll(), rtol=RTOL)
    np.testing.assert_allclose(_np(tgp.predict(xt)[1]), _np(jgp.predict(xt)[1]),
                               rtol=RTOL)


def test_not_positive_definite_is_nan_as_in_jax():
    """Duplicated points under a signal variance of e^40: the noise and EPS
    vanish below its rounding, the gram is singular, and both packages give
    a NaN mll (an all-NaN factor) and NaN moments."""
    x = np.repeat(np.linspace(0, 1, 5), 2).reshape(-1, 1)
    y = np.sin(x[:, 0])
    jgp = dsm.GaussianProcess(x, y, kernel=dsm.IsoSE(0.0, 20.0), log_noise=-30.0)
    tgp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(0.0, 20.0),
                               log_noise=-30.0, device="cpu")
    assert np.isnan(jgp.mll()) and np.isnan(tgp.mll())
    assert np.isnan(_np(tgp._ensure()[0])).all()
    assert np.isnan(_np(tgp.predict(XT)[0])).all()
    assert not np.isfinite(_np(tgp.grad_mll())).any()
    tgp.set_params([0.0, 0.0, -1.0])  # a positive definite gram again
    assert np.isfinite(tgp.mll())


def test_gp_from_jax_arrays_matches_jax():
    jgp = dsm.GaussianProcess(X2, Y2, kernel=dsm.ArdSE([0.3, -0.2], 0.1),
                              log_noise=-1.0)
    jgp.set_params([0.2, -0.1, 0.3, -1.2])
    tgp = convert.gp_from_jax_arrays(
        jgp.kernel, np.asarray(jgp.theta), np.asarray(jgp.x),
        np.asarray(jgp.yc), jgp.mean_value, device="cpu")
    np.testing.assert_array_equal(_np(tgp.yc), np.asarray(jgp.yc))
    np.testing.assert_allclose(tgp.mll(), jgp.mll(), rtol=RTOL)
    for p, j in zip(tgp.predict(X2[:7]), jgp.predict(X2[:7])):
        np.testing.assert_allclose(_np(p), _np(j), rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):
        convert.gp_from_jax_arrays(jgp.kernel, np.zeros(3), np.asarray(jgp.x),
                                   np.asarray(jgp.yc), 0.0, device="cpu")


def test_float32_gp_and_mesh_option():
    """``dtype`` follows the argument (float32 here, as on the card) and
    its mll stays near the float64 one; ``fit(mesh=...)`` takes a
    ``DeviceMesh`` and refuses anything else (``tests/test_torch_mesh.py``
    runs it on one)."""
    g64 = tdsm.GaussianProcess(X, Y, kernel=tdsm.IsoSE(-1.0, 0.0),
                               log_noise=-1.0, device="cpu")
    g32 = tdsm.GaussianProcess(X, Y, kernel=tdsm.IsoSE(-1.0, 0.0),
                               log_noise=-1.0, device="cpu", dtype=torch.float32)
    assert g32.x.dtype == g32.predict(XT)[0].dtype == torch.float32
    assert abs(g32.mll() - g64.mll()) < 1e-4 * abs(g64.mll())
    with pytest.raises(TypeError, match="DeviceMesh"):
        g64.fit(mesh=object())
    assert tdsm.GaussianProcess(X, Y, run_cholesky=True, device="cpu")._state
    assert jax.config.jax_enable_x64  # the JAX side runs in float64
