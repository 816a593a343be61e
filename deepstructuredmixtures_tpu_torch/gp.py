"""Standalone exact Gaussian process (counterpart of
``deepstructuredmixtures_tpu/gp.py``).

User-facing equivalent of the reference ``GaussianProcess``
(``src/gaussianprocess.jl``): exact posterior via Cholesky (R&W Alg. 2.1),
closed-form prediction with full posterior covariance, marginal
log-likelihood, and hyper-gradients by ``torch.autograd`` (replacing the
hand trace formulas at ``gaussianprocess.jl:165-226``). Parameter vector
layout is ``[log lengthscales..., log sigma, log noise]``
(``gaussianprocess.jl:147-161``), noise is ``exp(2 logNoise)`` (``:39``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import EPS, as_2d, default_dtype
from .kernels import IsoSE, KernelSpec, gram, gram_diag
from .means import ConstMean, resolve_mean

LOG2PI = float(np.log(2.0 * np.pi))


def _unpack(nl: int, theta):
    return theta[:nl], theta[nl], theta[nl + 1]


def _fit(kind: str, nl: int, theta, x, yc):
    """``(L, mll)`` of the exact GP, ``y'K⁻¹y = ||L⁻¹y||²``. A covariance
    that is not positive definite gives an all-NaN factor, as XLA's
    Cholesky does in the JAX package; the NaN is added rather than written
    in place, so that autograd runs through it."""
    logl, logsigma, lognoise = _unpack(nl, theta)
    K = gram(kind, logl, logsigma, x, x)
    noise = torch.exp(2.0 * lognoise)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    Lf, info = torch.linalg.cholesky_ex(K + (noise + EPS) * eye)
    Lf = Lf + torch.where(info > 0, torch.nan, 0.0)
    z = torch.linalg.solve_triangular(Lf, yc[:, None], upper=False)[:, 0]
    mll = -0.5 * (z @ z + 2.0 * torch.sum(torch.log(torch.diagonal(Lf)))
                  + x.shape[0] * LOG2PI)
    return Lf, mll


def _predict(kind: str, nl: int, full_cov: bool, theta, x, yc, mean, Lf,
             xt):
    """``(mu [T], var [T])``, or ``(mu, Sigma [T, T])`` with ``full_cov``;
    observation noise on the (diagonal of the) variance. One solve on
    ``[y | K_nt]`` gives ``z`` and ``V``, the mean ``m + V'z``; it runs in
    float64 against the (float32) factor and the moments come back in the
    GP's dtype, as in ``fit.cached_leaf_predict``: in float32 at N=8192 on
    an H100 the float32 solves put the mean 5.1e-3 from float64, past the
    port's 5e-3 bound (``PERF.md``). The JAX package solves in the model
    dtype and writes ``m + K_nt'α``, equal in exact arithmetic."""
    logl, logsigma, lognoise = _unpack(nl, theta)
    Knt = gram(kind, logl, logsigma, x, xt)  # [N, T]
    Z = torch.linalg.solve_triangular(
        Lf.double(), torch.cat([yc[:, None], Knt], dim=1).double(),
        upper=False)
    V = Z[:, 1:]
    mu = mean + V.mT @ Z[:, 0]
    noise = torch.exp(2.0 * lognoise).double()
    if full_cov:
        Ktt = gram(kind, logl, logsigma, xt, xt).double()
        eye = torch.eye(xt.shape[0], dtype=V.dtype, device=V.device)
        cov = Ktt - V.mT @ V + noise * eye
    else:
        cov = gram_diag(kind, logl, logsigma, xt).double() - torch.sum(
            V * V, dim=0) + noise
    return mu.to(x.dtype), cov.to(x.dtype)


class GaussianProcess:
    """Exact GP regression model (≙ ``GaussianProcess``,
    ``gaussianprocess.jl:14-80``) on ``device``; ``dtype`` defaults to
    float64 on the CPU and float32 on CUDA (``config.default_dtype``)."""

    def __init__(
        self,
        x,
        y,
        mean: Optional[ConstMean] = None,
        kernel: KernelSpec = None,
        log_noise: float = float(np.log(7.0)),
        *,
        device,
        dtype=None,
        run_cholesky: bool = False,
    ):
        self.device = torch.device(device)
        dtype = dtype or default_dtype(self.device)
        self.kernel = kernel if kernel is not None else IsoSE(0.0, 0.0)
        x = as_2d(x)
        y = np.asarray(y, dtype=np.float64)
        self.mean_value = resolve_mean(mean, y)
        self.x = torch.tensor(x, dtype=dtype, device=self.device)
        self.yc = torch.tensor(y - self.mean_value, dtype=dtype,
                               device=self.device)
        self.n, self.d = x.shape
        # theta = [logl..., logsigma, lognoise]
        self.theta = torch.as_tensor(
            list(self.kernel.logl) + [self.kernel.logsigma, log_noise],
            dtype=dtype, device=self.device)
        self._state = None  # (factor, mll); row blocks after fit(mesh=...)
        # after fit(mesh=...): (mesh, axis, block, x, y), x and y padded to
        # the tiling; a refit reuses it
        self._mesh = None
        if run_cholesky:
            self.fit()

    # -- parameters (≙ params/setparams!, gaussianprocess.jl:141-161) -----
    @property
    def nl(self) -> int:
        return self.kernel.n_lengthscales

    def params(self):
        """(log lengthscales, log sigma, log noise)."""
        t = self.theta.cpu().numpy()
        return t[: self.nl], float(t[self.nl]), float(t[self.nl + 1])

    def set_params(self, theta):
        """New hypers drop the cached posterior; the next fit reuses the
        last fit's configuration, a mesh included (forgetting it would
        build the whole ``[N, N]`` covariance on one device, which the
        mesh path exists to avoid)."""
        self.theta = torch.as_tensor(np.array(theta), dtype=self.x.dtype,
                                     device=self.device)
        self._state = None

    # -- fitting / inference ----------------------------------------------
    def fit(self, mesh=None, block: int = 256, axis: Optional[str] = None):
        """≙ ``update_cholesky!`` (``gaussianprocess.jl:87-108``).

        ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) routes the fit
        through the distributed blocked Cholesky
        (``parallel.dist_chol``), the covariance row-sharded over the
        ranks of one mesh axis: the path for one expert whose ``[N, N]``
        covariance exceeds one device. Every rank calls it with the same
        data. The inputs are zero-padded to the ``ndev * block`` tiling;
        prediction then runs distributed too. ``axis``: the mesh axis to
        shard over, required on a mesh of several axes."""
        if mesh is None:
            self._state = _fit(self.kernel.kind, self.nl, self.theta, self.x,
                               self.yc)
            self._mesh = None
            return self
        from .parallel.comm import resolve
        from .parallel.dist_chol import sharded_gp_fit

        ax = resolve(mesh, axis, "fit(mesh=...) shards")
        tile = ax.ndev * block
        npad = -(-self.n // tile) * tile
        xp = self.x.new_zeros((npad, self.d))
        xp[:self.n] = self.x
        yp = self.yc.new_zeros((npad,))
        yp[:self.n] = self.yc
        logl, logsigma, lognoise = _unpack(self.nl, self.theta)
        _, mll, Lf = sharded_gp_fit(
            xp, yp, logl, logsigma, lognoise, mesh, axis=ax.name, block=block,
            valid_n=self.n, kind=self.kernel.kind, return_factor=True)
        self._state = (Lf, mll)
        self._mesh = (mesh, ax.name, block, xp, yp)
        return self

    def _ensure(self):
        if self._state is None:
            if self._mesh is None:
                self.fit()
            else:
                mesh, axis, block, _, _ = self._mesh
                self.fit(mesh=mesh, block=block, axis=axis)
        return self._state

    def mll(self) -> float:
        """Marginal log-likelihood (≙ ``gaussianprocess.jl:163``)."""
        return float(self._ensure()[1])

    def grad_mll(self):
        """Exact gradient of the mll with respect to the log-parameter
        vector, a tensor like ``theta`` (autograd through the Cholesky and
        the solves; replaces ``∇mll!``, ``gaussianprocess.jl:192-217``).

        One device only: it raises on a mesh-fitted GP rather than build
        the whole ``[N, N]`` covariance on one device."""
        if self._mesh is not None:
            raise NotImplementedError(
                "hyper-gradients are single-device only; for a mesh-fitted "
                "GP, train hypers on a subsample (or a single-device-sized "
                "model) and refit distributed with fit(mesh=...)"
            )
        theta = self.theta.detach().requires_grad_(True)
        with torch.enable_grad():
            mll = _fit(self.kernel.kind, self.nl, theta, self.x, self.yc)[1]
            (g,) = torch.autograd.grad(mll, theta)
        return g

    def predict(self, xt, full_cov: bool = False):
        """Posterior prediction (≙ ``prediction``,
        ``gaussianprocess.jl:110-137``). Returns ``(mu, var)`` or
        ``(mu, Sigma)`` with observation noise on the diagonal, tensors on
        the GP's device. After ``fit(mesh=...)`` it runs distributed on the
        sharded factor (``dist_chol.sharded_gp_predict``), marginal
        variances only."""
        Lf, _ = self._ensure()
        xt = torch.as_tensor(as_2d(np.asarray(xt)), dtype=self.x.dtype,
                             device=self.device)
        if self._mesh is not None:
            if full_cov:
                raise NotImplementedError(
                    "full_cov prediction is single-device only; the "
                    "distributed path returns marginal variances"
                )
            from .parallel.dist_chol import sharded_gp_predict

            mesh, axis, block, xp, yp = self._mesh
            logl, logsigma, lognoise = _unpack(self.nl, self.theta)
            return sharded_gp_predict(
                Lf, xp, yp, logl, logsigma, lognoise, xt, mesh, axis=axis,
                block=block, mean=self.mean_value, valid_n=self.n,
                kind=self.kernel.kind)
        return _predict(self.kernel.kind, self.nl, full_cov, self.theta,
                        self.x, self.yc, self.mean_value, Lf, xt)
