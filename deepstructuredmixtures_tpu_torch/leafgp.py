"""Batched leaf-GP math over padded ``[L, Nmax, ...]`` blocks (counterpart
of ``deepstructuredmixtures_tpu/leafgp.py``, forward only).

:func:`factorize` and :func:`leaf_predict` are the JAX package's
unchunked whole-batch forms, on ``torch.linalg``; the fit paths
(``fit.py``) chunk the leaves and factor through the CUDA kernels.

Padding contract: each leaf occupies rows ``< n[l]`` of ``Nmax``; padded
rows carry ``y = 0`` and identity covariance rows, making them exact
no-ops in factorization, solves, logdet and predictions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hyper as hyperlib
from .config import EPS
from .kernels import gram, gram_diag
from .ops import cholesky as chol

LOG2PI = float(np.log(2.0 * np.pi))


class LeafBatch(NamedTuple):
    """Padded leaf-expert data, all tensors on one device.

    ``x [L, Nmax, D]`` inputs, ``y [L, Nmax]`` raw (uncentered) targets,
    ``mask [L, Nmax]`` bool validity, ``n [L]`` int32 valid counts,
    ``mean [L]`` constant mean per leaf, ``kernelid [L]`` int32
    kernel-mixture component index.
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    n: torch.Tensor
    mean: torch.Tensor
    kernelid: torch.Tensor

    @property
    def num_leaves(self) -> int:
        return self.x.shape[0]

    @property
    def nmax(self) -> int:
        return self.x.shape[1]

    def rows(self, start: int, stop: int) -> "LeafBatch":
        """The leaves ``start:stop`` (views, no copy)."""
        return LeafBatch(*(a[start:stop] for a in self))

    def take(self, idx) -> "LeafBatch":
        """The leaves at the index tensor ``idx`` (a gathered copy)."""
        return LeafBatch(*(a[idx] for a in self))


class LeafPosterior(NamedTuple):
    """Fitted per-leaf posterior of the full store: ``chol [L, Nmax,
    Nmax]`` lower factors (identity on padding), ``alpha [L, Nmax]``
    weights and ``mll [L]`` marginal log-likelihoods (≙ the reference's
    cached ``gp.cK`` / ``gp.α``, ``gaussianprocess.jl:33-35``)."""

    chol: torch.Tensor
    alpha: torch.Tensor
    mll: torch.Tensor


def centered_y(batch: LeafBatch):
    """Per-leaf centered targets (≙ ``apply_subtract!``, ``means.jl:11-14``)."""
    return torch.where(batch.mask, batch.y - batch.mean[:, None], 0.0)


def _theta_for(layout, theta, k, num_leaves):
    logl, logsigma, lognoise = hyperlib.unpack(layout, theta, k)
    if theta.ndim == 1:
        logl = logl.expand((num_leaves,) + tuple(logl.shape))
        logsigma = logsigma.expand((num_leaves,))
        lognoise = lognoise.expand((num_leaves,))
    return logl, logsigma, lognoise


def leaf_noise(layout: hyperlib.HyperLayout, theta, batch: LeafBatch):
    """Per-leaf observation-noise variance ``exp(2 logNoise)``."""
    L = batch.num_leaves
    out = torch.zeros((L,), dtype=batch.x.dtype, device=batch.x.device)
    for k in range(len(layout.kinds)):
        _, _, lognoise = _theta_for(layout, theta, k, L)
        out = torch.where(batch.kernelid == k, hyperlib.noise_from(lognoise), out)
    return out


def _select_by_kernel(layout, batch, per_kind):
    """Combine per-kind results ``[L, ...]`` by each leaf's kernelid."""
    out = None
    for k, kind in enumerate(layout.kinds):
        Kk = per_kind(k, kind)
        sel = (batch.kernelid == k).reshape((-1,) + (1,) * (Kk.ndim - 1))
        if out is None:
            out = Kk if len(layout.kinds) == 1 else torch.where(sel, Kk, 0.0)
        else:
            out = torch.where(sel, Kk, out)
    return out


def leaf_gram(layout: hyperlib.HyperLayout, theta, batch: LeafBatch, x2=None):
    """Batched kernel matrices ``[L, Nmax, M]``: the square training gram
    by default, or against test inputs ``x2`` — shared ``[M, D]`` or
    per-leaf ``[L, M, D]``."""
    L = batch.num_leaves
    x1 = batch.x
    if x2 is None:
        x2b = x1
    elif x2.ndim == 2:
        x2b = x2[None].expand((L,) + tuple(x2.shape))
    else:
        x2b = x2

    def per_kind(k, kind):
        logl, logsigma, _ = _theta_for(layout, theta, k, L)
        return gram(kind, logl, logsigma, x1, x2b)

    return _select_by_kernel(layout, batch, per_kind)


def leaf_gram_diag(layout: hyperlib.HyperLayout, theta, batch: LeafBatch, xt):
    """Batched prior variances ``k(x_t, x_t)`` at test points ``[L, T]``;
    ``xt`` is shared ``[T, D]`` or per-leaf ``[L, T, D]``."""
    L = batch.num_leaves
    xtb = xt[None].expand((L,) + tuple(xt.shape)) if xt.ndim == 2 else xt

    def per_kind(k, kind):
        logl, logsigma, _ = _theta_for(layout, theta, k, L)
        return gram_diag(kind, logl, logsigma, xtb)

    return _select_by_kernel(layout, batch, per_kind)


def factorize(layout, theta, batch: LeafBatch) -> LeafPosterior:
    """Batched ``update_cholesky!`` + mll over all leaves (≙
    ``gaussianprocess.jl:87-108,163``): noisy gram, Cholesky, alphas and
    mlls of the whole batch at once."""
    K = leaf_gram(layout, theta, batch)
    noise = leaf_noise(layout, theta, batch)
    Lf = chol.cholesky_nosym(chol.masked_gram_noise(K, batch.mask, noise, EPS))
    return posterior_from_chol(Lf, batch)


def leaf_mll(Lf, yc, alpha, batch: LeafBatch):
    """``-(y'α + logdet + N log 2π) / 2`` per leaf (≙
    ``gaussianprocess.jl:163``)."""
    quad = torch.sum(yc * alpha, dim=-1)
    logdet = chol.masked_logdet(Lf, batch.mask)
    nn = batch.n.to(Lf.dtype)
    return -0.5 * (quad + logdet + nn * LOG2PI)


def leaf_predict(layout, theta, batch: LeafBatch, post: LeafPosterior, xt):
    """Predictive mean and variance (noise included) of every leaf at the
    shared test points ``xt [T, D]``: ``(mu [L, T], var [L, T])``, the
    diagonal of the reference's ``prediction`` (``gaussianprocess.jl:
    110-137``), from a :func:`factorize` posterior."""
    Knt = leaf_gram(layout, theta, batch, xt)  # [L, Nmax, T]
    Knt = torch.where(batch.mask[:, :, None], Knt, 0.0)
    mu = batch.mean[:, None] + torch.einsum("lnt,ln->lt", Knt, post.alpha)
    V = chol.solve_lower(post.chol, Knt)
    ktt = leaf_gram_diag(layout, theta, batch, xt)
    noise = leaf_noise(layout, theta, batch)
    return mu, ktt - torch.sum(V * V, dim=-2) + noise[:, None]


def leaf_mll_forward(Lf, z, batch: LeafBatch):
    """Leaf mll from the forward solve only: ``y'α = ||L^{-1} y||²``
    (≙ ``gaussianprocess.jl:163``)."""
    quad = torch.sum(z * z, dim=-1)
    logdet = chol.masked_logdet(Lf, batch.mask)
    nn = batch.n.to(Lf.dtype)
    return -0.5 * (quad + logdet + nn * LOG2PI)


def posterior_from_chol(Lf, batch: LeafBatch) -> LeafPosterior:
    """Alpha weights and mll from existing factors (the shared-Cholesky
    fit derives factors instead of recomputing them)."""
    z = chol.solve_lower(Lf, centered_y(batch)[..., None])
    alpha = torch.linalg.solve_triangular(Lf.mT, z, upper=True)[..., 0]
    return LeafPosterior(Lf, alpha, leaf_mll_forward(Lf, z[..., 0], batch))
