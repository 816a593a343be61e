"""Streamed leaf fitting and prediction over size buckets (counterpart of
the light/streamed half of ``deepstructuredmixtures_tpu/fit.py``).

Factors never persist: per leaf chunk the covariance is rebuilt, factored
(the fused CUDA kernel where it applies, else ``torch.linalg``) and
consumed. A leaf-chunk loop is a Python ``for`` over slices of the bucket,
so the last chunk is simply shorter; the JAX package pads it to a full
chunk for ``lax.map``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import EPS
from .hyper import HyperLayout, unpack
from .leafgp import (
    LeafBatch,
    centered_y,
    leaf_gram,
    leaf_gram_diag,
    leaf_mll_forward,
    leaf_noise,
)
from .ops import cholesky as chol
from .ops import fused_chol

REFINE_TODO = ("refine_steps > 0 is not ported yet: ROADMAP Queue 1 item 6 "
               "(refinement)")


def _noisy_gram(layout, theta, batch):
    K = leaf_gram(layout, theta, batch)
    noise = leaf_noise(layout, theta, batch)
    return chol.masked_gram_noise(K, batch.mask, noise, EPS)


def _maybe_fused_chol(layout, theta, batch: LeafBatch):
    """Factors from the fused CUDA gram+Cholesky kernel when it applies
    (``fused_chol.supported``: CUDA, float32, one IsoSE kernel, nmax a
    multiple of 128 up to 1024), else ``None``. Takes tied (``theta [P]``)
    and per-leaf (``theta [L, P]``) hypers; the kernel reads per-leaf
    scalars either way."""
    if theta.ndim not in (1, 2) or len(layout.kinds) != 1:
        return None
    if not fused_chol.supported(batch.nmax, batch.x.dtype, layout.kinds,
                                batch.x.device):
        return None
    logl, logsigma, lognoise = unpack(layout, theta, 0)
    L = batch.num_leaves
    if theta.ndim == 1:
        logl_v = logl[0].expand(L).contiguous()
        logsigma_v = logsigma.expand(L).contiguous()
        noise_v = torch.exp(2.0 * lognoise).expand(L).contiguous()
    else:  # per-leaf rows [L, P]
        if theta.shape[0] != L:
            return None
        logl_v = logl[:, 0].contiguous()
        logsigma_v = logsigma.contiguous()
        noise_v = torch.exp(2.0 * lognoise)
    return fused_chol.fused_gram_cholesky(
        batch.x, batch.n, logl_v, logsigma_v, noise_v, eps=EPS)


def _factor(layout, theta, batch: LeafBatch):
    Lf = _maybe_fused_chol(layout, theta, batch)
    if Lf is None:
        Lf = chol.cholesky_nosym(_noisy_gram(layout, theta, batch))
    return Lf


def _chunks(batch: LeafBatch, theta, chunk: int):
    """``(start, stop, leaves, theta)`` per leaf chunk of a bucket."""
    for s in range(0, batch.num_leaves, chunk):
        e = min(s + chunk, batch.num_leaves)
        yield s, e, batch.rows(s, e), theta if theta.ndim == 1 else theta[s:e]


def default_chunk(nmax: int, dtype, budget_bytes: int = 2 << 30) -> int:
    """Leaf-chunk size bounding peak memory of one [chunk, Nmax, Nmax]
    covariance + factor + workspace at roughly ``budget_bytes``."""
    per_leaf = 4 * nmax * nmax * dtype.itemsize  # K, L, and ~2x workspace
    return max(1, budget_bytes // per_leaf)


def fit_light(layout: HyperLayout, theta, batch: LeafBatch,
              chunk: Optional[int] = None):
    """Memory-bounded fit: the leaf mlls ``[L]`` in leaf chunks, without
    keeping the factors or the alpha weights. The mll needs only the
    forward solve, ``y'α = ||L^{-1} y||²``."""
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    out = []
    for _, _, b, th in _chunks(batch, theta, chunk):
        Lf = _factor(layout, th, b)
        z = chol.solve_lower(Lf, centered_y(b)[..., None])[..., 0]
        out.append(leaf_mll_forward(Lf, z, b))
    return torch.cat(out)


def streamed_leaf_predict(layout: HyperLayout, theta, batch: LeafBatch, xt,
                          tidx=None, chunk: Optional[int] = None,
                          refine_steps: int = 0):
    """Fused fit+predict in leaf chunks: per chunk recompute the factor,
    solve, and emit per-leaf predictive moments.

    ``xt [T, D]`` shared test points; with ``tidx [L, tmax]`` (int64) each
    leaf predicts only its routed points, otherwise all T. Returns
    ``(mu [L, T or tmax], var, mll [L])``. One forward solve per chunk on
    ``[y | K_nt]`` gives the mll (``y'α = ||z_y||²``), the mean
    ``m + V'z_y`` and the variance ``k_tt - ||V||² + noise``.
    """
    if refine_steps:
        raise NotImplementedError(REFINE_TODO)
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    mus, vars_, mlls = [], [], []
    for s, e, b, th in _chunks(batch, theta, chunk):
        Lf = _factor(layout, th, b)
        xt_leaf = xt if tidx is None else xt[tidx[s:e]]
        Knt = leaf_gram(layout, th, b, xt_leaf)  # [C, Nmax, T]
        Knt = torch.where(b.mask[:, :, None], Knt, 0.0)
        rhs = torch.cat([centered_y(b)[..., None], Knt], dim=-1)
        Z = chol.solve_lower(Lf, rhs)
        z = Z[..., 0]
        V = Z[..., 1:]
        ktt = leaf_gram_diag(layout, th, b, xt_leaf)
        noise = leaf_noise(layout, th, b)
        vars_.append(ktt - torch.sum(V * V, dim=-2) + noise[:, None])
        mlls.append(leaf_mll_forward(Lf, z, b))
        mus.append(b.mean[:, None] + torch.einsum("lnt,ln->lt", V, z))
    return torch.cat(mus), torch.cat(vars_), torch.cat(mlls)


def _bucket_chunk(nmax: int, n_leaves: int, dtype, budget: int = 2 << 30) -> int:
    """Leaves per chunk within a bucket: one leaf at a time for experts of
    4096 rows and more (their factorization fills the device alone), else
    as many as the memory budget allows."""
    if nmax >= 4096:
        return 1
    return min(default_chunk(nmax, dtype, budget), n_leaves)


def _leaf_index(ids, device):
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def bucketed_leaf_mlls(layout: HyperLayout, theta, batches, leaf_ids, L,
                       budget: int = 2 << 30, chunk: Optional[int] = None):
    """All leaf mlls ``[L]``, bucket by bucket through :func:`fit_light`.
    ``theta`` tied ``[P]`` or per-leaf ``[L, P]``; ``chunk`` overrides the
    budget-derived per-bucket leaf chunk."""
    dev = batches[0].x.device
    mll = torch.zeros((L,), dtype=batches[0].x.dtype, device=dev)
    for b, ids in zip(batches, leaf_ids):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        c = chunk if chunk is not None else _bucket_chunk(
            b.nmax, b.num_leaves, b.x.dtype, budget)
        mll[idx] = fit_light(layout, th, b, chunk=c)
    return mll


def bucketed_streamed_predict(layout: HyperLayout, theta, batches, leaf_ids, L,
                              xt, tidx=None, budget: int = 2 << 30,
                              refine_steps: int = 0):
    """Fused fit+predict over size buckets. Returns per-leaf moments in
    global leaf order: ``(mu [L, T|tmax], var, mll [L])``; ``tidx
    [L, tmax]`` (int64) routes test points to leaves."""
    if refine_steps:
        raise NotImplementedError(REFINE_TODO)
    T = xt.shape[0] if tidx is None else tidx.shape[1]
    dev = batches[0].x.device
    dt = batches[0].x.dtype
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    var = torch.ones((L, T), dtype=dt, device=dev)
    mll = torch.zeros((L,), dtype=dt, device=dev)
    for b, ids in zip(batches, leaf_ids):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        chunk = _bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, budget)
        ti = None if tidx is None else tidx[idx]
        mu[idx], var[idx], mll[idx] = streamed_leaf_predict(
            layout, th, b, xt, ti, chunk=chunk)
    return mu, var, mll
