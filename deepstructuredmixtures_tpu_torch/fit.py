"""Leaf fitting and prediction over size buckets (counterpart of the
bucketed half of ``deepstructuredmixtures_tpu/fit.py``).

* streamed (the light store): per leaf chunk the covariance is rebuilt,
  factored (the fused CUDA kernel where it applies, the blocked CUDA
  kernel above it on CUDA in float32, with float64 solves; else
  ``torch.linalg``) and consumed; factors never persist. The alpha
  variants also keep the O(N) weights ``alpha = K^{-1} y`` for the exact
  mean-only path;
* cached (the hybrid store): the chosen buckets keep their factors
  (factored by the fused kernel, else by the blocked CUDA kernel
  ``ops/potrf.py``), and a request runs only cross-grams and one float64
  forward solve with its moments (``ops/trsm.py``) over every cached leaf.

A leaf-chunk loop is a Python ``for`` over slices of the bucket, so the
last chunk is simply shorter; the JAX package pads it to a full chunk for
``lax.map``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .config import EPS
from .hyper import HyperLayout, unpack
from .leafgp import (
    LeafBatch,
    LeafPosterior,
    centered_y,
    leaf_gram,
    leaf_gram_diag,
    leaf_mll_forward,
    leaf_noise,
    posterior_from_chol,
)
from .ops import cholesky as chol
from .ops import fused_chol, potrf, refine, trsm
from .utils import profiling


def _noisy_gram(layout, theta, batch):
    K = leaf_gram(layout, theta, batch)
    noise = leaf_noise(layout, theta, batch)
    return chol.masked_gram_noise(K, batch.mask, noise, EPS)


def _fused_args(layout, theta, batch: LeafBatch):
    """The fused CUDA gram+Cholesky kernel's per-leaf ``(logl, logsigma,
    noise)`` when it applies (``fused_chol.supported``: CUDA, float32, one
    IsoSE kernel, nmax a multiple of 128 up to 1024), else ``None``. Takes
    tied (``theta [P]``) and per-leaf (``theta [L, P]``) hypers; the kernel
    reads per-leaf scalars either way."""
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
    return logl_v, logsigma_v, noise_v


def _maybe_fused_chol(layout, theta, batch: LeafBatch):
    """Factors from the fused kernel when it applies (:func:`_fused_args`),
    else ``None``."""
    args = _fused_args(layout, theta, batch)
    if args is None:
        return None
    return fused_chol.fused_gram_cholesky(batch.x, batch.n, *args, eps=EPS)


def _kept_recipe(batch: LeafBatch) -> bool:
    """Whether the streamed path treats a chunk as the hybrid store does:
    the blocked kernel's factor (:func:`_factor`) and float64 solves
    against it (:func:`_moments`). So it does on CUDA in float32 above
    nmax 1024, whatever the kernel set. On an H100 cuSOLVER's float32
    factor missed the leaf mll of large IsoLinear and ArdSE leaves by
    21-75%, and of the IsoSE leaves of the depth-4 trees at N=500k and
    N=1M by up to 7.8e-3 against their float64 oracles (bound 1e-3;
    backward error 6e-6-1.3e-5 against the blocked kernel's 1.1e-6);
    float32 solves put the routed mean up to 1.9e-2 from them (bound
    5e-3). This route holds every sampled leaf within 1.0e-4 / 1.7e-4, and
    the N=100k and N=500k pipelines ran 4% and 21% faster on it than on
    cuSOLVER's (``chip_chol_routes.py``, ``PERF.md``)."""
    return potrf.supported(batch.nmax, batch.x.dtype, batch.x.device)


def _factor(layout, theta, batch: LeafBatch):
    """The factor of every path: the fused kernel where it applies; else
    under :func:`_kept_recipe` the blocked kernel, in place on the noisy
    gram; else ``cholesky_nosym``. Spans ``gram`` (not for the fused
    kernel, which builds its own) and ``factor``, which carries the padded
    work, ``padded_flops``."""
    args = _fused_args(layout, theta, batch)
    if args is None:
        with profiling.span("gram"):
            Kn = _noisy_gram(layout, theta, batch)
    with profiling.span("factor",
                        padded_flops=batch.num_leaves * batch.nmax ** 3 / 3):
        if args is not None:
            return fused_chol.fused_gram_cholesky(batch.x, batch.n, *args, eps=EPS)
        if _kept_recipe(batch):
            return potrf.blocked_cholesky(Kn)
        return chol.cholesky_nosym(Kn)


def _rhs(layout, theta, batch: LeafBatch, xt):
    """The predicts' right-hand side ``[y | K_nt]``, ``[L, nmax, 1 + T]``
    in the batch's dtype (span ``gram``)."""
    with profiling.span("gram"):
        Knt = leaf_gram(layout, theta, batch, xt)  # [C, Nmax, T]
        Knt = torch.where(batch.mask[:, :, None], Knt, 0.0)
        return torch.cat([centered_y(batch)[..., None], Knt], dim=-1)


def _forward_solve(layout, theta, batch: LeafBatch, Lf, xt):
    """``Z = L^{-1} [y | K_nt]`` in the batch's dtype."""
    rhs = _rhs(layout, theta, batch, xt)
    with profiling.span("solve"):
        return chol.solve_lower(Lf, rhs)


def _finish(layout, theta, batch: LeafBatch, xt, vz, vv):
    """The moments from the solve's two reductions ``vz = V'z`` and ``vv
    = ||V||²``: the mean ``m + V'z`` and the variance ``k_tt - ||V||² +
    noise``, in the batch's dtype."""
    dt = batch.x.dtype
    mu = batch.mean[:, None] + vz
    ktt = leaf_gram_diag(layout, theta, batch, xt)
    noise = leaf_noise(layout, theta, batch)
    var = ktt - vv + noise[:, None]
    return mu.to(dt), var.to(dt)


def _moments(layout, theta, batch: LeafBatch, Lf, xt, float64: bool):
    """Per-leaf moments from the factors ``Lf`` and the forward solve of
    ``[y | K_nt]``: the mean ``m + V'z`` and the variance ``k_tt - ||V||²
    + noise``, in the batch's dtype. Returns ``(mu, var, z)``, ``z`` in the
    solve's dtype. With ``float64`` the solve and both reductions run in
    float64 against the factor as it is (:func:`ops.trsm.forward_solve_moments`:
    the kernel on CUDA, no float64 copy of the factor); the span ``solve``
    holds them, ``moments`` the rest."""
    if float64:
        rhs = _rhs(layout, theta, batch, xt)
        with profiling.span("solve"):
            vz, vv, z = trsm.forward_solve_moments([Lf.contiguous()], [rhs], want_z=True)
        del rhs
        with profiling.span("moments"):
            mu, var = _finish(layout, theta, batch, xt, vz, vv)
        return mu, var, z[0]
    Z = _forward_solve(layout, theta, batch, Lf, xt)
    with profiling.span("moments"):
        z, V = Z[..., 0], Z[..., 1:]
        mu, var = _finish(layout, theta, batch, xt, torch.einsum("lnt,ln->lt", V, z),
                          torch.sum(V * V, dim=-2))
        return mu, var, z


def _alpha(Lf, z):
    """``alpha = L^{-T} z`` from the forward solve ``z = L^{-1} y``."""
    return torch.linalg.solve_triangular(Lf.mT, z, upper=True)


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

    ``refine_steps > 0``: the chunk's solves are refined jointly against
    true-K float64 residuals (:func:`ops.refine.refine_joint`) and the
    moments and mll come back in float64. Else under :func:`_kept_recipe` the solve runs in float64 against
    the factor, as in :func:`cached_leaf_predict`.
    """
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    solve64 = not refine_steps and _kept_recipe(batch)
    mus, vars_, mlls = [], [], []
    for s, e, b, th in _chunks(batch, theta, chunk):
        with profiling.span("chunk", device=b.x.device, leaves=e - s):
            Lf = _factor(layout, th, b)
            xt_leaf = xt if tidx is None else xt[tidx[s:e]]
            if refine_steps:
                Z = _forward_solve(layout, th, b, Lf, xt_leaf)
                mu, var, mll = refine.refine_joint(layout, th, b, Lf, Z[..., 0],
                                                   Z[..., 1:], xt_leaf, refine_steps)
            else:
                mu, var, z = _moments(layout, th, b, Lf, xt_leaf, solve64)
                with profiling.span("moments"):
                    mll = leaf_mll_forward(Lf, z, b).to(b.x.dtype)
        mus.append(mu)
        vars_.append(var)
        mlls.append(mll)
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
    [L, tmax]`` (int64) routes test points to leaves. Under
    ``refine_steps`` (:func:`streamed_leaf_predict`) the moments and mlls
    are float64, so that the caller's SPN combine runs in float64 too."""
    T = xt.shape[0] if tidx is None else tidx.shape[1]
    dev = batches[0].x.device
    dt = torch.float64 if refine_steps else batches[0].x.dtype
    with profiling.span("streamed_predict", device=dev):
        mu = torch.zeros((L, T), dtype=dt, device=dev)
        var = torch.ones((L, T), dtype=dt, device=dev)
        mll = torch.zeros((L,), dtype=dt, device=dev)
        for b, ids in zip(batches, leaf_ids):
            with profiling.span("bucket", nmax=b.nmax, leaves=b.num_leaves):
                idx = _leaf_index(ids, dev)
                th = theta if theta.ndim == 1 else theta[idx]
                chunk = _bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, budget)
                ti = None if tidx is None else tidx[idx]
                mu[idx], var[idx], mll[idx] = streamed_leaf_predict(
                    layout, th, b, xt, ti, chunk=chunk, refine_steps=refine_steps)
    return mu, var, mll


def streamed_leaf_alphas(layout: HyperLayout, theta, batch: LeafBatch,
                         chunk: Optional[int] = None):
    """``(mll [L], alpha [L, Nmax])`` in leaf chunks: the light fit plus the
    transposed solve, keeping the O(N) weights the predictive mean needs
    (``gp.α``, ``gaussianprocess.jl:105``) while the factors still never
    persist."""
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    mlls, alphas = [], []
    for _, _, b, th in _chunks(batch, theta, chunk):
        Lf = _factor(layout, th, b)
        z = chol.solve_lower(Lf, centered_y(b)[..., None])
        alphas.append(_alpha(Lf, z)[..., 0])
        mlls.append(leaf_mll_forward(Lf, z[..., 0], b))
    return torch.cat(mlls), torch.cat(alphas)


def bucketed_leaf_alphas(layout: HyperLayout, theta, batches, leaf_ids, L,
                         budget: int = 2 << 30, chunk: Optional[int] = None):
    """All leaf mlls ``[L]`` plus the per-bucket alpha weights (a tuple of
    ``[Lb, nmax_b]`` in bucket order): :func:`bucketed_leaf_mlls` with the
    alpha cache for the mean-only serving path."""
    dev = batches[0].x.device
    mll = torch.zeros((L,), dtype=batches[0].x.dtype, device=dev)
    alphas = []
    for b, ids in zip(batches, leaf_ids):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        c = chunk if chunk is not None else _bucket_chunk(
            b.nmax, b.num_leaves, b.x.dtype, budget)
        mll[idx], a_b = streamed_leaf_alphas(layout, th, b, chunk=c)
        alphas.append(a_b)
    return mll, tuple(alphas)


def bucketed_alpha_mean(layout: HyperLayout, theta, batches, leaf_ids, L,
                        alphas, xt, tidx, budget: int = 2 << 30):
    """Routed predictive mean ``[L, tmax]`` from the cached alpha weights:
    one cross-gram contraction per leaf chunk, O(n·t) work per leaf and no
    factorization (``μ = m + K_nt' α``, ``gaussianprocess.jl:118``). The
    variance needs the factors, so it is not available here."""
    T = tidx.shape[1]
    dev = batches[0].x.device
    dt = batches[0].x.dtype
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    for b, ids, a_b in zip(batches, leaf_ids, alphas):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        ti = tidx[idx]
        # the peak buffer is the [chunk, nmax, tmax] cross gram
        c = max(1, min(budget // (3 * b.nmax * max(T, 1) * dt.itemsize),
                       b.num_leaves))
        parts = []
        for s, e, bb, tt in _chunks(b, th, c):
            Knt = leaf_gram(layout, tt, bb, xt[ti[s:e]])  # [c, nmax, tmax]
            Knt = torch.where(bb.mask[:, :, None], Knt, 0.0)
            parts.append(bb.mean[:, None]
                         + torch.einsum("lnt,ln->lt", Knt, a_b[s:e]))
        mu[idx] = torch.cat(parts)
    return mu


def streamed_leaf_factors(layout: HyperLayout, theta, batch: LeafBatch,
                          chunk: Optional[int] = None):
    """``(mll [L], alpha [L, Nmax], Lf [L, Nmax, Nmax])`` in leaf chunks:
    the alpha fit plus the factors, kept for the hybrid store (≙ the
    reference's fit-once-predict-many ``gp.cK``,
    ``gaussianprocess.jl:87-120``). Each chunk's factor is copied into one
    bucket-sized buffer as soon as it is made."""
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    n = batch.nmax
    Lf_all = torch.empty((batch.num_leaves, n, n), dtype=batch.x.dtype,
                         device=batch.x.device)
    mlls, alphas = [], []
    for s, e, b, th in _chunks(batch, theta, chunk):
        Lf = _factor(layout, th, b)
        z = chol.solve_lower(Lf, centered_y(b)[..., None])
        alphas.append(_alpha(Lf, z)[..., 0])
        mlls.append(leaf_mll_forward(Lf, z[..., 0], b))
        Lf_all[s:e] = Lf
        del Lf
    return torch.cat(mlls), torch.cat(alphas), Lf_all


def _launch_row_bytes(width: int, itemsize: int) -> int:
    """Device bytes per factor row of one forward-solve launch of the
    cached predict: the right-hand side and two cross-gram temporaries in
    the batch's dtype, the kernel's float64 workspace."""
    return 3 * width * itemsize + 8 * trsm.column_tiles(width)[0] * trsm.TILE


def _launch_groups(sizes, row: int, budget: int):
    """The leaves of each forward-solve launch of :func:`_cached_moments`:
    ``sizes`` holds ``(nmax, leaves)`` per piece and ``row`` the bytes per
    factor row (:func:`_launch_row_bytes`); a launch takes leaves in order
    while they fit ``budget`` bytes, and at least one. Returns one list of
    ``(piece, start, end)`` per launch."""
    groups, group, used = [], [], 0
    for k, (nmax, count) in enumerate(sizes):
        per_leaf = nmax * row
        s = 0
        while s < count:
            room = (budget - used) // per_leaf
            if room < 1 and group:
                groups.append(group)
                group, used = [], 0
                continue
            e = min(count, s + max(1, room))
            group.append((k, s, e))
            used += (e - s) * per_leaf
            s = e
    if group:
        groups.append(group)
    return groups


def _cached_moments(layout: HyperLayout, pieces, xt, budget: int):
    """Per-leaf moments ``[(mu, var)]``, one pair per piece ``(batch,
    theta, Lf, tidx)`` (cached factors ``Lf``; ``tidx`` as in
    :func:`streamed_leaf_predict`, one ``tmax`` for all), from as few
    forward-solve launches as ``budget`` bytes allow
    (:func:`_launch_groups`): every leaf of the pieces in one launch at
    the serving path's sizes. Per launch a span ``chunk`` (``leaves``) →
    per piece ``gram`` (one cross-gram call), one ``solve``
    (:func:`ops.trsm.forward_solve_moments`), per piece ``moments``."""
    T = xt.shape[0] if pieces[0][3] is None else pieces[0][3].shape[1]
    row = _launch_row_bytes(1 + T, pieces[0][0].x.dtype.itemsize)
    out = [[] for _ in pieces]

    def launch(group):
        with profiling.span("chunk", device=pieces[0][0].x.device,
                            leaves=sum(e - s for _, s, e in group)):
            parts, factors, rhs = [], [], []
            for k, s, e in group:
                b, th, Lf, ti = pieces[k]
                bb, tt = b.rows(s, e), th if th.ndim == 1 else th[s:e]
                xl = xt if ti is None else xt[ti[s:e]]
                parts.append((k, bb, tt, xl))
                factors.append(Lf[s:e])
                rhs.append(_rhs(layout, tt, bb, xl))
            with profiling.span("solve"):
                vz, vv, _ = trsm.forward_solve_moments(factors, rhs)
            del rhs
            first = 0
            for k, bb, tt, xl in parts:
                last = first + bb.num_leaves
                with profiling.span("moments"):
                    out[k].append(_finish(layout, tt, bb, xl, vz[first:last],
                                          vv[first:last]))
                first = last

    for group in _launch_groups([(p[0].nmax, p[0].num_leaves) for p in pieces], row, budget):
        launch(group)
    return [(torch.cat([m for m, _ in o]), torch.cat([v for _, v in o])) for o in out]


def cached_leaf_predict(layout: HyperLayout, theta, batch: LeafBatch, Lf,
                        xt, tidx=None, budget: int = 2 << 30):
    """Per-leaf predictive moments from cached factors ``Lf``: cross-grams
    and the float64 forward solve with its moments, O(n²t) per leaf and no
    refactorization (:func:`_cached_moments`). Shapes and dtype as
    :func:`streamed_leaf_predict`, without the mll.

    As in the streamed path, one solve on ``[y | K_nt]`` gives ``z`` and
    ``V``; the mean is ``m + V'z`` and the variance ``k_tt - ||V||² +
    noise``. The solve runs in float64 against the float32 factor (the
    cache stays float32; the kernel turns each element into float64 in
    registers): on the ill-conditioned large leaves of the N=100k tree a
    float32 solve moves the routed mean past the float32 bound of
    ``chip_smoke.py`` (``PERF.md``). The JAX package solves in the model
    dtype and writes the mean ``m + K_nt'α``, equal in exact arithmetic."""
    return _cached_moments(layout, [(batch, theta, Lf, tidx)], xt, budget)[0]


def bucketed_hybrid_predict(layout: HyperLayout, theta, batches, leaf_ids, L,
                            factors, xt, tidx=None, budget: int = 2 << 30):
    """Predict over size buckets with a partial factor cache: a bucket whose
    entry of ``factors`` is ``None`` streams (:func:`streamed_leaf_predict`,
    span ``bucket``), and every bucket whose entry is ``(Lf, alpha)``
    predicts from its factors, all of them together
    (:func:`_cached_moments`: one cross-gram call per bucket, one
    forward-solve launch for all their leaves within ``budget``). Returns
    ``(mu [L, T|tmax], var)`` in global leaf order."""
    T = xt.shape[0] if tidx is None else tidx.shape[1]
    dev = batches[0].x.device
    dt = batches[0].x.dtype
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    var = torch.ones((L, T), dtype=dt, device=dev)
    cached = []
    for b, ids, entry in zip(batches, leaf_ids, factors):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        ti = None if tidx is None else tidx[idx]
        if entry is not None:
            cached.append((idx, (b, th, entry[0], ti)))
            continue
        with profiling.span("bucket", device=dev, nmax=b.nmax, leaves=b.num_leaves):
            chunk = _bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, budget)
            mu[idx], var[idx], _ = streamed_leaf_predict(
                layout, th, b, xt, ti, chunk=chunk)
    if cached:
        moments = _cached_moments(layout, [p for _, p in cached], xt, budget)
        for (idx, _), (m, v) in zip(cached, moments):
            mu[idx], var[idx] = m, v
    return mu, var


# ---------------------------------------------------------------------------
# Whole-model fits: the monolithic batch and the full store
# ---------------------------------------------------------------------------


def fit_batched(layout: HyperLayout, theta, batch: LeafBatch,
                chunk: Optional[int] = None) -> LeafPosterior:
    """Fresh factorization of every leaf of the monolithic batch, keeping
    the factors (≙ ``fit_naive!``, ``fit.jl:294-304``; the JAX package's
    ``fit_batched``). Leaves go ``chunk`` at a time (default: what a 2 GiB
    workspace holds, :func:`default_chunk`) through
    :func:`streamed_leaf_factors`, so on CUDA in float32 the fused kernel
    factors them up to nmax 1024 and the blocked kernel above."""
    mll, alpha, Lf = streamed_leaf_factors(layout, theta, batch, chunk=chunk)
    return LeafPosterior(Lf, alpha, mll)


@contextlib.contextmanager
def _phase(key, device, timed):
    """The span ``fit_shared.<key>`` of a phase of :func:`fit_shared`; with
    ``timed`` (a list) recorded whatever the recording state, and appended
    to it as ``(key, span)``."""
    force = contextlib.nullcontext() if timed is None else profiling.recording()
    with force, profiling.span("fit_shared." + key, device=device) as sp:
        yield
    if timed is not None:
        timed.append((key, sp))


def _gather_square(M, keep):
    """``M[g][keep[g]][:, keep[g]]`` for every group: ``M [G, N, N]``,
    ``keep [G, N]`` (int64)."""
    G, n, _ = M.shape
    rows = M.gather(1, keep[:, :, None].expand(G, n, n))
    return rows.gather(2, keep[:, None, :].expand(G, n, n))


def _guard(derived, mask, fresh):
    """The PSD fallback of the derived factors ``derived`` (in place):
    those that fail :func:`ops.cholesky.factor_is_valid` are replaced by
    ``fresh(idx)``, the fresh factors of the leaves ``idx`` of the group.
    Returns the number replaced."""
    bad = (~chol.factor_is_valid(derived, mask)).nonzero()[:, 0]
    if bad.numel():
        derived[bad] = fresh(bad)
    return int(bad.numel())


def fit_shared(layout: HyperLayout, theta, batch: LeafBatch, schedule,
               safe: bool = True, with_diagnostics: bool = False,
               split: Optional[dict] = None):
    """Factor-reuse fit following the precompiled ``plan.SharedSchedule``.

    Phase 1 factors the ``full_idx`` leaves (mains and unshareable
    leaves) through :func:`_factor`, chunk by chunk, so on CUDA in
    float32 the fused and blocked kernels carry them; then the derived
    groups, each batched over its leaves: Givens row deletion (subset
    leaves, ``fit.jl:145-206``), delete-then-continue Cholesky (prefix
    extensions, ``fit.jl:208-292``) and verbatim copies (identical
    observation sets, ``fit.jl:132-143``), in that order since a copy's
    source may be derived.

    ``safe``: a derived factor that fails the PSD guard is refactored from
    its gram (≙ the reference's ``@warn`` + refactorization,
    ``fit.jl:197-201,280-290``). ``with_diagnostics`` also returns
    ``(delete_fallbacks, continue_fallbacks)``. ``split``, a dict, gets
    the seconds of each phase (``phase1``, ``givens``, ``continue``,
    ``copy``, ``posterior``) on the device (on the host for a CPU batch):
    the phases' spans ``fit_shared.<phase>``, recorded for it
    (``utils.profiling``) and read once the last has ended.

    Needs tied hypers (``theta`` 1-D): every derivation assumes a leaf
    and its main share one covariance function."""
    if theta.ndim != 1:
        raise ValueError(
            "fit_shared requires tied hypers (theta 1-D); per-leaf hypers "
            "invalidate factor reuse; use fit_batched")
    L, n = batch.num_leaves, batch.nmax
    dev = batch.x.device
    timed = None if split is None else []

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    Lf = torch.eye(n, dtype=batch.x.dtype, device=dev).repeat(L, 1, 1)
    del_fb = cont_fb = 0

    # phase 1: full factorizations (mains and unshareable leaves)
    with _phase("phase1", dev, timed):
        full = idx(schedule.full_idx)
        chunk = default_chunk(n, batch.x.dtype)
        for s in range(0, full.numel(), chunk):
            f = full[s:s + chunk]
            Lf[f] = _factor(layout, theta, batch.take(f))

    # phase 2a: Givens row deletion, in one wavefront for the strict-subset
    # leaves and the mains of the continue leaves (which the continue
    # leaves row-delete down to their leading observations; nothing to
    # delete for a pure prefix extension)
    n_del = schedule.del_j.size
    cont_dels = schedule.cont_del_ndel.max(initial=0) > 0
    with _phase("givens", dev, timed):
        if n_del or cont_dels:
            mains, pos, ndel = [schedule.del_i], [schedule.del_pos], [schedule.del_ndel]
            if cont_dels:
                mains.append(schedule.cont_i)
                pos.append(schedule.cont_del_pos)
                ndel.append(schedule.cont_del_ndel)
            width = max(p.shape[1] for p in pos)
            pos = np.concatenate([np.pad(p, ((0, 0), (0, width - p.shape[1])))
                                  for p in pos])
            upd = chol.givens_delete_rows(Lf[idx(np.concatenate(mains))], idx(pos),
                                          idx(np.concatenate(ndel)))
        if n_del:
            sub = batch.take(idx(schedule.del_j))
            derived = chol.pad_identity(
                torch.tril(_gather_square(upd[:n_del], idx(schedule.del_keep))),
                sub.mask)
            if safe:
                del_fb = _guard(derived, sub.mask, lambda b: chol.cholesky_nosym(
                    _noisy_gram(layout, theta, sub.take(b))))
            Lf[idx(schedule.del_j)] = derived
            del derived

    # phase 2b: continue from row P: the (row-deleted) main's factor
    # gathered into the leading block
    with _phase("continue", dev, timed):
        if schedule.cont_j.size:
            sub = batch.take(idx(schedule.cont_j))
            if cont_dels:
                Ltop = _gather_square(upd[n_del:], idx(schedule.cont_keep))
            else:
                Ltop = Lf[idx(schedule.cont_i)]
            A = _noisy_gram(layout, theta, sub)
            derived = chol.pad_identity(
                chol.chol_continue(A, Ltop, idx(schedule.cont_p)), sub.mask)
            del Ltop
            if safe:
                cont_fb = _guard(derived, sub.mask,
                                 lambda b: chol.cholesky_nosym(A[b]))
            Lf[idx(schedule.cont_j)] = derived
            del A, derived
        if n_del or cont_dels:
            del upd

    # phase 2c: verbatim copies, last (identical observation sets give
    # identical covariances under tied hypers)
    with _phase("copy", dev, timed):
        if schedule.copy_j.size:
            Lf[idx(schedule.copy_j)] = Lf[idx(schedule.copy_i)]

    with _phase("posterior", dev, timed):
        post = posterior_from_chol(Lf, batch)
    for key, sp in timed or ():
        split[key] = split.get(key, 0.0) + sp.seconds()
    if with_diagnostics:
        return post, (del_fb, cont_fb)
    return post


def fit(layout: HyperLayout, theta, batch: LeafBatch, schedule=None,
        method: str = "auto", chunk: Optional[int] = None, safe: bool = True):
    """Whole-model posterior fit: ``'batched'`` (≙ ``fit_naive!``),
    ``'shared'`` (≙ ``fit!``) or ``'auto'``, which resolves to batched as
    in the JAX package: factor reuse measured slower there on the TPU and
    on the CPU (its ``fit.fit`` docstring); the H100's numbers are in
    ``PERF.md``. Returns ``(posterior, (delete_fallbacks,
    continue_fallbacks))``, the PSD-fallback counts ``(0, 0)`` on the
    batched path."""
    if method == "auto":
        method = "batched"
    if method == "shared":
        if schedule is None:
            raise ValueError("method='shared' requires a schedule")
        return fit_shared(layout, theta, batch, schedule, safe=safe,
                          with_diagnostics=True)
    if method != "batched":
        raise ValueError(f"unknown method {method!r}")
    return fit_batched(layout, theta, batch, chunk=chunk), (0, 0)
