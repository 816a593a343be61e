"""Leaf fitting and prediction over size buckets (counterpart of the
bucketed half of ``deepstructuredmixtures_tpu/fit.py``).

* streamed (the light store): per leaf chunk the covariance is rebuilt,
  factored (the fused CUDA kernel where it applies, else ``torch.linalg``)
  and consumed; factors never persist. The alpha variants also keep the
  O(N) weights ``alpha = K^{-1} y`` for the exact mean-only path;
* cached (the hybrid store): the chosen buckets keep their factors
  (factored by the fused kernel, else by the blocked CUDA kernel
  ``ops/potrf.py``), and a request runs only cross-grams and triangular
  solves against them.

A leaf-chunk loop is a Python ``for`` over slices of the bucket, so the
last chunk is simply shorter; the JAX package pads it to a full chunk for
``lax.map``.
"""
from __future__ import annotations

import time
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
from .ops import fused_chol, potrf, refine


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


def _factor_kept(layout, theta, batch: LeafBatch):
    """Factors that the hybrid store keeps: the fused kernel where it
    applies; else on CUDA in float32 the blocked kernel, in place on the
    noisy gram; else ``cholesky_nosym``."""
    Lf = _maybe_fused_chol(layout, theta, batch)
    if Lf is not None:
        return Lf
    Kn = _noisy_gram(layout, theta, batch)
    if potrf.supported(batch.nmax, Kn.dtype, Kn.device):
        return potrf.blocked_cholesky(Kn)
    return chol.cholesky_nosym(Kn)


#: the factor of the refined streamed path (``refine_steps > 0``): the
#: blocked kernel above nmax 1024. On an H100 it made the refined N=100k
#: headline 4.5-4.9% faster than cuSOLVER in three calls, with every float32
#: error within the bounds after one step (``chip_potrf_ab.py
#: --refine-steps 1``, ``PERF.md``). The unrefined path keeps
#: :func:`_factor`: there the float32 solves put the mean past its bound.
_factor_refined = _factor_kept


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

    ``refine_steps > 0``: the chunk is factored by :data:`_factor_refined`,
    its solves are refined jointly against true-K float64 residuals
    (:func:`ops.refine.refine_joint`) and the moments and mll come back in
    float64.
    """
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    factor = _factor_refined if refine_steps else _factor
    mus, vars_, mlls = [], [], []
    for s, e, b, th in _chunks(batch, theta, chunk):
        Lf = factor(layout, th, b)
        xt_leaf = xt if tidx is None else xt[tidx[s:e]]
        Knt = leaf_gram(layout, th, b, xt_leaf)  # [C, Nmax, T]
        Knt = torch.where(b.mask[:, :, None], Knt, 0.0)
        rhs = torch.cat([centered_y(b)[..., None], Knt], dim=-1)
        Z = chol.solve_lower(Lf, rhs)
        z = Z[..., 0]
        V = Z[..., 1:]
        if refine_steps:
            mu, var, mll = refine.refine_joint(layout, th, b, Lf, z, V,
                                               xt_leaf, refine_steps)
        else:
            ktt = leaf_gram_diag(layout, th, b, xt_leaf)
            noise = leaf_noise(layout, th, b)
            var = ktt - torch.sum(V * V, dim=-2) + noise[:, None]
            mll = leaf_mll_forward(Lf, z, b)
            mu = b.mean[:, None] + torch.einsum("lnt,ln->lt", V, z)
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
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    var = torch.ones((L, T), dtype=dt, device=dev)
    mll = torch.zeros((L,), dtype=dt, device=dev)
    for b, ids in zip(batches, leaf_ids):
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
        Lf = _factor_kept(layout, th, b)
        z = chol.solve_lower(Lf, centered_y(b)[..., None])
        alphas.append(_alpha(Lf, z)[..., 0])
        mlls.append(leaf_mll_forward(Lf, z[..., 0], b))
        Lf_all[s:e] = Lf
        del Lf
    return torch.cat(mlls), torch.cat(alphas), Lf_all


def cached_leaf_predict(layout: HyperLayout, theta, batch: LeafBatch, Lf,
                        xt, tidx=None, chunk: Optional[int] = None):
    """Per-leaf predictive moments from cached factors ``Lf``: a cross-gram
    and one triangular solve per leaf chunk, O(n²t) per leaf and no
    refactorization. Shapes and dtype as :func:`streamed_leaf_predict`,
    without the mll.

    As in the streamed path, one solve on ``[y | K_nt]`` gives ``z`` and
    ``V``; the mean is ``m + V'z`` and the variance ``k_tt - ||V||² +
    noise``. The solve runs in float64 against the float32 factor (cast per
    chunk; the cache stays float32): on the ill-conditioned large leaves
    of the N=100k tree a float32 solve moves the routed mean past the
    float32 bound of ``chip_smoke.py`` (``PERF.md``). The JAX package
    solves in the model dtype and writes the mean ``m + K_nt'α``, equal in
    exact arithmetic."""
    chunk = min(chunk or default_chunk(batch.nmax, batch.x.dtype),
                batch.num_leaves)
    dt = batch.x.dtype
    mus, vars_ = [], []
    for s, e, b, th in _chunks(batch, theta, chunk):
        xt_leaf = xt if tidx is None else xt[tidx[s:e]]
        Knt = leaf_gram(layout, th, b, xt_leaf)  # [C, Nmax, T]
        Knt = torch.where(b.mask[:, :, None], Knt, 0.0)
        rhs = torch.cat([centered_y(b)[..., None], Knt], dim=-1)
        Z = chol.solve_lower(Lf[s:e].double(), rhs.double())
        V = Z[..., 1:]
        mus.append((b.mean[:, None] + torch.einsum("lnt,ln->lt", V, Z[..., 0]))
                   .to(dt))
        ktt = leaf_gram_diag(layout, th, b, xt_leaf)
        noise = leaf_noise(layout, th, b)
        vars_.append((ktt - torch.sum(V * V, dim=-2) + noise[:, None]).to(dt))
    return torch.cat(mus), torch.cat(vars_)


def bucketed_hybrid_predict(layout: HyperLayout, theta, batches, leaf_ids, L,
                            factors, xt, tidx=None, budget: int = 2 << 30):
    """Predict over size buckets with a partial factor cache: a bucket whose
    entry of ``factors`` is ``(Lf, alpha)`` predicts from it
    (:func:`cached_leaf_predict`), a bucket whose entry is ``None`` streams
    (:func:`streamed_leaf_predict`). Returns ``(mu [L, T|tmax], var)`` in
    global leaf order."""
    T = xt.shape[0] if tidx is None else tidx.shape[1]
    dev = batches[0].x.device
    dt = batches[0].x.dtype
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    var = torch.ones((L, T), dtype=dt, device=dev)
    for b, ids, cached in zip(batches, leaf_ids, factors):
        idx = _leaf_index(ids, dev)
        th = theta if theta.ndim == 1 else theta[idx]
        chunk = _bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, budget)
        ti = None if tidx is None else tidx[idx]
        if cached is not None:
            mu[idx], var[idx] = cached_leaf_predict(
                layout, th, b, cached[0], xt, ti, chunk=chunk)
        else:
            mu[idx], var[idx], _ = streamed_leaf_predict(
                layout, th, b, xt, ti, chunk=chunk)
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


def _phase_clock(split: Optional[dict], device):
    """``tick(key)`` adds the seconds since the previous tick to
    ``split[key]``, the device synchronized first; a no-op without
    ``split``, so that an untimed fit never waits on the device."""
    if split is None:
        return lambda key: None
    dev = torch.device(device)

    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    last = [now()]

    def tick(key):
        t = now()
        split[key] = split.get(key, 0.0) + t - last[0]
        last[0] = t

    return tick


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
    leaves) through :func:`_factor_kept`, chunk by chunk, so on CUDA in
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
    ``copy``, ``posterior``), the device synchronized between phases.

    Needs tied hypers (``theta`` 1-D): every derivation assumes a leaf
    and its main share one covariance function."""
    if theta.ndim != 1:
        raise ValueError(
            "fit_shared requires tied hypers (theta 1-D); per-leaf hypers "
            "invalidate factor reuse; use fit_batched")
    L, n = batch.num_leaves, batch.nmax
    dev = batch.x.device
    tick = _phase_clock(split, dev)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    Lf = torch.eye(n, dtype=batch.x.dtype, device=dev).repeat(L, 1, 1)
    del_fb = cont_fb = 0

    # phase 1: full factorizations (mains and unshareable leaves)
    full = idx(schedule.full_idx)
    chunk = default_chunk(n, batch.x.dtype)
    for s in range(0, full.numel(), chunk):
        f = full[s:s + chunk]
        Lf[f] = _factor_kept(layout, theta, batch.take(f))
    tick("phase1")

    # phase 2a: Givens row deletion, in one wavefront for the strict-subset
    # leaves and the mains of the continue leaves (which the continue
    # leaves row-delete down to their leading observations; nothing to
    # delete for a pure prefix extension)
    n_del = schedule.del_j.size
    cont_dels = schedule.cont_del_ndel.max(initial=0) > 0
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
    tick("givens")

    # phase 2b: continue from row P: the (row-deleted) main's factor
    # gathered into the leading block
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
    tick("continue")

    # phase 2c: verbatim copies, last (identical observation sets give
    # identical covariances under tied hypers)
    if schedule.copy_j.size:
        Lf[idx(schedule.copy_j)] = Lf[idx(schedule.copy_i)]
    tick("copy")

    post = posterior_from_chol(Lf, batch)
    tick("posterior")
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
