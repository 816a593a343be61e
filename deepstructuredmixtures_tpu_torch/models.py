"""User-facing models and builders (counterpart of
``deepstructuredmixtures_tpu/models.py``).

A model holds its host tree, raw data, compiled plan (with the leaf-overlap
matrix ``D`` unless built with ``overlap=False``), the shared-Cholesky
schedule, the size-bucketed leaf batches on its device (and, built on first
use, the monolithic ``[L, nmax]`` batch), the flat tied hyper vector, the
flat sum-edge log-weights and what the last fit kept:

* the leaf mlls (every store);
* the full store's monolithic posterior (``posterior``: factors, alphas,
  mlls of every leaf at the global ``nmax``), which ``fit`` picks by
  default when the factors fit in 2 GiB;
* the alpha cache, ``alpha = K^{-1} y`` per bucket (the light store with
  ``cache_alpha=True``, and the hybrid store), for the exact mean-only
  path;
* the hybrid store's per-bucket factors, ``(Lf, alpha)`` for the buckets
  the greedy budget chose and ``None`` for the rest;
* after ``fit(mesh=...)``, the giant leaves' row-sharded factors
  (``_giant``), which predict through the distributed solves.

``V`` is the number of children per sum node and ``K`` the number of
splits per split node.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from . import fit as fitlib
from . import infer as inferlib
from .config import EPS, DSMGPConfig, as_2d, default_dtype
from .gp import GaussianProcess  # re-export
from .hyper import initial_vector, make_layout, noise_from, unpack
from .kernels import IsoSE, gram, gram_diag, normalize_kernels
from .plan import (_round_up, bucket_batches, bucketize, build_schedule,
                   compile_tree)
from .tree import build_tree, num_mixtures, stats

__all__ = ["DSMGP", "PoE", "GPoE", "RBCM", "GaussianProcess", "build_dsmgp",
           "build_poe", "build_bcm"]

#: ``fit(store='auto')`` keeps the monolithic factors up to this many bytes
FULL_STORE_BYTES = 2 << 30

_log = logging.getLogger(__name__)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BaseModel:
    """Shared state/behaviour of the tree-of-experts models."""

    def __init__(self, root, plan, layout, theta, dtype, device, X, y,
                 schedule=None):
        self.root = root  # host-side tree (checkpoints, introspection)
        self.X = X  # raw training inputs (≙ getx, common.jl:315-317)
        self.y = y  # raw training targets (≙ gety, common.jl:319-321)
        self.plan = plan
        self.schedule = schedule  # plan.SharedSchedule, or None
        self.layout = layout
        self.dtype = dtype
        self.device = torch.device(device)
        self.theta = torch.as_tensor(theta, dtype=dtype, device=self.device)
        self.logweights = torch.as_tensor(plan.init_logweights, dtype=dtype,
                                          device=self.device)
        self._leaf_mll = None  # leaf mlls [L] of the last fit
        self.posterior = None  # the full store's LeafPosterior
        self._alpha_cache = None  # per-bucket alpha weights
        self._bucket_factors = None  # per-bucket (Lf, alpha) or None
        self._batch = None  # the monolithic batch, built on first use
        # after fit(mesh=...): leaf id -> (row block of its factor, alpha,
        # x and centred y padded to the mesh tiling, n, kernel id)
        self._giant = None
        self._giant_cfg = None  # (mesh, axis, block)
        self._giant_normal = None  # (normal buckets, their leaf ids)
        self.last_fit_diagnostics = {}
        self.bucket_spec = bucketize(plan)
        self.bucket_batches = bucket_batches(plan, self.bucket_spec, X, y,
                                             dtype, self.device)

    @property
    def batch(self):
        """The monolithic ``[L, nmax]`` leaf batch on the model's device,
        built on first use: only the whole-model fits and the full store
        read it, and at scale it is mostly padding."""
        if self._batch is None:
            self._batch = self.plan.leaf_batch(self.X, self.y, self.dtype,
                                               self.device)
        return self._batch

    @property
    def D(self):
        """The leaf-overlap matrix (≙ ``model.D``): dense, scipy CSR or
        ``plan.MixtureOverlap``; None when built with ``overlap=False``."""
        return self.plan.overlap

    @property
    def num_leaves(self) -> int:
        return self.plan.num_leaves

    def num_mixtures(self) -> int:
        return num_mixtures(self.root)

    def stats(self) -> dict:
        """Tree statistics (≙ ``stats``, ``common.jl:365-395``)."""
        return stats(self.root)

    # -- fitting ------------------------------------------------------------
    def _factor_bytes(self) -> int:
        """Footprint of the full store's monolithic factors ``[L, nmax,
        nmax]``."""
        n = self.plan.nmax
        return self.num_leaves * n * n * self.dtype.itemsize

    def _bucket_factor_bytes(self) -> int:
        """The bucketed factor footprint ``Σ_b count_b · nmax_b²`` in bytes:
        what the hybrid store costs with every bucket cached."""
        item = self.dtype.itemsize
        return sum(b.num_leaves * b.nmax * b.nmax * item
                   for b in self.bucket_batches)

    def _hybrid_cached_flags(self, factor_budget: int):
        """Greedy bucket selection for the hybrid store: the FLOPs a cached
        ``[n, n]`` factor saves per byte grow with n, so the largest
        buckets go first while they fit the budget."""
        item = self.dtype.itemsize
        order = sorted(range(len(self.bucket_batches)),
                       key=lambda k: -self.bucket_batches[k].nmax)
        budget = int(factor_budget)
        cached = [False] * len(self.bucket_batches)
        for k in order:
            b = self.bucket_batches[k]
            fb = b.num_leaves * b.nmax * b.nmax * item
            if fb <= budget:
                cached[k] = True
                budget -= fb
        return tuple(cached)

    def _fit_hybrid(self, factor_budget: int, chunk=None):
        """Bucketed fit that keeps the factors (and alphas) of the buckets
        :meth:`_hybrid_cached_flags` picks, for O(n²t) prediction; the rest
        fit with alphas only and stream their factors per predict."""
        cached = self._hybrid_cached_flags(factor_budget)
        dev = self.device
        mll = torch.zeros((self.num_leaves,), dtype=self.dtype, device=dev)
        alphas, factors = [], []
        for want, b, ids in zip(cached, self.bucket_batches,
                                self.bucket_spec.leaf_ids):
            idx = fitlib._leaf_index(ids, dev)
            th = self.theta if self.theta.ndim == 1 else self.theta[idx]
            c = chunk if chunk is not None else fitlib._bucket_chunk(
                b.nmax, b.num_leaves, b.x.dtype)
            if want:
                mll[idx], a_b, Lf_b = fitlib.streamed_leaf_factors(
                    self.layout, th, b, chunk=c)
                factors.append((Lf_b, a_b))
            else:
                mll[idx], a_b = fitlib.streamed_leaf_alphas(
                    self.layout, th, b, chunk=c)
                factors.append(None)
            alphas.append(a_b)
        self._leaf_mll = mll
        self._alpha_cache = tuple(alphas)
        self._bucket_factors = tuple(factors)
        item = self.dtype.itemsize
        self.last_fit_diagnostics = {
            "cached_buckets": int(sum(cached)),
            "cached_bytes": sum(b.num_leaves * b.nmax * b.nmax * item
                                for c, b in zip(cached, self.bucket_batches)
                                if c),
        }

    def fit(self, method: str = "auto", safe: bool = True,
            store: str = "auto", chunk=None, mesh=None,
            giant_leaf_bytes: int = 4 << 30, block: int = 256, axis=None,
            cache_alpha: bool = True,
            factor_budget: Optional[int] = None) -> float:
        """Refit all leaf posteriors; returns wall-clock seconds like the
        reference ``fit!`` (``fit.jl:88,121``), the device synchronized.

        ``method``: ``'batched'`` factors every leaf afresh (≙
        ``fit_naive!``); ``'shared'`` runs the factor-reuse schedule (copy,
        Givens delete, delete-then-continue; ≙ ``fit!``), with ``safe``
        PSD fallbacks counted in ``last_fit_diagnostics``; ``'auto'`` is
        batched, as in the JAX package.

        ``store``: ``'full'`` keeps the monolithic ``[L, nmax, nmax]``
        factors (``posterior``) for repeated prediction; ``'light'`` keeps
        the leaf mlls and, with ``cache_alpha``, the per-leaf alpha
        weights that ``predict(xt, return_var=False)`` serves the exact
        mean from (prediction otherwise refactors chunk by chunk);
        ``'hybrid'`` also keeps the factors of the largest buckets that fit
        ``factor_budget`` bytes (default: all of them); ``'auto'`` is
        ``'full'`` when its factors fit in 2 GiB, else ``'light'``. The
        shared schedule needs the full store: on the light store it falls
        back to the batched fit with a warning, the hybrid store refuses
        it. ``chunk`` bounds the leaves factored at once.

        ``mesh`` (a ``DeviceMesh``; every rank calls ``fit`` alike): leaves
        whose one covariance exceeds ``giant_leaf_bytes`` fit through the
        distributed blocked Cholesky (``parallel.dist_chol``), the ``[n,
        n]`` matrix row-sharded over the mesh ``axis`` (required on a mesh
        of several axes) in panels of ``block``: experts past one device's
        memory. The other buckets take the light fit (with the alpha cache
        under ``cache_alpha``) on every rank; the giant factors stay
        sharded for prediction. ``last_fit_diagnostics
        ['distributed_leaves']`` counts the giant leaves."""
        if mesh is not None:
            # the bucketed light fit with giant-leaf routing: it has no
            # shared schedule and no full store
            if method not in ("auto", "batched") or store == "full":
                raise ValueError(
                    "fit(mesh=...) runs the bucketed light fit with "
                    "giant-leaf routing; method='shared' and store='full' "
                    "are not available on this path"
                )
            return self._fit_mesh(mesh, giant_leaf_bytes, block, chunk,
                                  axis=axis, cache_alpha=cache_alpha)
        if method not in ("auto", "batched", "shared"):
            raise ValueError(f"unknown method {method!r}")
        if store not in ("auto", "full", "light", "hybrid"):
            raise ValueError(f"unknown store {store!r}")
        if store == "hybrid" and method == "shared":
            raise ValueError(
                "fit(store='hybrid') runs the bucketed fit; method='shared' "
                "needs the monolithic store='full'")
        if store == "auto":
            store = ("full" if self._factor_bytes() <= FULL_STORE_BYTES
                     else "light")
        if method == "shared" and self.theta.ndim == 2:
            # every derivation assumes one tied covariance; the reference
            # refits each leaf under its own hypers (finetuning.jl:74-85)
            _log.warning(
                "fit(method='shared') requested with per-leaf (untied) "
                "hypers; factor reuse is invalid, using method='batched'")
            method = "batched"
        if method == "shared" and self.schedule is None:
            raise ValueError(
                "fit(method='shared') needs the factor-reuse schedule, but "
                "this model was built with overlap=False; rebuild with "
                "overlap=True")
        if method == "shared" and store == "light":
            _log.warning(
                "fit(method='shared') requested with store='light'; the "
                "light path streams fresh factorizations (the schedule "
                "needs the full store), using the batched light path")
        # drop what the last fit kept before this one allocates its own
        self._leaf_mll = self._alpha_cache = self._bucket_factors = None
        self.posterior = self._giant = None
        t0 = time.perf_counter()
        if store == "hybrid":
            if factor_budget is None:
                factor_budget = self._bucket_factor_bytes()
            self._fit_hybrid(factor_budget, chunk=chunk)
        elif store == "light":
            args = (self.layout, self.theta, self.bucket_batches,
                    self.bucket_spec.leaf_ids, self.num_leaves)
            if cache_alpha:
                self._leaf_mll, self._alpha_cache = fitlib.bucketed_leaf_alphas(
                    *args, chunk=chunk)
            else:
                self._leaf_mll = fitlib.bucketed_leaf_mlls(*args, chunk=chunk)
            self.last_fit_diagnostics = {"delete_fallbacks": 0,
                                         "continue_fallbacks": 0}
        else:
            post, (dfb, cfb) = fitlib.fit(
                self.layout, self.theta, self.batch, schedule=self.schedule,
                method=method, chunk=chunk, safe=safe)
            self.posterior = post
            self._leaf_mll = post.mll
            self.last_fit_diagnostics = {"delete_fallbacks": dfb,
                                         "continue_fallbacks": cfb}
            if dfb or cfb:
                # ≙ the reference's @warn + refactorization of failed
                # derived factors (fit.jl:197-201, 280-290)
                _log.warning(
                    "shared-Cholesky fit: %d delete / %d continue derived "
                    "factors failed the PSD guard and were refactored",
                    dfb, cfb)
        _sync(self.device)
        return time.perf_counter() - t0

    def _fit_mesh(self, mesh, giant_leaf_bytes: int, block: int, chunk=None,
                  axis=None, cache_alpha: bool = True) -> float:
        """The light fit with the leaves of every bucket past
        ``giant_leaf_bytes`` (``nmax² · itemsize``) routed through
        ``dist_chol.sharded_gp_fit``, each padded to the ``ndev * block``
        tiling (see :meth:`fit`)."""
        from .parallel.comm import resolve
        from .parallel.dist_chol import sharded_gp_fit

        if self.X is None or self.y is None:
            raise ValueError(
                "fit(mesh=...) needs the raw training data; build the "
                "model through the standard builders"
            )
        self._leaf_mll = self._alpha_cache = self._bucket_factors = None
        self.posterior = self._giant = None
        t0 = time.perf_counter()
        ax = resolve(mesh, axis, "fit(mesh=...) shards giant leaves")
        tile = ax.ndev * block
        item = self.dtype.itemsize
        dev = self.device
        mll = torch.zeros((self.num_leaves,), dtype=self.dtype, device=dev)
        giant = {}
        normal_batches, normal_ids = [], []
        for b, ids in zip(self.bucket_batches, self.bucket_spec.leaf_ids):
            if b.nmax * b.nmax * item <= giant_leaf_bytes:
                normal_batches.append(b)
                normal_ids.append(ids)
                continue
            for leaf_id in map(int, ids):
                obs = self.plan.leaf_obs[leaf_id]
                n = obs.size
                npad = _round_up(n, tile)
                xp = torch.zeros((npad, self.plan.dim), dtype=self.dtype,
                                 device=dev)
                xp[:n] = torch.as_tensor(self.X[obs], dtype=self.dtype)
                yp = torch.zeros((npad,), dtype=self.dtype, device=dev)
                yp[:n] = torch.as_tensor(
                    self.y[obs] - self.plan.leaf_mean[leaf_id], dtype=self.dtype)
                kid = int(self.plan.leaf_kernelid[leaf_id])
                th = self.theta if self.theta.ndim == 1 else self.theta[leaf_id]
                logl, logsigma, lognoise = unpack(self.layout, th, kid)
                alpha, mll[leaf_id], Lf = sharded_gp_fit(
                    xp, yp, logl, logsigma, lognoise, mesh, axis=ax.name,
                    block=block, valid_n=n, kind=self.layout.kinds[kid],
                    return_factor=True)
                # whole alpha on every rank: the mean-only path's K_nt'α
                giant[leaf_id] = (Lf, ax.gather_rows(alpha), xp, yp, n, kid)
        if normal_batches:
            args = (self.layout, self.theta, normal_batches, normal_ids,
                    self.num_leaves)
            if cache_alpha:
                mll_n, self._alpha_cache = fitlib.bucketed_leaf_alphas(
                    *args, chunk=chunk)  # in normal-bucket order
            else:
                mll_n = fitlib.bucketed_leaf_mlls(*args, chunk=chunk)
            for ids in normal_ids:
                idx = fitlib._leaf_index(ids, dev)
                mll[idx] = mll_n[idx]
        self._leaf_mll = mll
        self._giant = giant
        self._giant_cfg = (mesh, ax.name, block)
        self._giant_normal = (normal_batches, normal_ids)
        self.last_fit_diagnostics = {
            "delete_fallbacks": 0, "continue_fallbacks": 0,
            "distributed_leaves": len(giant),
        }
        _sync(dev)
        return time.perf_counter() - t0

    def _giant_normal_predict(self, xt, ti=None):
        """Streamed moments ``(mu, var) [L, T|tmax]`` of the normal buckets
        after ``fit(mesh=...)``, the giant leaves' rows left 0 / 1 for the
        caller to fill; ``ti`` routes as in ``fit.bucketed_streamed_predict``."""
        nb, nids = self._giant_normal
        if not nb:
            T = xt.shape[0] if ti is None else ti.shape[1]
            shape = (self.num_leaves, T)
            return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                    torch.ones(shape, dtype=self.dtype, device=self.device))
        mu, var, _ = fitlib.bucketed_streamed_predict(
            self.layout, self.theta, nb, nids, self.num_leaves, xt, ti)
        return mu, var

    def _giant_leaf_predict(self, leaf_id: int, xt_leaf):
        """Distributed prediction of one giant leaf at its (routed) test
        points (``dist_chol.sharded_gp_predict``)."""
        from .parallel.dist_chol import sharded_gp_predict

        mesh, axis, block = self._giant_cfg
        Lf, _, xp, yp, n, kid = self._giant[leaf_id]
        th = self.theta if self.theta.ndim == 1 else self.theta[leaf_id]
        logl, logsigma, lognoise = unpack(self.layout, th, kid)
        return sharded_gp_predict(
            Lf, xp, yp, logl, logsigma, lognoise, xt_leaf, mesh, axis=axis,
            block=block, mean=float(self.plan.leaf_mean[leaf_id]), valid_n=n,
            kind=self.layout.kinds[kid])

    def fit_naive(self) -> float:
        """≙ ``fit_naive!`` (``fit.jl:294-304``)."""
        return self.fit(method="batched")

    def rebuild_schedule(self, tau: float = 0.05):
        """Recompile the shared-Cholesky schedule with a new τ stability
        threshold (≙ the reference's per-call ``fit!(model; τ)``,
        ``fit.jl:67,174,256``; the schedule is static here, so a τ change
        is an explicit host-side rebuild)."""
        self.schedule = build_schedule(self.plan, tau=tau)

    def leaf_mlls(self) -> torch.Tensor:
        """Leaf marginal log-likelihoods ``[L]`` (fits first if needed)."""
        if self._leaf_mll is None:
            self.fit()
        return self._leaf_mll

    # -- likelihood / weights -------------------------------------------------
    def mll(self) -> float:
        """Root marginal log-likelihood with uniform sum weights
        (≙ ``mll(model)``, ``optimize.jl:18-25``)."""
        return float(inferlib.root_mll(self.plan, self.leaf_mlls()))

    def update(self) -> float:
        """Posterior weight update; returns root log evidence
        (≙ ``update!``, ``common.jl:323-334``)."""
        self.logweights, z = inferlib.update_weights(self.plan, self.leaf_mlls())
        return float(z)

    def infer(self) -> float:
        """≙ ``infer!`` (``common.jl:336-355``): the posterior update of
        the leaf-level kernel-mixture sums only; returns root log
        evidence."""
        self.logweights, z = inferlib.infer_weights(self.plan, self.leaf_mlls())
        return float(z)

    def reset_weights(self):
        """≙ ``reset_weights!`` (``common.jl:357-363``)."""
        self.logweights = inferlib.reset_weights(self.plan, self.device)

    # -- parameters -----------------------------------------------------------
    def get_params(self) -> np.ndarray:
        """Flat tied hyper vector ``[logl..., logsigma, lognoise]`` per kernel."""
        return self.theta.cpu().numpy()

    def set_params(self, theta):
        """≙ ``setparams!(root, hyp)`` (``optimize.jl:188-198``); drops the
        fit, both caches and the giant leaves' factors."""
        self.theta = torch.as_tensor(np.array(theta), dtype=self.dtype,
                                     device=self.device)
        self._leaf_mll = self._alpha_cache = self._bucket_factors = None
        self.posterior = self._giant = None

    # -- prediction helpers -----------------------------------------------
    def _as_test(self, xt):
        return torch.as_tensor(as_2d(np.asarray(xt)), dtype=self.dtype,
                               device=self.device)

    def _leaf_predict_all(self, xt):
        """Per-leaf moments at shared test points ``(mu, var) [L, T]``:
        from the full or the hybrid store where the last fit kept factors,
        distributed for the giant leaves of ``fit(mesh=...)``, else
        streamed."""
        self.leaf_mlls()
        if self._giant:
            mu, var = self._giant_normal_predict(xt)
            for leaf_id in self._giant:
                mu[leaf_id], var[leaf_id] = self._giant_leaf_predict(leaf_id, xt)
            return mu, var
        if self.posterior is not None:
            return fitlib.cached_leaf_predict(self.layout, self.theta,
                                              self.batch, self.posterior.chol, xt)
        args = (self.layout, self.theta, self.bucket_batches,
                self.bucket_spec.leaf_ids, self.num_leaves)
        if self._bucket_factors is not None:
            return fitlib.bucketed_hybrid_predict(*args, self._bucket_factors, xt)
        mu, var, _ = fitlib.bucketed_streamed_predict(*args, xt)
        return mu, var

    def _route(self, xt_np, pad_multiple: int = 8):
        """Host-side routing of test points to their active leaves
        (≙ the ``getchild`` recursion): padded ``(tidx int32, tmask bool)
        [L, tmax]``. ``tmax`` rounds up to a power of two up to 256 and to a
        multiple of 64 above, as in the JAX package."""
        from .utils.native import pack_routes, route_box

        member = route_box(xt_np, self.plan.leaf_lb, self.plan.leaf_ub)  # [T, L]
        t = max(int(member.sum(axis=0).max()), pad_multiple)
        tmax = 1 << (t - 1).bit_length() if t <= 256 else _round_up(t, 64)
        return pack_routes(member, tmax)


class DSMGP(BaseModel):
    """Deep structured mixture of GPs (≙ ``DSMGP``,
    ``DeepStructuredMixtures.jl:108-112``)."""

    def predict(self, xt, refine_steps: int = 0, return_var: bool = True):
        """Routed exact mixture prediction ``(mean [T], var [T])``, float64
        tensors on the model's device (≙ ``predict(::DSMGP)``,
        ``common.jl:294-304``).

        Test points are routed on the host to their active leaves. With
        ``return_var=False`` and an alpha cache (the light store with
        ``cache_alpha=True``, or the hybrid store) the mean alone comes from
        one O(n·t) cross-gram pass per leaf. Otherwise the full store
        predicts from its monolithic factors, the buckets of the hybrid
        store from their cached factors, and every other bucket refactors
        its leaves chunk by chunk; the moments are matched in log space.
        The cached solves run in float64 against the float32 factors
        (``fit.cached_leaf_predict``). ``return_var=False`` returns the
        mean alone.

        After ``fit(mesh=...)`` the normal buckets stream (or, mean only,
        take their alphas) and the giant leaves predict through the
        distributed solves (their mean only: ``m + K_nt'α``);
        ``refine_steps`` raises there.

        ``refine_steps > 0``: mixed-precision refinement of the leaf solves
        against true-K float64 residuals (``ops/refine.py``). It always
        takes the streamed path, whatever the store (the mean-only alpha
        path and the cached factors are skipped), and its float64 leaf
        moments go through the float64 combine."""
        xt_np = as_2d(np.asarray(xt))
        T = xt_np.shape[0]
        tidx, tmask = self._route(xt_np)
        self.leaf_mlls()
        ti = torch.as_tensor(tidx, dtype=torch.long, device=self.device)
        tm = torch.as_tensor(tmask, device=self.device)
        xt_d = torch.as_tensor(xt_np, dtype=self.dtype, device=self.device)
        args = (self.layout, self.theta, self.bucket_batches,
                self.bucket_spec.leaf_ids, self.num_leaves)
        if self._giant:
            if refine_steps:
                raise ValueError(
                    "refine_steps is not supported after fit(mesh=...) — "
                    "the distributed giant-leaf solves have no refinement "
                    "path; refit without a mesh for refined prediction"
                )
            if not return_var and self._alpha_cache is not None:
                mu = self._giant_alpha_mean(xt_d, ti)
                mean, _ = _routed_moment_match(
                    self.plan, mu, torch.ones_like(mu), self.logweights, ti,
                    tm, T)
                return mean
            mu, var = self._giant_normal_predict(xt_d, ti)
            for leaf_id in self._giant:
                mu[leaf_id], var[leaf_id] = self._giant_leaf_predict(
                    leaf_id, xt_d[ti[leaf_id]])
            mean, var = _routed_moment_match(self.plan, mu, var,
                                             self.logweights, ti, tm, T)
            return (mean, var) if return_var else mean
        if not return_var and not refine_steps and self._alpha_cache is not None:
            mu = fitlib.bucketed_alpha_mean(*args, self._alpha_cache, xt_d, ti)
            mean, _ = _routed_moment_match(self.plan, mu, torch.ones_like(mu),
                                           self.logweights, ti, tm, T)
            return mean
        if refine_steps:
            mu, var, _ = fitlib.bucketed_streamed_predict(
                *args, xt_d, ti, refine_steps=refine_steps)
        elif self.posterior is not None:
            mu, var = fitlib.cached_leaf_predict(
                self.layout, self.theta, self.batch, self.posterior.chol, xt_d,
                ti)
        elif self._bucket_factors is not None:
            mu, var = fitlib.bucketed_hybrid_predict(
                *args, self._bucket_factors, xt_d, ti)
        else:
            mu, var, _ = fitlib.bucketed_streamed_predict(*args, xt_d, ti)
        mean, var = _routed_moment_match(self.plan, mu, var, self.logweights,
                                         ti, tm, T)
        return (mean, var) if return_var else mean


    def _giant_alpha_mean(self, xt, ti):
        """Routed means ``[L, tmax]`` after ``fit(mesh=..., cache_alpha=
        True)``: the normal buckets from their cached alphas
        (``fit.bucketed_alpha_mean``), the giant leaves from theirs, ``μ = m
        + K_nt'α`` (``gaussianprocess.jl:118``); no factorization."""
        nb, nids = self._giant_normal
        mu = fitlib.bucketed_alpha_mean(self.layout, self.theta, nb, nids,
                                        self.num_leaves, self._alpha_cache,
                                        xt, ti)
        for leaf_id, (_, alpha, xp, _, n, kid) in self._giant.items():
            th = self.theta if self.theta.ndim == 1 else self.theta[leaf_id]
            logl, logsigma, _ = unpack(self.layout, th, kid)
            Knt = gram(self.layout.kinds[kid], logl, logsigma, xp[:n],
                       xt[ti[leaf_id]])  # [n, tmax]
            mu[leaf_id] = float(self.plan.leaf_mean[leaf_id]) + Knt.mT @ alpha[:n]
        return mu


class PoE(BaseModel):
    """Product of experts (≙ ``PoE``, ``DeepStructuredMixtures.jl:114-118``)."""

    def predict(self, xt):
        mu, var = self._leaf_predict_all(self._as_test(xt))
        return inferlib.predict_poe(mu, var)


class GPoE(BaseModel):
    """Generalized PoE (≙ ``gPoE``, ``DeepStructuredMixtures.jl:120-124``)."""

    def predict(self, xt):
        mu, var = self._leaf_predict_all(self._as_test(xt))
        return inferlib.predict_gpoe(self.plan, mu, var)


class RBCM(BaseModel):
    """Robust Bayesian committee machine (≙ ``rBCM``,
    ``DeepStructuredMixtures.jl:126-130``)."""

    def predict(self, xt):
        xt = self._as_test(xt)
        mu, var = self._leaf_predict_all(xt)
        # prior variance of the first (leftmost) leaf GP (≙ leftGP +
        # kernelmatrix diag + noise, common.jl:227-228); under per-leaf
        # hypers that is leaf 0's row
        kid = int(self.plan.leaf_kernelid[0])
        t = self.theta if self.theta.ndim == 1 else self.theta[0]
        logl, logsigma, lognoise = unpack(self.layout, t, kid)
        prior = gram_diag(self.layout.kinds[kid], logl, logsigma, xt) + noise_from(
            lognoise)
        return inferlib.predict_rbcm(self.plan, mu, var, prior)


def _routed_moment_match(plan, mu, var, logweights, tidx, tmask, T):
    """Log-space mixture moment matching over routed (leaf, point) pairs
    (≙ ``common.jl:275-302``) with the reference's ``μmin − 1`` shift.
    Runs in float64 whatever the leaf dtype: the ``E[μ²] − mean²``
    cancellation would otherwise floor the end-to-end variance of f32
    leaves. ``tidx`` is int64; returns ``(mean [T], var [T])``."""
    pw = inferlib.path_logweights(plan, logweights.double())  # [L]
    seg = tidx.reshape(-1)
    msk = tmask.reshape(-1)
    muf = mu.double().reshape(-1)
    varf = torch.clamp_min(var.double(), EPS).reshape(-1)
    wf = pw[:, None].expand(mu.shape).reshape(-1)

    def seg_reduce(x, fill, reduce):
        init = torch.full((T,), fill, dtype=x.dtype, device=x.device)
        return init.scatter_reduce(0, seg, torch.where(msk, x, fill),
                                   reduce=reduce, include_self=True)

    shift = seg_reduce(muf, torch.inf, "amin") - 1.0
    w = torch.where(msk, wf, -torch.inf)

    def seg_lse(x):
        m = seg_reduce(x, -torch.inf, "amax")
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(msk, torch.exp(x - m_safe[seg]), 0.0)
        s = torch.zeros((T,), dtype=x.dtype, device=x.device).index_add_(0, seg, e)
        return m_safe + torch.log(s)

    lmu = seg_lse(w + torch.log(muf - shift[seg]))
    lmu2 = seg_lse(w + torch.log(torch.clamp_min(muf * muf, 1e-300)))
    lvar = seg_lse(w + torch.log(varf))

    mean = torch.exp(lmu) + shift
    v = torch.exp(lvar) + (torch.exp(lmu2) - mean * mean)
    return mean, v


def _resolve_pad_multiple(pad_multiple, dtype, kernels, device) -> int:
    """Default leaf padding of the plan's global ``nmax``: 128 on CUDA in
    float32 with a single IsoSE kernel, so that the monolithic batch is in
    the fused kernel's domain (``ops/fused_chol.supported``) up to nmax
    1024; else 8. The size buckets do not read it."""
    if pad_multiple is not None:
        return pad_multiple
    kinds = tuple(k.kind for k in normalize_kernels(kernels))
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and kinds == ("iso_se",)):
        return 128
    return 8


def _build(cls, x, y, config: DSMGPConfig, device, seed, dtype, do_fit, tau,
           pad_multiple, overlap, overlap_format):
    x = as_2d(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    dtype = dtype or default_dtype(device)
    root = build_tree(x, y, config, np.random.default_rng(seed))
    plan = compile_tree(
        root, x, overlap=overlap, overlap_format=overlap_format,
        pad_multiple=_resolve_pad_multiple(pad_multiple, dtype,
                                           config.kernels, device))
    kernels = normalize_kernels(config.kernels)
    model = cls(root, plan, make_layout(kernels),
                initial_vector(kernels, config.observation_noise), dtype,
                device, x, y,
                schedule=build_schedule(plan, tau=tau) if overlap else None)
    if do_fit:
        model.fit()  # initial posterior fit (≙ treeStructure.jl:434)
    return model


def build_dsmgp(
    x,
    y,
    V: int = 3,
    K: int = 4,
    *,
    device,
    eps: float = 0.5,
    M: int = 30,
    depth: int = 2,
    kernel=None,
    mean_fun=None,
    log_noise: float = 1.0,
    sum_root: bool = True,
    tau: float = 0.05,
    seed=None,
    dtype=None,
    do_fit: bool = True,
    pad_multiple: Optional[int] = None,
    overlap: bool = True,
    overlap_format: str = "auto",
) -> DSMGP:
    """Build a DSMGP on ``device`` (≙ ``buildDSMGP``,
    ``treeStructure.jl:328-339``; the JAX package's ``build_dsmgp``).

    ``V``: children per sum node; ``K``: splits per split node; ``eps``:
    split-position noise; ``M``: min observations per expert; ``depth``:
    max sum depth; ``tau``: the shared schedule's deletion threshold.
    ``dtype`` defaults to float64 on the CPU and float32 on CUDA;
    ``pad_multiple`` to :func:`_resolve_pad_multiple`. ``overlap=False``
    skips the leaf-overlap analysis and the schedule (then
    ``fit(method='shared')`` and ``rebuild_schedule`` raise);
    ``overlap_format``: ``'dense'``, ``'sparse'`` (scipy CSR, or
    ``plan.MixtureOverlap`` on kernel mixtures) or ``'auto'`` (sparse
    above ``plan.DENSE_OVERLAP_MAX`` leaves).
    """
    kernel = kernel if kernel is not None else IsoSE(1.0, 1.0)
    config = DSMGPConfig(mean_fun, kernel, log_noise, M, K, V, depth, eps, sum_root)
    return _build(DSMGP, x, y, config, device, seed, dtype, do_fit, tau,
                  pad_multiple, overlap, overlap_format)


def build_poe(x, y, K: int = 4, *, device, generalized: bool = False,
              eps: float = 0.0, M: int = 30, depth: int = 2, kernel=None,
              mean_fun=None, log_noise: float = 1.0, tau: float = 0.05,
              seed=None, dtype=None, do_fit: bool = True,
              pad_multiple: Optional[int] = None, overlap: bool = True,
              overlap_format: str = "auto"):
    """Build a (generalized) product of experts on ``device``
    (≙ ``buildPoE``, ``treeStructure.jl:360-371``): a split-only tree with
    ``K`` splits per node. Options as :func:`build_dsmgp`."""
    kernel = kernel if kernel is not None else IsoSE(1.0, 1.0)
    config = DSMGPConfig(mean_fun, kernel, log_noise, M, K, 1, depth, eps, False)
    return _build(GPoE if generalized else PoE, x, y, config, device, seed,
                  dtype, do_fit, tau, pad_multiple, overlap, overlap_format)


def build_bcm(x, y, K: int = 4, *, device, eps: float = 0.0, M: int = 30,
              depth: int = 2, kernel=None, mean_fun=None,
              log_noise: float = 1.0, tau: float = 0.05, seed=None,
              dtype=None, do_fit: bool = True,
              pad_multiple: Optional[int] = None, overlap: bool = True,
              overlap_format: str = "auto") -> RBCM:
    """Build a robust Bayesian committee machine on ``device``
    (≙ ``buildBCM``, ``treeStructure.jl:392-403``). Options as
    :func:`build_dsmgp`."""
    kernel = kernel if kernel is not None else IsoSE(1.0, 1.0)
    config = DSMGPConfig(mean_fun, kernel, log_noise, M, K, 1, depth, eps, False)
    return _build(RBCM, x, y, config, device, seed, dtype, do_fit, tau,
                  pad_multiple, overlap, overlap_format)
