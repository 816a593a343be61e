"""User-facing model and builder (counterpart of the fit → update →
routed-predict part of ``deepstructuredmixtures_tpu/models.py``).

A model holds the compiled plan, the size-bucketed leaf batches on its
device, the flat tied hyper vector, the flat sum-edge log-weights and the
leaf mlls of the last fit (the light store: factors are never kept).
``V`` is the number of children per sum node and ``K`` the number of
splits per split node.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import fit as fitlib
from . import infer as inferlib
from .config import EPS, DSMGPConfig, as_2d, default_dtype
from .hyper import initial_vector, make_layout
from .kernels import IsoSE, normalize_kernels
from .plan import _round_up, bucket_batches, bucketize, compile_tree
from .tree import build_tree

__all__ = ["DSMGP", "build_dsmgp"]

#: options of the JAX package that later work brings, with the ROADMAP item
TODO = {
    "overlap": ("build_dsmgp(overlap=True) is not ported yet: ROADMAP Queue 1 "
                "item 1 (overlap analysis and shared-Cholesky schedule)"),
    "method": "fit(method='shared') is not ported yet: ROADMAP Queue 1 item 1",
    "store": ("fit(store='full'/'hybrid') is not ported yet: ROADMAP Queue 1 "
              "item 3"),
    "cache_alpha": ("fit(cache_alpha=True) is not ported yet: ROADMAP Queue 1 "
                    "item 2 (mean-only serving)"),
    "return_var": ("predict(return_var=False) is not ported yet: ROADMAP "
                   "Queue 1 item 2 (mean-only serving)"),
    "mesh": "fit(mesh=...) is not ported yet: ROADMAP Queue 1 item 11",
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BaseModel:
    """Shared state/behaviour of the tree-of-experts models."""

    def __init__(self, plan, layout, theta, dtype, device, X, y):
        self.plan = plan
        self.layout = layout
        self.dtype = dtype
        self.device = torch.device(device)
        self.theta = torch.as_tensor(theta, dtype=dtype, device=self.device)
        self.logweights = torch.as_tensor(plan.init_logweights, dtype=dtype,
                                          device=self.device)
        self._leaf_mll = None  # leaf mlls [L] of the last fit
        self.bucket_spec = bucketize(plan)
        self.bucket_batches = bucket_batches(plan, self.bucket_spec, X, y,
                                             dtype, self.device)

    @property
    def num_leaves(self) -> int:
        return self.plan.num_leaves

    # -- fitting ------------------------------------------------------------
    def fit(self, method: str = "auto", store: str = "auto", chunk=None,
            mesh=None, cache_alpha: bool = False) -> float:
        """Refit all leaf posteriors; returns wall-clock seconds like the
        reference ``fit!`` (``fit.jl:88,121``), the device synchronized.

        The light store: leaf mlls bucket by bucket, factors streamed and
        dropped (``store='auto'`` resolves to it). ``chunk`` bounds the
        leaves factored at once."""
        if method not in ("auto", "batched"):
            raise NotImplementedError(TODO["method"])
        if store in ("full", "hybrid"):
            raise NotImplementedError(TODO["store"])
        if store not in ("auto", "light"):
            raise ValueError(f"unknown store {store!r}")
        if cache_alpha:
            raise NotImplementedError(TODO["cache_alpha"])
        if mesh is not None:
            raise NotImplementedError(TODO["mesh"])
        t0 = time.perf_counter()
        mll = fitlib.bucketed_leaf_mlls(
            self.layout, self.theta, self.bucket_batches,
            self.bucket_spec.leaf_ids, self.num_leaves, chunk=chunk)
        _sync(self.device)
        self._leaf_mll = mll
        return time.perf_counter() - t0

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

    # -- parameters -----------------------------------------------------------
    def get_params(self) -> np.ndarray:
        """Flat tied hyper vector ``[logl..., logsigma, lognoise]`` per kernel."""
        return self.theta.cpu().numpy()

    def set_params(self, theta):
        """≙ ``setparams!(root, hyp)`` (``optimize.jl:188-198``); drops the
        fit."""
        self.theta = torch.as_tensor(np.array(theta), dtype=self.dtype,
                                     device=self.device)
        self._leaf_mll = None

    # -- prediction helpers -----------------------------------------------
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

        Test points are routed on the host to their active leaves; each
        bucket then refactors its leaves chunk by chunk and predicts its
        routed points, and the moments are matched in log space."""
        if refine_steps:
            raise NotImplementedError(fitlib.REFINE_TODO)
        if not return_var:
            raise NotImplementedError(TODO["return_var"])
        xt_np = as_2d(np.asarray(xt))
        T = xt_np.shape[0]
        tidx, tmask = self._route(xt_np)
        self.leaf_mlls()
        ti = torch.as_tensor(tidx, dtype=torch.long, device=self.device)
        tm = torch.as_tensor(tmask, device=self.device)
        xt_d = torch.as_tensor(xt_np, dtype=self.dtype, device=self.device)
        mu, var, _ = fitlib.bucketed_streamed_predict(
            self.layout, self.theta, self.bucket_batches,
            self.bucket_spec.leaf_ids, self.num_leaves, xt_d, ti)
        return _routed_moment_match(self.plan, mu, var, self.logweights,
                                    ti, tm, T)


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
    seed=None,
    dtype=None,
    do_fit: bool = True,
    overlap: bool = False,
) -> DSMGP:
    """Build a DSMGP on ``device`` (≙ ``buildDSMGP``,
    ``treeStructure.jl:328-339``; the JAX package's ``build_dsmgp``).

    ``V``: children per sum node; ``K``: splits per split node; ``eps``:
    split-position noise; ``M``: min observations per expert; ``depth``:
    max sum depth. ``dtype`` defaults to float64 on the CPU and float32 on
    CUDA. ``overlap=True`` (the leaf-overlap analysis) is not ported yet.
    """
    if overlap:
        raise NotImplementedError(TODO["overlap"])
    kernel = kernel if kernel is not None else IsoSE(1.0, 1.0)
    config = DSMGPConfig(mean_fun, kernel, log_noise, M, K, V, depth, eps, sum_root)
    x = as_2d(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    root = build_tree(x, y, config, np.random.default_rng(seed))
    kernels = normalize_kernels(config.kernels)
    model = DSMGP(compile_tree(root, x), make_layout(kernels),
                  initial_vector(kernels, config.observation_noise),
                  dtype or default_dtype(device), device, x, y)
    if do_fit:
        model.fit()  # initial posterior fit (≙ treeStructure.jl:434)
    return model
