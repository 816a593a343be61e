"""Hyperparameter training and fine-tuning (counterpart of
``deepstructuredmixtures_tpu/train.py``).

* ``train`` (≙ ``train!``, ``optimisers.jl:4-87``): gradient ascent on the
  root marginal log-likelihood with respect to one tied hyper vector, with
  the reference's moving-window early stopping (δ = |ℓ_i − mean(ℓ_{i−9..
  i−1})| < λ for ``earlystop`` consecutive iterations, ``optimisers.jl:
  53-66``);
* ``train_gp`` (≙ the single-GP ``train!``, ``optimisers.jl:89-145``) with
  NaN rollback;
* ``finetune`` (≙ ``finetune!``, ``finetuning.jl:3-88``): per-leaf hypers;
  every leaf's candidate vector is applied to the whole tree with its
  overlap-row weighting and only that leaf's row is updated, all
  candidates of an iteration evaluated together. ``self_weight`` (default
  1.0) is the diagonal of the weighting rows, the evident intent of the
  reference (its ``D`` has a zero diagonal, ``finetuning.jl:30-31``).

``optimizer`` is a factory ``params -> torch.optim.Optimizer``, e.g.
``functools.partial(torch.optim.Adam, lr=5e-2)``. The loops ascend by
writing the negative gradient into ``.grad`` before ``step()``, so any
descent-convention optimizer works (the JAX package feeds ``-g`` to optax
the same way).

With ``mesh`` (a ``DeviceMesh``, ``parallel.make_mesh``) every rank runs
the same call: ``train`` shards the leaves of each size bucket over the
ranks (``parallel.mesh``), ``finetune`` the candidates and the (candidate,
leaf) pairs; the gradients are summed over the ranks and the hypers stay
replicated.

The objective is this module's own leaf mll (:func:`_chunk_leaf_mll`):
gram, noisy diagonal, a Cholesky whose failure is NaN added out of place,
forward solve. It never goes through ``fit._factor`` or ``fit.fit_light``:
their fused CUDA kernel has no backward, and ``cholesky_nosym`` writes its
NaN into the factor in place, which autograd refuses. Only the refit at
the end of ``train`` and ``finetune`` runs the CUDA kernels.

Memory: gradients are evaluated leaf chunk by leaf chunk (the memory rule
of ``fit._bucket_chunk``), each chunk's graph freed before the next, so
peak memory is one chunk's, as with the JAX package's ``jax.checkpoint``.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import fit as fitlib
from . import infer as inferlib
from .fit import _noisy_gram
from .gp import _fit
from .leafgp import LeafBatch, centered_y, leaf_mll_forward
from .ops import cholesky as chol
from .plan import MixtureOverlap, SPNPlan

__all__ = ["train", "train_gp", "finetune", "make_mll_fn",
           "make_mll_fn_bucketed", "make_value_and_grad_bucketed",
           "make_finetune_vg_bucketed", "leaf_mlls_fn"]


class _Progress:
    """Live single-line training display (≙ ProgressMeter,
    ``optimisers.jl:25,54,122``: iteration / δ / llh refreshed in place).

    ``enable=None`` auto-enables on a TTY stderr; an explicit bool forces.
    """

    def __init__(self, label: str, total: int, enable=None):
        self.label = label
        self.total = total
        self.out = sys.stderr
        self.on = self.out.isatty() if enable is None else bool(enable)
        self._dirty = False

    def show(self, it: int, value: float, delta: float):
        if not self.on:
            return
        d = f"{delta:.4g}" if np.isfinite(delta) else "--"
        self.out.write(
            f"\r[{self.label}] iter {it + 1}/{self.total}  "
            f"llh={value:.4f}  delta={d}   "
        )
        self.out.flush()
        self._dirty = True

    def close(self, note: str = ""):
        if self.on and self._dirty:
            self.out.write(note + "\n")
            self.out.flush()


def _delta(hist, it):
    """The reference's early-stop distance: the value against the mean of
    the nine before the last (``optimisers.jl:53-66``)."""
    return abs(hist[it] - hist[it - 10: it - 1].mean()) if it >= 10 else np.inf


def _adam(params):
    """Default optimizer of ``train`` and ``finetune`` (≙ ``optax.adam(1e-3)``)."""
    return torch.optim.Adam(params, lr=1e-3)


def _rmsprop(params):
    """Default optimizer of ``train_gp`` (≙ ``optax.rmsprop(1e-3)``, decay
    0.9; torch adds ``eps`` outside the square root, optax inside)."""
    return torch.optim.RMSprop(params, lr=1e-3, alpha=0.9)


def _ascend(opt, param, g):
    """One optimizer step along ``+g``."""
    param.grad = -g
    opt.step()


# ---------------------------------------------------------------------------
# Leaf mll as a differentiable function of the hypers
# ---------------------------------------------------------------------------


def _cholesky(Kn):
    """Differentiable lower Cholesky factor. A matrix that is not positive
    definite comes back all NaN, as from XLA; the NaN is added rather than
    written in place, so that autograd runs through it (``gp._fit``)."""
    Lf, info = torch.linalg.cholesky_ex(Kn)
    return Lf + torch.where(info > 0, torch.nan, 0.0)[..., None, None]


def _chunk_leaf_mll(layout, theta, batch: LeafBatch):
    """mll of every leaf in ``batch`` under hypers ``theta`` (``[P]`` or
    per-leaf ``[C, P]``). Forward solve only: ``y'α = ||L⁻¹y||²``."""
    Lf = _cholesky(_noisy_gram(layout, theta, batch))
    z = chol.solve_lower(Lf, centered_y(batch)[..., None])[..., 0]
    return leaf_mll_forward(Lf, z, batch)


def leaf_mlls_fn(layout, batch: LeafBatch, chunk: Optional[int]):
    """``f(theta) -> [L]``, all leaf mlls of ``batch``; with ``chunk`` the
    leaves go ``chunk`` at a time, each chunk recomputed in the backward
    (``torch.utils.checkpoint``) so that only its inputs are kept."""
    L = batch.num_leaves
    if chunk is None or chunk >= L:
        return lambda theta: _chunk_leaf_mll(layout, theta, batch)

    def f(theta):
        return torch.cat([
            checkpoint(_chunk_leaf_mll, layout, th, b, use_reentrant=False)
            for _, _, b, th in fitlib._chunks(batch, theta, chunk)])

    return f


def make_mll_fn(layout, plan: SPNPlan, batch: LeafBatch, chunk=None):
    """``theta -> root mll`` (uniform sum weights) over one leaf batch."""
    lf = leaf_mlls_fn(layout, batch, chunk)
    return lambda theta: inferlib.root_mll(plan, lf(theta))


def _bucket_fns(layout, batches, leaf_ids, budget: int):
    """``(f, idx, chunk)`` per size bucket: its leaf-mll function, the
    global leaf index of its leaves and its leaf chunk."""
    out = []
    for b, ids in zip(batches, leaf_ids):
        chunk = fitlib._bucket_chunk(b.nmax, b.num_leaves, b.x.dtype, budget)
        out.append((leaf_mlls_fn(layout, b, chunk),
                    fitlib._leaf_index(ids, b.x.device), chunk))
    return out


def _rows(theta, idx):
    """Tied hypers as they are, per-leaf hypers ``[L, P]`` at ``idx``."""
    return theta if theta.ndim == 1 else theta[idx]


def make_mll_fn_bucketed(layout, plan: SPNPlan, batches, leaf_ids,
                         budget: int = 2 << 30):
    """``theta -> root mll`` over size-bucketed batches, differentiable
    through every bucket (each bucket's leaf chunks recomputed in the
    backward)."""
    fns = _bucket_fns(layout, batches, leaf_ids, budget)
    L = plan.num_leaves
    dt, dev = batches[0].x.dtype, batches[0].x.device

    def f(theta):
        mll = torch.zeros((L,), dtype=dt, device=dev)
        for fb, idx, _ in fns:
            mll[idx] = fb(_rows(theta, idx))
        return inferlib.root_mll(plan, mll)

    return f


def _value_and_grad(f):
    """``theta -> (f(theta), grad)`` by autograd."""
    def vg(theta):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            val = f(th)
            (g,) = torch.autograd.grad(val, th)
        return val.detach(), g

    return vg


def make_value_and_grad_bucketed(layout, plan: SPNPlan, batches, leaf_ids,
                                 budget: int = 2 << 30):
    """Exact ``theta -> (root mll, grad)`` with one graph per leaf chunk
    instead of one through every bucket.

    The chain rule factors through the SPN: ``d root/dθ = Σ_l r_l ·
    d mll_l/dθ`` with the leaf responsibilities ``r = ∂root/∂mll``
    (``infer.leaf_responsibilities``, the weights of the reference's hand
    propagation, ``optimize.jl:42-89``). So: (1) the leaf mlls of every
    bucket without a graph, (2) the responsibilities from the small SPN
    pass, (3) per bucket and leaf chunk, the chunk recomputed with a graph
    and its backward run at once with the cotangent ``r`` of its leaves.
    Peak memory stays one chunk's graph."""
    L = plan.num_leaves
    fns = _bucket_fns(layout, batches, leaf_ids, budget)
    dt, dev = batches[0].x.dtype, batches[0].x.device

    def vg(theta):
        th = theta.detach().requires_grad_(True)
        with torch.no_grad():
            mll = torch.zeros((L,), dtype=dt, device=dev)
            for f, idx, _ in fns:
                mll[idx] = f(_rows(th, idx))
            value = inferlib.root_mll(plan, mll)
        r = inferlib.leaf_responsibilities(plan, mll).to(dt)
        with torch.enable_grad():
            for (_, idx, chunk), b in zip(fns, batches):
                for s in range(0, b.num_leaves, chunk):
                    ids = idx[s:s + chunk]
                    _chunk_leaf_mll(layout, _rows(th, ids),
                                    b.rows(s, s + chunk)).backward(r[ids])
        return value, th.grad

    return vg


# ---------------------------------------------------------------------------
# train! — tied hyperparameters
# ---------------------------------------------------------------------------


def _per_bucket(model) -> bool:
    """Whether a bucket reaches nmax 4096: then the gradients go through the
    size buckets one leaf chunk at a time."""
    return max(b.nmax for b in model.bucket_batches) >= 4096


def _train_vg(model, chunk: Optional[int] = None):
    """``theta -> (root mll, grad)`` by the route :func:`train` takes: with
    ``chunk`` the monolithic batch in leaf chunks; else the size buckets,
    one graph per leaf chunk (:func:`make_value_and_grad_bucketed`) when a
    bucket reaches nmax 4096, where one graph through every bucket would
    hold several factors of 1 GB each, and one graph through all buckets
    below that."""
    layout, plan = model.layout, model.plan
    if chunk is not None:
        return _value_and_grad(make_mll_fn(layout, plan, model.batch, chunk))
    buckets = (layout, plan, model.bucket_batches, model.bucket_spec.leaf_ids)
    if _per_bucket(model):
        return make_value_and_grad_bucketed(*buckets)
    return _value_and_grad(make_mll_fn_bucketed(*buckets))


def _mesh_vg(model, theta, mesh, chunk):
    """The gradient route of ``train(mesh=...)``."""
    from .parallel import mesh as pmesh

    if theta.ndim != 1:
        raise ValueError(
            "train(mesh=...) requires tied hypers (theta 1-D); the "
            "sharded batch is padded past the leaf count, which a "
            "per-leaf theta matrix cannot follow — train untied "
            "models on the single-device per-bucket path"
        )
    layout, plan = model.layout, model.plan
    if getattr(model, "bucket_batches", None) is not None:
        return pmesh.make_sharded_value_and_grad_bucketed(
            layout, plan, model.bucket_batches, model.bucket_spec.leaf_ids,
            mesh, chunk=chunk)
    if chunk is not None:
        raise ValueError(
            "train(mesh=...) without bucket batches does not "
            "chunk (each device holds its shard's covariances at "
            "once); drop chunk= or drop mesh="
        )
    f, _ = pmesh.make_sharded_mll_fn(layout, plan, model.batch, mesh)
    return _value_and_grad(f)


def train(
    model,
    optimizer=None,
    iterations: int = 10_000,
    lam: float = 0.05,
    randinit: bool = True,
    earlystop: int = 10,
    chunk: Optional[int] = None,
    seed=None,
    verbose: bool = False,
    progress=None,
    mesh=None,
):
    """Train tied hyperparameters by mll ascent (≙ ``train!``,
    ``optimisers.jl:4-87``). Mutates ``model.theta``, refits, and returns
    the mll history (a NumPy array).

    ``optimizer``: a factory ``params -> torch.optim.Optimizer`` (default
    Adam, lr 1e-3). ``randinit`` starts from a standard normal vector drawn
    with ``np.random.default_rng(seed)``. The gradient route is
    :func:`_train_vg`'s (``chunk``: the monolithic batch). A non-finite
    mll ends the run at the hypers that gave it, out of the history; at
    the first iteration it raises. ``progress``: the live display
    (``None``: on a TTY).

    ``mesh``: every step runs expert-parallel over the mesh's ``'experts'``
    axis (``parallel.mesh.make_sharded_value_and_grad_bucketed``: each rank
    streams its leaves of every size bucket, ``chunk`` leaves at a time if
    given); the same mathematics and history. Tied hypers only; a
    ``randinit`` start is rank 0's, sent to every rank."""
    optimizer = optimizer or _adam
    P = model.theta.shape[-1]
    if randinit:
        theta = torch.as_tensor(np.random.default_rng(seed).standard_normal(P),
                                dtype=model.dtype, device=model.device)
    else:
        theta = model.theta.detach().clone()
    if mesh is not None:
        vg = _mesh_vg(model, theta, mesh, chunk)
        if randinit:  # seed=None draws differently on every rank
            from .parallel.comm import resolve

            resolve(mesh).broadcast(theta, 0)
    else:
        vg = _train_vg(model, chunk)
    theta.requires_grad_(True)
    opt = optimizer([theta])
    hist = np.zeros(iterations)
    c = 0
    n_hist = 0
    bar = _Progress("train", iterations, progress)
    for it in range(iterations):
        val, g = vg(theta)
        hist[it] = float(val)
        if not np.isfinite(hist[it]):
            # n_hist is not advanced: the non-finite value stays out of the
            # returned history (the JAX package keeps the same hypers)
            break
        n_hist = it + 1
        _ascend(opt, theta, g)
        delta = _delta(hist, it)
        bar.show(it, hist[it], delta)
        if verbose and it % 50 == 0:
            print(f"[train] iter={it} mll={hist[it]:.4f} delta={delta:.4g}")
        c = c + 1 if delta < lam else 0
        if c >= earlystop:
            break
    bar.close(f" (stopped after {n_hist} iterations)")

    if iterations > 0 and n_hist == 0:
        raise RuntimeError(
            "train: the marginal log-likelihood was non-finite at the "
            "first iteration; check the initial hyperparameters / data "
            "scaling (or pass randinit=False with known-good hypers)"
        )
    model.set_params(theta.detach().cpu().numpy())
    model.fit()
    return hist[:n_hist]


def train_gp(
    gp,
    iterations: int = 10_000,
    optimizer=None,
    lam: float = 0.1,
    randinit: bool = True,
    seed=None,
    progress=None,
):
    """Train a standalone exact GP (≙ the single-GP ``train!``,
    ``optimisers.jl:89-145``). A NaN mll rolls the hypers back to the last
    iteration's and stops (``optimisers.jl:115-119``); at the first
    iteration it raises. ``optimizer`` as in :func:`train` (default
    RMSprop, lr 1e-3, decay 0.9). Refits and returns the mll history. One
    device only: a mesh-fitted GP raises (see ``GaussianProcess.grad_mll``)."""
    if getattr(gp, "_mesh", None) is not None:
        raise NotImplementedError(
            "train_gp is single-device only; a mesh-fitted GP's [N, N] "
            "covariance cannot be rebuilt on one chip for the gradient — "
            "train hypers at single-device scale, then fit(mesh=...)"
        )
    optimizer = optimizer or _rmsprop
    if randinit:
        theta = torch.as_tensor(
            np.random.default_rng(seed).standard_normal(gp.theta.shape[0]),
            dtype=gp.x.dtype, device=gp.device)
    else:
        theta = gp.theta.detach().clone()
    theta.requires_grad_(True)
    kind, nl = gp.kernel.kind, gp.nl
    vg = _value_and_grad(lambda th: _fit(kind, nl, th, gp.x, gp.yc)[1])

    opt = optimizer([theta])
    hist = np.zeros(iterations)
    old = theta.detach().clone()
    n_hist = 0
    bar = _Progress("train_gp", iterations, progress)
    for it in range(iterations):
        val, g = vg(theta)
        hist[it] = float(val)
        if np.isnan(hist[it]):
            with torch.no_grad():
                theta.copy_(old)  # rollback (optimisers.jl:115-119)
            break
        n_hist = it + 1
        delta = _delta(hist, it)
        bar.show(it, hist[it], delta)
        old = theta.detach().clone()
        _ascend(opt, theta, g)
        if delta < lam:
            break
    bar.close()

    if iterations > 0 and n_hist == 0:
        raise RuntimeError(
            "train_gp: the marginal log-likelihood was non-finite at the "
            "first iteration (nothing to roll back to); check the initial "
            "hyperparameters / data scaling"
        )
    gp.set_params(theta.detach().cpu().numpy())
    gp.fit()
    return hist[:n_hist]


# ---------------------------------------------------------------------------
# finetune! — per-leaf (untied) hyperparameters
# ---------------------------------------------------------------------------


def _weighted_root_mll(layout, plan, batch, theta, w):
    """Root mll whose leaf-mll gradients are scaled by ``w [L]`` through a
    stop-gradient surrogate (≙ the D-row weighting of ``∇mll!``,
    ``optimize.jl:92-150``): the value is the true root mll, while
    ``d(root)/dθ = Σ_l resp_l · w_l · d(mll_l)/dθ``. Returns ``(root, leaf
    mlls)``."""
    lm = _chunk_leaf_mll(layout, theta, batch)
    sg = lm.detach()
    lm_w = sg + w * (lm - sg)
    return inferlib.upward(plan, lm_w)[plan.root_slot], lm


def _pair_mlls(layout, H, batch: LeafBatch, jq, iq, chunk: int):
    """mll of leaf ``iq[q]`` of ``batch`` under the hypers ``H[jq[q]]``
    for every pair ``q``, ``chunk`` pairs per batched forward."""
    return torch.cat([
        _chunk_leaf_mll(layout, H[jq[s:s + chunk]], batch.take(iq[s:s + chunk]))
        for s in range(0, jq.numel(), chunk)])


def make_finetune_vg_bucketed(layout, plan: SPNPlan, batches, leaf_ids,
                              budget: int = 2 << 30, mesh=None,
                              axis: str = "experts", cand_map: int = 8,
                              sparse: Optional[bool] = None,
                              pair_map: int = 8):
    """All fine-tune candidates at once: ``(H [C, P], W [C, L]) -> (leaf
    mlls [C, L], grads [C, P])``, where candidate ``j`` puts the hypers
    ``H[j]`` on every leaf and its gradient is the ``W[j]``-weighted one of
    :func:`_weighted_root_mll`, ``Σ_l resp_jl · w_jl · d mll_l/dθ``.

    Forward: per bucket, the leaf mlls of ``cand_map`` candidates at a time
    as one batch of (candidate, leaf) pairs, under per-pair hypers (the
    leaf code takes ``theta [L, P]``), in chunks by the memory rule of
    ``fit._bucket_chunk``; no graph. Then each candidate's
    responsibilities.

    Backward over a list of (candidate ``j``, leaf ``i``) pairs: per bucket
    and chunk of pairs, one batched forward of the leaves ``i`` under the
    gathered hypers ``H[j]`` with a graph, ``torch.autograd.grad`` of ``Σ_q
    rw_q · mll_q`` with respect to those hypers, added into the candidate
    rows by ``index_add_``. The chunk is bounded by a single pair's
    workspace (about six ``[nmax, nmax]`` buffers, at most 64 pairs).
    ``sparse``: the pairs with nonzero ``W[j, i]`` only, since a pair of
    zero weight adds nothing (the overlap rows are about 10% dense on the
    benchmark tree); otherwise all pairs. ``None`` picks sparse when ``W``
    is under 25% dense. Both give the same gradients.

    ``mesh``: the candidates of each forward chunk are split over the
    ranks of the mesh ``axis`` (``cand_map`` rounded to a multiple of the
    rank count, the candidates padded by repetition to a multiple of it)
    and each rank's mlls gathered; the pair list is padded to a multiple
    of ``pair_map`` (rounded likewise) with pairs of zero weight and split
    over the ranks, whose candidate gradients are summed (one psum).
    Every rank returns the same result."""
    ax = None
    if mesh is not None:
        from .parallel.comm import resolve

        ax = resolve(mesh, axis)
        if cand_map % ax.ndev:
            cand_map = ax.ndev * max(1, cand_map // ax.ndev)
        if pair_map % ax.ndev:
            pair_map = ax.ndev * max(1, pair_map // ax.ndev)
    L = plan.num_leaves
    buckets = [(b, fitlib._leaf_index(ids, b.x.device))
               for b, ids in zip(batches, leaf_ids)]
    # keyed on the W object (a strong reference is kept): finetune passes
    # the same rows every iteration, so the host copy of W and the scan of
    # its zero pattern happen once per finetune call
    cache = {}

    def pair_lists(W):
        if cache.get("W") is not W:
            cache.clear()
            cache["W"] = W
            cache["nz"] = W.detach().cpu().numpy() != 0
        use_sparse = sparse
        if use_sparse is None:
            use_sparse = cache["nz"].mean() < 0.25
        key = "sparse" if use_sparse else "dense"
        if key not in cache:
            lists = []
            for b, idx in buckets:
                nz = cache["nz"][:, idx.cpu().numpy()]
                jj, ii = np.nonzero(nz if use_sparse else np.ones_like(nz))
                lists.append(tuple(torch.as_tensor(a, dtype=torch.long,
                                                   device=b.x.device)
                                   for a in (jj, ii)))
            cache[key] = lists
        return cache[key]

    def block_mlls(Hp, b, s, e):
        """``[e - s, Lb]``: the mlls of the bucket's leaves under the
        candidates ``s:e``, split over the ranks on a mesh."""
        Lb, dev = b.num_leaves, Hp.device
        if ax is not None:
            k = (e - s) // ax.ndev
            s, e = s + ax.me * k, s + (ax.me + 1) * k
        jq = torch.arange(s, e, device=dev).repeat_interleave(Lb)
        iq = torch.arange(Lb, device=dev).repeat(e - s)
        chunk = fitlib._bucket_chunk(b.nmax, jq.numel(), b.x.dtype, budget)
        out = _pair_mlls(layout, Hp, b, jq, iq, chunk).reshape(e - s, Lb)
        return out if ax is None else ax.gather_rows(out)

    def my_pairs(jj, ii):
        """The pairs of this rank, and their weights' mask (0 on padding)."""
        keep = torch.ones_like(jj, dtype=torch.bool)
        if ax is None:
            return jj, ii, keep
        pad = (-jj.numel()) % pair_map
        jj, ii, keep = (torch.cat([a, a.new_zeros((pad,))])
                        for a in (jj, ii, keep))
        q = jj.numel() // ax.ndev
        sl = slice(ax.me * q, (ax.me + 1) * q)
        return jj[sl], ii[sl], keep[sl]

    def vg(H, W):
        H = H.detach()
        C = H.shape[0]
        Hp = H
        if ax is not None and C % cand_map:
            # repeat (not slice): the padding may exceed C (fewer candidates
            # than ranks)
            Hp = H[torch.arange(C + (-C) % cand_map, device=H.device) % C]
        Cp = Hp.shape[0]
        mll = torch.zeros((Cp, L), dtype=H.dtype, device=H.device)
        with torch.no_grad():
            for b, idx in buckets:
                for s in range(0, Cp, cand_map):
                    mll[s:s + cand_map, idx] = block_mlls(
                        Hp, b, s, min(s + cand_map, Cp))
        mll = mll[:C]
        rw = torch.stack([inferlib.leaf_responsibilities(plan, mll[j])
                          for j in range(C)]).to(H.dtype) * W
        G = torch.zeros_like(H)
        for (b, idx), pairs in zip(buckets, pair_lists(W)):
            jj, ii, keep = my_pairs(*pairs)
            bs = max(1, min(64, (2 << 30)
                            // (6 * b.nmax ** 2 * b.x.dtype.itemsize)))
            for s in range(0, jj.numel(), bs):
                j, i = jj[s:s + bs], ii[s:s + bs]
                Hq = H[j].requires_grad_(True)
                with torch.enable_grad():
                    lm = _chunk_leaf_mll(layout, Hq, b.take(i))
                    (g,) = torch.autograd.grad(
                        lm, Hq, grad_outputs=rw[j, idx[i]] * keep[s:s + bs])
                G.index_add_(0, j, g)
        return mll, G if ax is None else ax.psum(G)

    return vg


def _candidate_rows(Dov, cand) -> np.ndarray:
    """The candidate rows ``D[cand]`` of the overlap matrix, dense
    ``[C, L]`` float64 (cheap even where D is stored sparse)."""
    if isinstance(Dov, MixtureOverlap):
        return Dov.rows(cand)
    import scipy.sparse as sp

    if sp.issparse(Dov):
        return np.asarray(Dov[cand].todense(), dtype=np.float64)
    return np.array(Dov[cand], dtype=np.float64)


def finetune(
    model,
    optimizer=None,
    iterations: int = 1000,
    lam: float = 0.5,
    earlystop: int = 10,
    self_weight: float = 1.0,
    cand_chunk: Optional[int] = None,
    verbose: bool = False,
    progress=None,
    bucketed: Optional[bool] = None,
    mesh=None,
    axis=None,
    sparse: Optional[bool] = None,
    leaves=None,
):
    """Fine-tune per-leaf hyperparameters (≙ ``finetune!``,
    ``finetuning.jl:3-88``).

    Keeps a per-leaf hyper matrix ``H [L, P]``, one optimizer parameter;
    per iteration every candidate leaf's row is applied to the whole tree,
    the root-mll gradient is taken with that leaf's overlap-row weighting
    (:func:`make_finetune_vg_bucketed`), and only the candidate rows get a
    gradient: the others get zeros, which leave Adam's moments, and so the
    rows, unchanged. The early-stop value is the sum of the candidates' own
    leaf mlls (``finetuning.jl:51``). On exit the model is refit under the
    per-leaf hypers (``finetuning.jl:74-85``).

    ``bucketed``: evaluate through the size buckets (``None``: when a
    bucket reaches nmax 4096), else through the monolithic batch, with the
    same engine. ``cand_chunk``: candidates per batched forward (default
    8). ``sparse``: see :func:`make_finetune_vg_bucketed`. ``leaves``: the
    leaf indices to tune (default all; unique ints in ``[0, L)``).

    ``mesh``: shard the candidate evaluations over the ranks of one mesh
    axis (forces the bucketed route; the same history, the candidates
    being independent). ``axis``: that axis, required on a mesh of several
    axes."""
    optimizer = optimizer or _adam
    layout, plan = model.layout, model.plan
    L = plan.num_leaves
    theta0 = model.theta.detach()
    H = (theta0.expand(L, -1) if theta0.ndim == 1 else theta0).clone()
    H.requires_grad_(True)
    if plan.overlap is None:
        raise ValueError(
            "finetune needs the leaf-overlap matrix D for its row "
            "weighting (finetuning.jl:54); this model was built with "
            "overlap=False — rebuild with overlap=True"
        )
    if leaves is None:
        cand = np.arange(L)
    else:
        cand = np.unique(np.asarray(leaves, dtype=np.int64))
        if cand.size == 0 or cand[0] < 0 or cand[-1] >= L:
            raise ValueError(
                f"finetune(leaves=...) indices must be unique ints in "
                f"[0, {L}); got range [{cand[0] if cand.size else '-'}, "
                f"{cand[-1] if cand.size else '-'}]"
            )
    C = cand.size
    Dd = _candidate_rows(plan.overlap, cand)
    Dd[np.arange(C), cand] = self_weight
    Dd = torch.as_tensor(Dd, dtype=model.dtype, device=model.device)
    cand_t = torch.as_tensor(cand, device=model.device)

    if mesh is not None:
        from .parallel.comm import resolve

        bucketed = True  # the candidate-sharded route is the bucketed one
        axis = resolve(mesh, axis, "finetune(mesh=...) shards candidates").name
    if bucketed is None:
        bucketed = _per_bucket(model)
    if bucketed:
        batches, leaf_ids = model.bucket_batches, model.bucket_spec.leaf_ids
    else:
        batches, leaf_ids = [model.batch], [np.arange(L)]
    vg_all = make_finetune_vg_bucketed(layout, plan, batches, leaf_ids,
                                       mesh=mesh, axis=axis,
                                       cand_map=cand_chunk or 8, sparse=sparse)

    opt = optimizer([H])
    hist = np.zeros(iterations)
    c = 0
    n_hist = 0
    bar = _Progress("finetune", iterations, progress)
    for it in range(iterations):
        mll_c, G = vg_all(H.detach()[cand_t], Dd)
        hist[it] = float(mll_c[torch.arange(C, device=model.device), cand_t].sum())
        Gf = torch.zeros_like(H)
        Gf[cand_t] = G
        _ascend(opt, H, Gf)
        n_hist = it + 1
        delta = _delta(hist, it)
        bar.show(it, hist[it], delta)
        if verbose and it % 10 == 0:
            print(f"[finetune] iter={it} sum-own-mll={hist[it]:.4f}")
        c = c + 1 if delta < lam else 0
        if c >= earlystop:
            break
    bar.close(f" (stopped after {n_hist} iterations)")

    # final heterogeneous refit: each leaf with its own hypers
    model.set_params(H.detach().cpu().numpy())
    model.fit()
    return hist[:n_hist]
