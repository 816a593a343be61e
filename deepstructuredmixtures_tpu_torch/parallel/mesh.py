"""Expert parallelism over the leaf axis on ``torch.distributed``
(counterpart of ``deepstructuredmixtures_tpu/parallel/mesh.py``).

The padded leaf axis is split over the ranks of one mesh axis: rank ``me``
of ``ndev`` owns the contiguous leaves ``me * L/ndev ... (me + 1) * L/ndev
- 1`` of every batch padded to a multiple of ``ndev`` (the counterpart of
``NamedSharding(mesh, P('experts'))``). Leaf covariances, factors, solves
and mlls run on the owning rank; the small per-leaf results (mlls,
routed moments) are gathered so that the SPN passes run replicated, and
the hyper vector stays replicated. On the card every rank's leaves go
through the port's own fit and predict code, so float32 IsoSE buckets of
nmax ≤ 1024 still run the fused CUDA kernel (``ops/fused_chol.py``).

Training differentiates with ``torch.autograd``: a gathered leaf-mll
vector passes its gradient back to this rank's rows only, and the
replicated hypers sum their gradient over the ranks (:class:`_SumGrad`),
so ``autograd.grad`` of a sharded objective is the whole gradient on
every rank, as ``jax.grad`` of a ``shard_map`` is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import fit as fitlib
from .. import infer as inferlib
from ..leafgp import LeafBatch
from ..train import _adam, _ascend, _chunk_leaf_mll, _value_and_grad
from .comm import EXPERT_AXIS, make_mesh, resolve  # noqa: F401 (make_mesh: the API)


def _pad_rows(a, rows: int):
    """Zero-pad a leading (leaf/row) axis up to ``rows``."""
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def pad_leaves(batch: LeafBatch, multiple: int) -> LeafBatch:
    """Pad the leaf axis to a multiple of the mesh size. Padding leaves are
    fully masked (identity covariance, zero targets, ``n = 0``) and no SPN
    node refers to them, so they are exact no-ops."""
    L = batch.num_leaves
    rows = L + ((-L) % multiple)
    if rows == L:
        return batch
    return LeafBatch(*[_pad_rows(a, rows) for a in batch])


def _local(batch: LeafBatch, ax) -> LeafBatch:
    """This rank's leaves of a batch padded to a multiple of ``ax.ndev``."""
    r = batch.num_leaves // ax.ndev
    return batch.rows(ax.me * r, (ax.me + 1) * r)


def shard_batch(batch: LeafBatch, mesh, axis: str = EXPERT_AXIS) -> LeafBatch:
    """Pad to the mesh size and return this rank's shard of the leaves."""
    ax = resolve(mesh, axis)
    return _local(pad_leaves(batch, ax.ndev), ax)


class _SumGrad(torch.autograd.Function):
    """Identity on replicated hypers whose backward sums the gradient over
    the axis: each rank's graph covers only its own leaves."""

    @staticmethod
    def forward(ctx, theta, ax):
        ctx.ax = ax
        return theta.view_as(theta)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.psum(g.clone()), None


class _GatherRows(torch.autograd.Function):
    """:meth:`comm.Axis.gather_rows` whose backward keeps this rank's rows
    of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax, ctx.r = ax, t.shape[0]
        return ax.gather_rows(t)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.ax.me * ctx.r
        return g[lo:lo + ctx.r], None


def make_sharded_mll_fn(layout, plan, batch: LeafBatch, mesh,
                        axis: str = EXPERT_AXIS):
    """``(f, sbatch)``: ``f(theta) -> root mll`` with the leaf batch sharded
    over the mesh, differentiable (the whole gradient on every rank), and
    this rank's shard ``sbatch``. Each rank factors its leaves; only the
    ``[L]`` vector of leaf mlls crosses ranks for the SPN pass."""
    ax = resolve(mesh, axis)
    L = plan.num_leaves
    sbatch = _local(pad_leaves(batch, ax.ndev), ax)

    def f(theta):
        lm = _chunk_leaf_mll(layout, _SumGrad.apply(theta, ax), sbatch)
        return inferlib.root_mll(plan, _GatherRows.apply(lm, ax)[:L])

    return f, sbatch


def sharded_fit(layout, theta, batch: LeafBatch, mesh,
                axis: str = EXPERT_AXIS):
    """Batched posterior fit with the leaf axis sharded over the mesh:
    this rank's ``LeafPosterior`` (factors, alphas, mlls of its leaves of
    the padded batch), fitted by ``fit.fit_batched`` (the CUDA kernels on
    the card)."""
    return fitlib.fit_batched(layout, theta, shard_batch(batch, mesh, axis))


def make_sharded_routed_predict(layout, plan, batch: LeafBatch, mesh,
                                axis: str = EXPERT_AXIS):
    """Routed DSMGP prediction with the leaf (expert) axis sharded.

    Each rank factors its leaves and predicts their routed test points;
    the ``[L]`` leaf mlls and the ``[L, tmax]`` routed moments are gathered
    for the replicated SPN weight update and log-space moment matching (≙
    ``fit`` + ``update`` + ``predict`` of one device).

    Returns ``(f, prepare)``: ``prepare(tidx, tmask)`` pads the routing
    arrays to the padded leaf count and puts them on the batch's device;
    ``f(theta, xt, tidx_p, tmask_p)`` returns ``(z_root, mean [T], var
    [T])``, replicated."""
    from ..models import _routed_moment_match

    ax = resolve(mesh, axis)
    L = plan.num_leaves
    sbatch = _local(pad_leaves(batch, ax.ndev), ax)
    r = sbatch.num_leaves
    Lp = r * ax.ndev
    dev = batch.x.device

    def prepare(tidx, tmask):
        ti = torch.as_tensor(np.asarray(tidx), dtype=torch.long, device=dev)
        tm = torch.as_tensor(np.asarray(tmask), device=dev)
        return _pad_rows(ti, Lp), _pad_rows(tm, Lp)

    def f(theta, xt, tidx_p, tmask_p):
        tmax = tidx_p.shape[1]
        post = fitlib.fit_batched(layout, theta, sbatch)
        lo = ax.me * r
        mu, var = fitlib.cached_leaf_predict(layout, theta, sbatch, post.chol,
                                             xt, tidx_p[lo:lo + r])
        g = ax.gather_rows(torch.cat([mu, var, post.mll[:, None]], 1))[:L]
        lw, z = inferlib.update_weights(plan, g[:, -1])
        mean, v = _routed_moment_match(plan, g[:, :tmax], g[:, tmax:2 * tmax],
                                       lw, tidx_p[:L], tmask_p[:L],
                                       xt.shape[0])
        return z, mean, v

    return f, prepare


def sharded_bucketed_streamed_predict(layout, theta, batches, leaf_ids,
                                      L: int, xt, tidx=None, tmask=None,
                                      mesh=None, axis: str = EXPERT_AXIS,
                                      budget: int = 2 << 30):
    """The streamed path (fit+predict over size buckets, factors
    recomputed chunk by chunk and never kept) sharded over the mesh: per
    bucket each rank streams its own leaves through
    ``fit.streamed_leaf_predict``, then one gather brings the bucket's
    moments and mlls to every rank. Each rank chunks its share by
    ``fit._bucket_chunk``, as the local path does (one leaf at a time from
    nmax 4096); the JAX package's sharded path takes ``default_chunk``,
    which on an H100 made the N=100k predict 41% slower than the local one
    in a world of one rank (batched ``cholesky_ex`` of several leaves of
    4096 rows and more; ``PERF.md``).

    Same arguments and result as ``fit.bucketed_streamed_predict`` plus
    the mesh: ``(mu [L, T|tmax], var, mll [L])``, replicated. ``tidx``
    (int64) routes test points to leaves; ``None`` predicts all T at every
    leaf (the PoE family). ``tmask`` is not read (the combine reads it)."""
    ax = resolve(mesh, axis)
    T = xt.shape[0] if tidx is None else tidx.shape[1]
    dev, dt = batches[0].x.device, batches[0].x.dtype
    mu = torch.zeros((L, T), dtype=dt, device=dev)
    var = torch.ones((L, T), dtype=dt, device=dev)
    mll = torch.zeros((L,), dtype=dt, device=dev)
    tied = theta.ndim == 1
    for b, ids in zip(batches, leaf_ids):
        idx = fitlib._leaf_index(ids, dev)
        bl = _local(pad_leaves(b, ax.ndev), ax)
        r = bl.num_leaves
        lo, nb = ax.me * r, r * ax.ndev
        ti = None if tidx is None else _pad_rows(tidx[idx], nb)[lo:lo + r]
        th = theta if tied else _pad_rows(theta[idx], nb)[lo:lo + r]
        chunk = fitlib._bucket_chunk(b.nmax, r, dt, budget)
        mu_b, var_b, mll_b = fitlib.streamed_leaf_predict(layout, th, bl, xt,
                                                          ti, chunk=chunk)
        g = ax.gather_rows(torch.cat([mu_b, var_b, mll_b[:, None]], 1))
        g = g[:b.num_leaves]
        mu[idx], var[idx], mll[idx] = g[:, :T], g[:, T:2 * T], g[:, -1]
    return mu, var, mll


def make_sharded_value_and_grad_bucketed(layout, plan, batches, leaf_ids,
                                         mesh, axis: str = EXPERT_AXIS,
                                         budget: int = 2 << 30,
                                         chunk: Optional[int] = None):
    """Exact ``theta -> (root mll, grad)`` for size-bucketed models with
    the leaf axis sharded over the mesh, each rank streaming its own
    leaves chunk by chunk (``fit._bucket_chunk`` on its share of each
    bucket, or ``chunk``): training at the scale one device streams.

    The chain rule of ``train.make_value_and_grad_bucketed``: the leaf
    mlls of every bucket without a graph (gathered), the responsibilities
    from the replicated SPN pass, then per bucket and leaf chunk a graph
    and its backward with the cotangent of its leaves, and one psum of the
    ``[P]`` gradient. Tied hypers (``theta [P]``)."""
    ax = resolve(mesh, axis)
    L = plan.num_leaves
    entries = []
    for b, ids in zip(batches, leaf_ids):
        sb = _local(pad_leaves(b, ax.ndev), ax)
        rows = sb.num_leaves
        c = chunk if chunk is not None else fitlib._bucket_chunk(
            b.nmax, rows, b.x.dtype, budget)
        entries.append((sb, fitlib._leaf_index(ids, b.x.device),
                        max(1, min(c, rows))))

    def local_mlls(th, sb, c):
        return torch.cat([_chunk_leaf_mll(layout, th, sb.rows(s, s + c))
                          for s in range(0, sb.num_leaves, c)])

    def vg(theta):
        th = theta.detach().requires_grad_(True)
        with torch.no_grad():
            mll = th.new_zeros((L,))
            for sb, idx, c in entries:
                mll[idx] = ax.gather_rows(local_mlls(th, sb, c))[:idx.numel()]
            value = inferlib.root_mll(plan, mll)
        r = inferlib.leaf_responsibilities(plan, mll).to(th.dtype)
        with torch.enable_grad():
            for sb, idx, c in entries:
                rows = sb.num_leaves
                rw = r.new_zeros((rows * ax.ndev,))
                rw[:idx.numel()] = r[idx]
                rw = rw[ax.me * rows:(ax.me + 1) * rows]
                for s in range(0, rows, c):
                    _chunk_leaf_mll(layout, th, sb.rows(s, s + c)).backward(
                        rw[s:s + c])
        return value, ax.psum(th.grad)

    return vg


def make_sharded_train_step(layout, plan, batch: LeafBatch, mesh,
                            optimizer=None, axis: str = EXPERT_AXIS):
    """One multi-device training step: sharded leaf factorizations,
    replicated hypers, an mll-ascent optimizer step.

    Returns ``(step, init, sbatch)``: ``init(theta)`` builds the optimizer
    (a factory ``params -> torch.optim.Optimizer``, default Adam lr 1e-3)
    on a copy of ``theta`` and returns it as the state;
    ``step(theta, opt) -> (mll, theta', opt)``."""
    optimizer = optimizer or _adam
    f, sbatch = make_sharded_mll_fn(layout, plan, batch, mesh, axis)
    vg = _value_and_grad(f)

    def init(theta):
        return optimizer([theta.detach().clone().requires_grad_(True)])

    def step(theta, opt):
        p = opt.param_groups[0]["params"][0]
        with torch.no_grad():
            p.copy_(theta)
        val, g = vg(p)
        _ascend(opt, p, g)
        return val, p.detach().clone(), opt

    return step, init, sbatch
