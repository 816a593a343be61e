"""Model introspection helpers (counterpart of
``deepstructuredmixtures_tpu/introspect.py``).

Equivalents of the reference's miscellaneous tree queries, on the host
in NumPy:

* ``blockmatrix`` / ``blockindecies`` — leaf co-occurrence structure
  (``common.jl:11-53``);
* ``observation_counts`` — pairwise observation co-occurrence counts
  (≙ ``getObservationCount!``, ``fit.jl:41-55``);
* ``get_log_noise`` — posterior-weighted log-noise per test point
  (≙ ``getLogNoise``, ``common.jl:84-98``);
* ``left_gp`` / ``right_gp`` — the first / last leaf expert as a standalone
  :class:`GaussianProcess` on the model's device (≙ ``leftGP`` /
  ``rightGP``, ``common.jl:124-132``), used by the reference's warm-start
  workflow;
* ``rand_init`` — random hyper re-initialization + refit (the working
  equivalent of the reference's broken ``rand_init!``,
  ``optimize.jl:8-16``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import infer as inferlib
from .gp import GaussianProcess
from .hyper import unpack
from .kernels import KernelSpec
from .means import ConstMean
from .tree import LeafNode, SplitNode, SumNode


def blockmatrix(model, best: bool = False) -> np.ndarray:
    """N x N weighted leaf co-occurrence matrix (≙ ``blockmatrix``,
    ``common.jl:11-32``; ``best=True`` ≙ ``bestblockmatrix``,
    ``common.jl:45-53``: follow only each sum node's argmax child)."""
    N = model.X.shape[0]
    lw_flat = model.logweights.cpu().numpy()

    # map host sum nodes to their edge ids (DFS preorder, as in plan)
    edge_iter = iter(range(lw_flat.size))
    edges = {}

    def assign(node):
        if isinstance(node, LeafNode):
            return
        if isinstance(node, SumNode):
            edges[id(node)] = [next(edge_iter) for _ in node.children]
        for c in node.children:
            assign(c)

    assign(model.root)

    def rec(node) -> np.ndarray:
        if isinstance(node, LeafNode):
            M = np.zeros((N, N))
            M[np.ix_(node.obs, node.obs)] += 1.0
            return M
        if isinstance(node, SplitNode):
            return sum(rec(c) for c in node.children)
        ws = np.exp(lw_flat[edges[id(node)]])
        if best:
            return rec(node.children[int(np.argmax(ws))])
        return sum(w * rec(c) for w, c in zip(ws, node.children))

    return rec(model.root)


def blockindecies(model):
    """Per-observation list of co-occurring observation indices
    (≙ ``blockindecies``, ``common.jl:35-43``)."""
    out = [[] for _ in range(model.X.shape[0])]
    for obs in model.plan.leaf_obs:
        lst = obs.tolist()
        for n in lst:
            out[n].extend(lst)
    return out


def observation_counts(model) -> np.ndarray:
    """Pairwise co-occurrence counts over leaves (≙ ``getObservationCount!``,
    ``fit.jl:41-55``; zero diagonal)."""
    N = model.X.shape[0]
    P = np.zeros((N, N), dtype=np.int64)
    for obs in model.plan.leaf_obs:
        P[np.ix_(obs, obs)] += 1
    np.fill_diagonal(P, 0)
    return P


def _membership(model, xt):
    """``(xt [T, D], member [T, L] bool, path log-weights [L])`` as NumPy
    arrays: the active leaves of each test point and each leaf's mixture
    log-weight, the inputs of the posterior-weighted per-point votes."""
    xt = np.atleast_2d(np.asarray(xt, dtype=np.float64)).reshape(
        -1, model.plan.dim)
    member = inferlib.leaf_membership(
        model.plan, torch.as_tensor(xt, dtype=model.dtype,
                                    device=model.device)).cpu().numpy()
    pw = inferlib.path_logweights(model.plan, model.logweights).cpu().numpy()
    return xt, member, pw


def get_log_noise(model, xt) -> np.ndarray:
    """Posterior-weighted mixture of per-leaf logNoise at each test point
    (≙ ``getLogNoise``, ``common.jl:84-98``: logsumexp over active leaves
    of path-logweight + logNoise)."""
    xt, member, pw = _membership(model, xt)
    theta = model.theta.cpu().numpy()
    lognoise = np.zeros(model.num_leaves)
    for l in range(model.num_leaves):
        t = theta if theta.ndim == 1 else theta[l]
        _, _, ln = unpack(model.layout, t, int(model.plan.leaf_kernelid[l]))
        lognoise[l] = float(ln)
    out = np.zeros(xt.shape[0])
    for t in range(xt.shape[0]):
        act = np.where(member[t])[0]
        a = pw[act] + lognoise[act]
        m = a.max()
        out[t] = m + np.log(np.exp(a - m).sum())
    return out


def _leaf_gp(model, leaf_index: int) -> GaussianProcess:
    plan = model.plan
    obs = plan.leaf_obs[leaf_index]
    kid = int(plan.leaf_kernelid[leaf_index])
    theta = model.theta.cpu().numpy()
    t = theta if theta.ndim == 1 else theta[leaf_index]
    logl, logsigma, lognoise = unpack(model.layout, t, kid)
    spec = KernelSpec(model.layout.kinds[kid],
                      tuple(np.atleast_1d(logl).tolist()), float(logsigma))
    return GaussianProcess(
        model.X[obs], model.y[obs],
        mean=ConstMean(float(plan.leaf_mean[leaf_index])), kernel=spec,
        log_noise=float(lognoise), device=model.device, dtype=model.dtype)


def left_gp(model) -> GaussianProcess:
    """First (leftmost) leaf expert as an exact GP (≙ ``leftGP``)."""
    return _leaf_gp(model, 0)


def right_gp(model) -> GaussianProcess:
    """Last (rightmost) leaf expert as an exact GP (≙ ``rightGP``)."""
    return _leaf_gp(model, model.num_leaves - 1)


def rand_init(model, seed=None):
    """Random hyper re-initialization + refit (working ``rand_init!``)."""
    rng = np.random.default_rng(seed)
    model.set_params(rng.standard_normal(model.theta.shape[-1]))
    model.fit()
    return model
