"""Host-side SPN structure builder (a NumPy copy of
``deepstructuredmixtures_tpu/tree.py``; the port cannot import that
package, whose ``__init__`` imports JAX). Same code, same RNG
trajectory: the same seed gives the same tree bit for bit
(``tests/test_torch_host.py``).

Replicates the reference's recursive region-partitioning construction
(``src/treeStructure.jl``) in NumPy. Structure building is O(N log N),
random, inherently sequential, and runs once — it stays on the host; the
result is immediately flattened into a static device plan (``plan.py``).

Semantics replicated:

* ``getSplits`` (``treeStructure.jl:23-129``): randomized recursive
  bisection. Split proposal ``s = ϵ·Beta(2,2)-draw + (1-ϵ)·median``,
  retried ≤100 times until both sides are non-empty; recursion gated by
  ``depth^2 < K`` and ``minData``. Only dimension ``d`` of the bound
  vectors is ever read inside the recursion, so we pass scalar bounds
  (the reference's ``lb = copy(upperBound)`` at ``:84,98`` is harmless
  for the same reason).
* ``_buildSplit`` (``:131-210``): sorted split thresholds, one child per
  half-open segment ``(lo, s_i]``; recurse while ``depth < config.depth``
  and ``len(idx) > minData``, else create a leaf. Empty split list → the
  node degenerates to a leaf.
* ``_buildSum`` (``:212-243``): V children, each a split along a dimension
  drawn ∝ per-dimension data range, uniform log-weights ``-log V``, depth
  incremented per sum layer.
* ``_buildGP`` (``:245-307``): single leaf, or — when a kernel *vector* is
  configured — a leaf-level sum over one leaf per kernel with
  ``log Dirichlet(1)`` weights and per-leaf ``kernelid``. Default mean is
  the per-leaf ``ConstMean(mean(y))`` (``:271,292``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from .config import DSMGPConfig
from .kernels import KernelSpec, normalize_kernels
from .means import resolve_mean


@dataclasses.dataclass
class LeafNode:
    obs: np.ndarray  # global observation indices (ascending)
    lb: np.ndarray  # [D] lower bound (exclusive)
    ub: np.ndarray  # [D] upper bound (inclusive)
    kernelid: int
    mean: float
    index: int = -1  # assigned at flatten time


@dataclasses.dataclass
class SplitNode:
    children: List[object]
    dim: int
    thresholds: List[float]  # per-child upper edge; last == ub[dim]
    lb: np.ndarray
    ub: np.ndarray


@dataclasses.dataclass
class SumNode:
    children: List[object]
    logweights: np.ndarray
    is_leaf_sum: bool = False  # children are LeafNodes (kernel mixture)


TreeNode = Union[LeafNode, SplitNode, SumNode]


def get_splits(
    Xd: np.ndarray,
    lb_d: float,
    ub_d: float,
    min_data: int,
    eps: float,
    K: int,
    rng: np.random.Generator,
    depth: int = 1,
) -> List[float]:
    """≙ ``getSplits`` (``treeStructure.jl:23-129``); ``Xd`` is the node's
    data restricted to dimension ``d``.

    Sorts once and runs the recursion over the sorted array with
    ``searchsorted`` — every count/median the reference computes with an
    O(N) scan per proposal becomes O(log N), with bit-identical float
    results and RNG trajectory (the Beta/median blend, retry loop, and
    branch order are unchanged). At the N=500k scale-frontier build the
    original per-call ``np.median`` (flatten + partition of the node's
    full column) dominated ``build_tree`` (~20 s of 33 s, profiled).

    The column is cast to float64 up front: split arithmetic (the even-size
    median midpoint, the Beta/median blend, the ``<= s_new`` count
    comparisons) then runs in one dtype regardless of the input's, so the
    split list is deterministic across input dtypes. (Without the cast, an
    f32 column computes its median midpoint in f32 while the recursion
    mixes f64 scalars — trees built from float32 data would differ from
    the same data in float64.)"""
    return _get_splits_sorted(
        np.sort(np.asarray(Xd, dtype=np.float64)), lb_d, ub_d, min_data,
        eps, K, rng, depth
    )


def _get_splits_sorted(
    Xs: np.ndarray,
    lb_d: float,
    ub_d: float,
    min_data: int,
    eps: float,
    K: int,
    rng: np.random.Generator,
    depth: int = 1,
) -> List[float]:
    """`get_splits` over an ascending-sorted column."""
    K_local = depth * depth
    s: List[float] = []
    if Xs.size == 0:
        return s
    lo = max(lb_d, float(Xs[0]))
    hi = min(ub_d, float(Xs[-1]))
    v = hi - lo
    # selection (lo, hi] of the sorted column
    left = int(np.searchsorted(Xs, lo, side="right"))
    right = int(np.searchsorted(Xs, hi, side="right"))
    size = right - left
    if size > min_data * 2:
        # median of the slice — same float arithmetic as np.median
        # ((a+b)/2 of the two middle elements; exact element when odd)
        a_mid = float(Xs[left + (size - 1) // 2])
        b_mid = float(Xs[left + size // 2])
        m = (a_mid + b_mid) / 2.0
        s_new = m
        z1 = z2 = 0
        c = 0
        while z1 == 0 or z2 == 0:
            a = float(rng.beta(2.0, 2.0)) * v + lo
            s_new = eps * a + (1.0 - eps) * m
            # |{x in (lo,hi] : x <= s_new}| via one binary search
            z1 = int(np.searchsorted(Xs, s_new, side="right")) - left
            z1 = max(0, min(size, z1))
            z2 = size - z1
            c += 1
            if c > 100:
                return s
        zi = int(rng.integers(1, 3))
        branches = []
        # (side condition count, new lb, new ub)
        left_b = (z1, lb_d, s_new)
        right_b = (z2, s_new, ub_d)
        branches = [left_b, right_b] if zi == 1 else [right_b, left_b]
        for bi, (z, nlb, nub) in enumerate(branches):
            if z > min_data and K_local < K:
                s.extend(
                    _get_splits_sorted(
                        Xs, nlb, nub, min_data, eps, K, rng, depth=depth + 1
                    )
                )
                if bi == 0:
                    K_local += 1
        s.append(s_new)
    return s


def _build_gp_rng(X, y, lb, ub, config: DSMGPConfig, observations, rng) -> TreeNode:
    """≙ ``_buildGP`` (``treeStructure.jl:245-307``)."""
    kernels = normalize_kernels(config.kernels)
    obs = np.asarray(observations, dtype=np.int64)
    mean = resolve_mean(config.mean_fun, np.asarray(y))
    if len(kernels) == 1:
        return LeafNode(obs=obs, lb=lb.copy(), ub=ub.copy(), kernelid=0, mean=mean)
    # Leaf-level kernel-mixture sum node with Dirichlet(1) log-weights
    # (treeStructure.jl:258-286).
    w = rng.dirichlet(np.ones(len(kernels)))
    children = [
        LeafNode(obs=obs.copy(), lb=lb.copy(), ub=ub.copy(), kernelid=k, mean=mean)
        for k in range(len(kernels))
    ]
    return SumNode(children=children, logweights=np.log(w), is_leaf_sum=True)


def _build_split(X, y, lb, ub, config: DSMGPConfig, depth, observations, rng, d=0):
    """≙ ``_buildSplit`` (``treeStructure.jl:131-210``); ``d`` is 0-based."""
    s = get_splits(
        X[:, d], float(lb[d]), float(ub[d]), config.min_data, config.bnoise,
        config.K, rng,
    )
    s.sort()
    if not s:
        sel = (X[:, d] > lb[d]) & (X[:, d] <= ub[d])
        return _build_gp_rng(
            X[sel], y[sel], lb.copy(), ub.copy(), config, observations[sel], rng
        )
    thresholds = s + [float(ub[d])]
    node = SplitNode(children=[], dim=d, thresholds=thresholds, lb=lb.copy(), ub=ub.copy())
    lo = float(lb[d])
    for si in thresholds:
        lb_ = lb.copy()
        ub_ = ub.copy()
        lb_[d] = lo
        ub_[d] = si
        sel = (X[:, d] > lo) & (X[:, d] <= si)
        Xs, ys, obss = X[sel], y[sel], observations[sel]
        if depth < config.depth and Xs.shape[0] > config.min_data:
            if config.sum_root:
                child = _build_sum(Xs, ys, lb_, ub_, config, depth, obss, rng)
            else:
                child = _build_split(Xs, ys, lb_, ub_, config, depth, obss, rng, d=0)
        else:
            child = _build_gp_rng(Xs, ys, lb_, ub_, config, obss, rng)
        node.children.append(child)
        lo = si
    return node


def _build_sum(X, y, lb, ub, config: DSMGPConfig, depth, observations, rng):
    """≙ ``_buildSum`` (``treeStructure.jl:212-243``)."""
    V = config.V
    node = SumNode(children=[], logweights=np.full(V, -np.log(V)))
    ranges = X.max(axis=0) - X.min(axis=0)
    total = ranges.sum()
    if total <= 0:
        phi = np.full(X.shape[1], 1.0 / X.shape[1])
    else:
        phi = ranges / total
    for _ in range(V):
        d = int(rng.choice(X.shape[1], p=phi))
        node.children.append(
            _build_split(X, y, lb, ub, config, depth + 1, observations, rng, d=d)
        )
    return node


def build_tree(X, y, config: DSMGPConfig, rng: Optional[np.random.Generator] = None):
    """≙ ``buildTree`` (``treeStructure.jl:4-21``)."""
    rng = rng or np.random.default_rng()
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    assert X.ndim == 2 and X.shape[0] == y.shape[0]
    # ≙ the reference's data-finiteness guards (treeStructure.jl:7,14)
    assert np.all(np.isfinite(X)), "non-finite training inputs"
    assert np.all(np.isfinite(y)), "non-finite training targets"
    N, D = X.shape
    lb = np.full(D, -np.inf)
    ub = np.full(D, np.inf)
    observations = np.arange(N, dtype=np.int64)
    if config.sum_root:
        return _build_sum(X, y, lb, ub, config, 0, observations, rng)
    return _build_split(X, y, lb, ub, config, 0, observations, rng, d=0)


def get_leaves(node: TreeNode) -> List[LeafNode]:
    """DFS left-to-right leaf collection (≙ ``getLeaves``, ``fit.jl:9-10``)."""
    if isinstance(node, LeafNode):
        return [node]
    return [leaf for c in node.children for leaf in get_leaves(c)]


def num_mixtures(node: TreeNode) -> int:
    """Number of induced GP mixture components (≙ ``common.jl:6-8``)."""
    if isinstance(node, LeafNode):
        return 1
    if isinstance(node, SplitNode):
        out = 1
        for c in node.children:
            out *= num_mixtures(c)
        return out
    return sum(num_mixtures(c) for c in node.children)


def stats(node: TreeNode, acc=None) -> dict:
    """Tree statistics (≙ ``stats``, ``common.jl:365-395``)."""
    if acc is None:
        acc = {"gps": 0, "sumnodes": 0, "splitnodes": 0, "ndata": [], "bounds": []}
    if isinstance(node, LeafNode):
        acc["gps"] += 1
        acc["ndata"].append(int(node.obs.size))
    elif isinstance(node, SumNode):
        acc["sumnodes"] += 1
        for c in node.children:
            stats(c, acc)
    else:
        acc["splitnodes"] += 1
        acc["bounds"].append((node.lb.copy(), node.ub.copy()))
        for c in node.children:
            stats(c, acc)
    return acc
