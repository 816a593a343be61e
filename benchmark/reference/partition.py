"""The DSMGP region tree, built for the reference alone.

A frozen, self-contained copy of the partition logic of the DSMGP builder
(``treeStructure.jl`` of DeepStructuredMixtures.jl: ``getSplits``,
``_buildSplit``, ``_buildSum``, ``_buildGP``) for one kernel and a sum node
at the root, in NumPy. It draws from the generator in the same order as the
published builder, so the same seed and data give the same partition. It
imports nothing of the program under test: the reference works the
partition out again from the raw data.

A node is a tuple: ``("leaf", index)``, ``("split", children)`` or
``("sum", children)``; the leaves come out in depth-first order, each as a
dict with its observation indices, box and constant mean.
"""
from __future__ import annotations

import numpy as np


def _splits(xs, lb, ub, min_data, eps, K, rng, depth=1):
    """``getSplits`` over the ascending column ``xs`` of the node's data."""
    k_local = depth * depth
    out = []
    if xs.size == 0:
        return out
    lo = max(lb, float(xs[0]))
    hi = min(ub, float(xs[-1]))
    span = hi - lo
    left = int(np.searchsorted(xs, lo, side="right"))
    right = int(np.searchsorted(xs, hi, side="right"))
    size = right - left
    if size > min_data * 2:
        med = (float(xs[left + (size - 1) // 2]) + float(xs[left + size // 2])) / 2.0
        s_new = med
        z1 = z2 = 0
        tries = 0
        while z1 == 0 or z2 == 0:
            a = float(rng.beta(2.0, 2.0)) * span + lo
            s_new = eps * a + (1.0 - eps) * med
            z1 = int(np.searchsorted(xs, s_new, side="right")) - left
            z1 = max(0, min(size, z1))
            z2 = size - z1
            tries += 1
            if tries > 100:
                return out
        first = int(rng.integers(1, 3))
        sides = [(z1, lb, s_new), (z2, s_new, ub)]
        if first != 1:
            sides.reverse()
        for i, (z, nlb, nub) in enumerate(sides):
            if z > min_data and k_local < K:
                out.extend(_splits(xs, nlb, nub, min_data, eps, K, rng, depth + 1))
                if i == 0:
                    k_local += 1
        out.append(s_new)
    return out


class _Builder:
    def __init__(self, X, y, cfg, rng):
        self.X, self.y, self.cfg, self.rng = X, y, cfg, rng
        self.leaves = []

    def leaf(self, sel_obs, lb, ub):
        obs = np.asarray(sel_obs, dtype=np.int64)
        self.leaves.append({"obs": obs, "lb": lb.copy(), "ub": ub.copy(),
                            "mean": float(self.y[obs].mean())})
        return ("leaf", len(self.leaves) - 1)

    def split(self, obs, lb, ub, depth, d):
        cfg = self.cfg
        col = self.X[obs, d]
        s = _splits(np.sort(col), float(lb[d]), float(ub[d]), cfg["M"],
                    cfg["eps"], cfg["K"], self.rng)
        s.sort()
        if not s:
            sel = (col > lb[d]) & (col <= ub[d])
            return self.leaf(obs[sel], lb, ub)
        children = []
        lo = float(lb[d])
        for si in s + [float(ub[d])]:
            lb_, ub_ = lb.copy(), ub.copy()
            lb_[d], ub_[d] = lo, si
            sub = obs[(col > lo) & (col <= si)]
            if depth < cfg["depth"] and sub.size > cfg["M"]:
                children.append(self.sum(sub, lb_, ub_, depth))
            else:
                children.append(self.leaf(sub, lb_, ub_))
            lo = si
        return ("split", children)

    def sum(self, obs, lb, ub, depth):
        Xn = self.X[obs]
        ranges = Xn.max(axis=0) - Xn.min(axis=0)
        total = ranges.sum()
        phi = (np.full(Xn.shape[1], 1.0 / Xn.shape[1]) if total <= 0
               else ranges / total)
        children = []
        for _ in range(self.cfg["V"]):
            d = int(self.rng.choice(Xn.shape[1], p=phi))
            children.append(self.split(obs, lb, ub, depth + 1, d))
        return ("sum", children)


def build(X, y, cfg):
    """``(root, leaves)`` of the tree of ``cfg`` (keys ``V``, ``K``, ``M``,
    ``depth``, ``eps``, ``tree_seed``) over ``X [N, D]``, ``y [N]``."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    b = _Builder(X, y, cfg, np.random.default_rng(cfg["tree_seed"]))
    D = X.shape[1]
    root = b.sum(np.arange(X.shape[0], dtype=np.int64), np.full(D, -np.inf),
                 np.full(D, np.inf), 0)
    return root, b.leaves
