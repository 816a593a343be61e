"""Structure compiler: flatten the host-side SPN tree into a static plan,
then group leaves into size buckets (counterpart of
``deepstructuredmixtures_tpu/plan.py``, without the overlap analysis).

* internal nodes become height-ordered *upward groups* evaluated with
  gather + segment-reduce (≙ the ``mll``/``update!`` recursions,
  ``optimize.jl:18-39``, ``common.jl:323-355``);
* each sum-node edge gets a global id into a flat ``logweights`` vector;
* each leaf stores its root-to-leaf sum-edge path (for mixture
  prediction) and its bounding box (for split routing, ≙ ``getchild``);
* leaves are bucketed by size, each bucket padded to its own ``nmax`` and
  placed on the device as one ``LeafBatch``.

NumPy on the host, array for array equal to the JAX package's plan for the
same tree (``tests/test_torch_host.py``). The leaf-overlap matrix and the
shared-Cholesky schedule are not ported yet (ROADMAP Queue 1 item 1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .leafgp import LeafBatch
from .tree import LeafNode, SplitNode, SumNode, TreeNode, get_leaves

@dataclasses.dataclass(frozen=True)
class UpwardGroup:
    """One (height, kind) batch of internal nodes for the upward pass."""

    kind: str  # 'sum' | 'split'
    child_slots: np.ndarray  # [E] value-slot index of each child
    seg: np.ndarray  # [E] local parent index (ascending)
    n_parents: int
    edge_ids: np.ndarray  # [E] global sum-edge ids (sum groups; -1 for split)
    neg_logk: np.ndarray  # [E] -log(#children of parent) (sum groups)


@dataclasses.dataclass(frozen=True)
class SPNPlan:
    """Static compiled model structure."""

    num_leaves: int
    nmax: int
    dim: int
    leaf_obs: Tuple[np.ndarray, ...]
    leaf_lb: np.ndarray  # [L, D]
    leaf_ub: np.ndarray  # [L, D]
    leaf_kernelid: np.ndarray  # [L]
    leaf_mean: np.ndarray  # [L]
    groups: Tuple[UpwardGroup, ...]
    num_slots: int
    root_slot: int
    n_sum_edges: int
    init_logweights: np.ndarray  # [E]
    edge_is_leaf_sum: np.ndarray  # [E] bool
    edge_neg_logk: np.ndarray  # [E]
    path_edges: np.ndarray  # [L, Pmax] int32 — sum edges on each leaf's path
    path_mask: np.ndarray  # [L, Pmax] bool
    root_child_id: np.ndarray  # [L] subtree index under the root
    pad_multiple: int = 8  # leaf-pad quantum the plan was compiled with


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_leaf_arrays(obs_list, nmax: int, X, y, npdt):
    """Ragged to padded gather for a group of leaves: the native parallel
    packer when ``native/libdsmhost.so`` loads, else one vectorized
    boolean-mask scatter per array. Padded slots stay exactly zero."""
    from .utils.native import pack_leaves

    packed = pack_leaves(obs_list, nmax, X, y, npdt)
    if packed is not None:
        return packed
    Lb = len(obs_list)
    D = X.shape[1]
    lens = np.fromiter((o.size for o in obs_list), dtype=np.int64, count=Lb)
    mb = np.arange(nmax, dtype=np.int64)[None, :] < lens[:, None]
    flat = np.concatenate(obs_list) if Lb else np.zeros(0, dtype=np.int64)
    xb = np.zeros((Lb, nmax, D), dtype=npdt)
    xb[mb] = X[flat]
    yb = np.zeros((Lb, nmax), dtype=npdt)
    yb[mb] = y[flat]
    return xb, yb, mb, lens.astype(np.int32)


def compile_tree(root: TreeNode, X: np.ndarray, pad_multiple: int = 8) -> SPNPlan:
    """Flatten the host-side tree into a static SPN plan (≙ the JAX
    package's ``compile_tree(..., overlap=False)``)."""
    N, D = X.shape
    leaves = get_leaves(root)
    for i, leaf in enumerate(leaves):
        leaf.index = i
    L = len(leaves)
    nmax = _round_up(max(int(l.obs.size) for l in leaves), pad_multiple)

    # --- heights -------------------------------------------------------
    heights = {}

    def height(node) -> int:
        key = id(node)
        if key in heights:
            return heights[key]
        if isinstance(node, LeafNode):
            h = 0
        else:
            h = 1 + max(height(c) for c in node.children)
        heights[key] = h
        return h

    height(root)

    # --- sum-edge ids in DFS preorder -----------------------------------
    edge_of: dict = {}  # id(sumnode) -> list of edge ids (per child)
    init_lw: List[float] = []
    edge_leaf_sum: List[bool] = []
    edge_neg_logk: List[float] = []

    def assign_edges(node):
        if isinstance(node, LeafNode):
            return
        if isinstance(node, SumNode):
            ids = []
            k = len(node.children)
            for c_i in range(k):
                eid = len(init_lw)
                ids.append(eid)
                init_lw.append(float(node.logweights[c_i]))
                edge_leaf_sum.append(node.is_leaf_sum)
                edge_neg_logk.append(-np.log(k))
            edge_of[id(node)] = ids
        for c in node.children:
            assign_edges(c)

    assign_edges(root)
    n_edges = len(init_lw)

    # --- group internal nodes by (height, kind) -------------------------
    internal: List[TreeNode] = []

    def collect(node):
        if isinstance(node, LeafNode):
            return
        for c in node.children:
            collect(c)
        internal.append(node)  # postorder (children first)

    collect(root)

    slot_of: dict = {}
    groups: List[UpwardGroup] = []
    slot_counter = L
    max_h = heights[id(root)] if internal else 0
    for h in range(1, max_h + 1):
        for kind, cls in (("split", SplitNode), ("sum", SumNode)):
            nodes = [n for n in internal if heights[id(n)] == h and isinstance(n, cls)]
            if not nodes:
                continue
            child_slots, seg, eids, nlk = [], [], [], []
            for p_i, node in enumerate(nodes):
                for c_i, c in enumerate(node.children):
                    cslot = c.index if isinstance(c, LeafNode) else slot_of[id(c)]
                    child_slots.append(cslot)
                    seg.append(p_i)
                    if kind == "sum":
                        eids.append(edge_of[id(node)][c_i])
                        nlk.append(-np.log(len(node.children)))
                    else:
                        eids.append(-1)
                        nlk.append(0.0)
                slot_of[id(node)] = slot_counter + p_i
            groups.append(
                UpwardGroup(
                    kind=kind,
                    child_slots=np.asarray(child_slots, dtype=np.int32),
                    seg=np.asarray(seg, dtype=np.int32),
                    n_parents=len(nodes),
                    edge_ids=np.asarray(eids, dtype=np.int32),
                    neg_logk=np.asarray(nlk, dtype=np.float64),
                )
            )
            slot_counter += len(nodes)

    root_slot = root.index if isinstance(root, LeafNode) else slot_of[id(root)]

    # --- leaf paths (sum edges from root to each leaf) -------------------
    leaf_edges: List[List[int]] = [[] for _ in range(L)]
    _stack: List[int] = []

    def walk(node):
        if isinstance(node, LeafNode):
            leaf_edges[node.index] = list(_stack)
            return
        is_sum = isinstance(node, SumNode)
        eids_here = edge_of[id(node)] if is_sum else None
        for c_i, c in enumerate(node.children):
            if is_sum:
                _stack.append(eids_here[c_i])
            walk(c)
            if is_sum:
                _stack.pop()

    walk(root)

    # sparse [L, Pmax] path form: each path crosses only O(depth) sum edges
    pmax = max((len(e) for e in leaf_edges), default=0)
    path_edges = np.zeros((L, max(pmax, 1)), dtype=np.int32)
    path_mask = np.zeros((L, max(pmax, 1)), dtype=bool)
    for i, es in enumerate(leaf_edges):
        path_edges[i, : len(es)] = es
        path_mask[i, : len(es)] = True

    # --- root-child group ids (PoE/gPoE/rBCM fusion grouping) ------------
    root_child = np.zeros(L, dtype=np.int32)
    if isinstance(root, (SplitNode, SumNode)):
        for c_i, c in enumerate(root.children):
            for leaf in get_leaves(c):
                root_child[leaf.index] = c_i

    kids = np.array([l.kernelid for l in leaves], dtype=np.int64)
    return SPNPlan(
        num_leaves=L,
        nmax=nmax,
        dim=D,
        leaf_obs=tuple(l.obs for l in leaves),
        leaf_lb=np.stack([l.lb for l in leaves]),
        leaf_ub=np.stack([l.ub for l in leaves]),
        leaf_kernelid=kids.astype(np.int32),
        leaf_mean=np.array([l.mean for l in leaves], dtype=np.float64),
        groups=tuple(groups),
        num_slots=slot_counter,
        root_slot=root_slot,
        n_sum_edges=n_edges,
        init_logweights=np.asarray(init_lw, dtype=np.float64),
        edge_is_leaf_sum=np.asarray(edge_leaf_sum, dtype=bool),
        edge_neg_logk=np.asarray(edge_neg_logk, dtype=np.float64),
        path_edges=path_edges,
        path_mask=path_mask,
        root_child_id=root_child,
        pad_multiple=pad_multiple,
    )


# ---------------------------------------------------------------------------
# Size bucketing — ragged leaf sizes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Leaves grouped into size classes, each padded to its own nmax."""

    nmaxs: Tuple[int, ...]
    leaf_ids: Tuple[np.ndarray, ...]  # global leaf index per bucket


def _bucket_quantum(n: float) -> int:
    """Pad quantum per size class: 128 up to 1024, so that those buckets
    are in the domain of the fused gram+Cholesky kernel
    (``ops/fused_chol.supported``: nmax % 128 == 0 and nmax <= 1024); 8
    above, where the torch.linalg path is size-agnostic and finer padding
    wins."""
    return 128 if n <= 1024 else 8


def _bucketize_geometric(sizes, base: int, growth: float) -> BucketSpec:
    grid = [base]
    while grid[-1] < sizes.max():
        nxt = int(np.ceil(grid[-1] * growth))
        grid.append(_round_up(nxt, _bucket_quantum(nxt)))
    keys = np.searchsorted(np.asarray(grid), sizes, side="left")
    nmaxs, ids = [], []
    for k in sorted(set(keys.tolist())):
        sel = np.where(keys == k)[0].astype(np.int32)
        # nmax is the bucket's actual largest member, rounded to the
        # quantum; the grid only assigns membership
        mx = int(sizes[sel].max())
        nmaxs.append(_round_up(mx, _bucket_quantum(mx)))
        ids.append(sel)
    return BucketSpec(tuple(nmaxs), tuple(ids))


def bucketize(plan: SPNPlan, base: int = 128, growth: float = 1.1) -> BucketSpec:
    """Group leaves into size classes (the JAX package's ``strategy='dp'``).

    Partition the SORTED leaf sizes into at most as many contiguous groups
    as the geometric grid (growth 1.1 from ``base``) would produce,
    choosing the boundaries that minimize total padded Cholesky FLOPs
    ``Σ count_b · nmax_b³`` by dynamic programming. Above 2000 leaves the
    O(L²K) DP is skipped and the geometric grid is used.
    """
    sizes = np.array([o.size for o in plan.leaf_obs])
    geo = _bucketize_geometric(sizes, base, growth)
    if len(sizes) > 2000:
        return geo
    K = len(geo.nmaxs)
    order = np.argsort(sizes, kind="stable")
    s = sizes[order].astype(np.float64)
    q = np.fromiter((_bucket_quantum(v) for v in s), dtype=np.float64,
                    count=len(s))
    up = np.ceil(s / q) * q  # pad to the same quantum rule as the grid
    n = len(s)
    dp = np.full((n + 1, K + 1), np.inf)
    dp[0, 0] = 0.0
    back = np.zeros((n + 1, K + 1), dtype=np.int64)
    cube = up**3
    for j in range(1, n + 1):
        for k in range(1, min(K, j) + 1):
            # group = leaves (i..j-1], cost = count * up[j-1]^3
            costs = dp[k - 1 : j, k - 1] + (
                np.arange(j - k + 1, 0, -1) * cube[j - 1]
            )
            i_best = int(np.argmin(costs))
            dp[j, k] = costs[i_best]
            back[j, k] = i_best + (k - 1)
    k = int(np.argmin(dp[n, 1 : K + 1])) + 1
    bounds = []
    j = n
    while k > 0:
        i = int(back[j, k])
        bounds.append((i, j))
        j, k = i, k - 1
    nmaxs, ids = [], []
    for i, j in reversed(bounds):
        nmaxs.append(int(up[j - 1]))
        ids.append(np.sort(order[i:j]).astype(np.int32))
    return BucketSpec(tuple(nmaxs), tuple(ids))


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def bucket_batches(plan: SPNPlan, spec: BucketSpec, X, y, dtype, device):
    """One padded ``LeafBatch`` per size bucket, its tensors on ``device``."""
    npdt = np.dtype(_NP_DTYPE[dtype])
    out = []
    for nmax_b, ids in zip(spec.nmaxs, spec.leaf_ids):
        xb, yb, mb, nb = _pad_leaf_arrays(
            [plan.leaf_obs[l] for l in ids], nmax_b, X, y, npdt
        )
        arrays = (xb, yb, mb, nb, plan.leaf_mean[ids].astype(npdt),
                  plan.leaf_kernelid[ids].astype(np.int32))
        out.append(LeafBatch(*(torch.from_numpy(np.ascontiguousarray(a))
                               .to(device) for a in arrays)))
    return tuple(out)
