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
  placed on the device as one ``LeafBatch`` (or all leaves as one
  monolithic ``[L, nmax]`` batch, :meth:`SPNPlan.leaf_batch`);
* the leaf-overlap matrix ``D`` (≙ ``getOverlap``, ``fit.jl:12-39``) and
  the shared-Cholesky schedule (≙ the dynamic case analysis of
  ``fit.jl:67-292``) are precomputed on the host.

NumPy (and scipy for the sparse overlap) on the host, array for array
equal to the JAX package's plan and schedule for the same tree
(``tests/test_torch_host.py``, ``tests/test_torch_shared.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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
    #: the D matrix: dense ``[L, L]``, scipy CSR or :class:`MixtureOverlap`;
    #: None when compiled with ``overlap=False``
    overlap: Optional[object] = None

    @property
    def path_matrix(self) -> np.ndarray:
        """Dense ``[L, E]`` 0/1 leaf-path matrix, materialized on demand
        from the sparse ``path_edges`` / ``path_mask`` form (host-side
        diagnostics only; ~1 GB at 20k leaves × 5k edges)."""
        L = self.num_leaves
        dense = np.zeros((L, max(self.n_sum_edges, 1)), dtype=np.float64)
        rows = np.repeat(np.arange(L), self.path_mask.sum(axis=1))
        dense[rows, self.path_edges[self.path_mask]] = 1.0
        return dense

    def leaf_batch(self, X, y, dtype, device) -> LeafBatch:
        """The monolithic ``[L, nmax]`` leaf batch on ``device``: every leaf
        padded to the plan's ``nmax`` (the whole-model fit paths and the
        full store read it)."""
        return _leaf_batch(self, range(self.num_leaves), self.nmax, X, y,
                           dtype, device)


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


#: leaf count above which a single-kernel overlap matrix is stored sparse
#: (scipy CSR): at 20.7k leaves the dense [L, L] float64 D is 3.4 GB while
#: under 1% of its entries are nonzero
DENSE_OVERLAP_MAX = 2048


class MixtureOverlap:
    """Sparse leaf-overlap matrix of a kernel-mixture tree.

    The reference's ``getOverlap`` (``fit.jl:12-39``) gives cross-kernel
    pairs under a common sum node ``D = 1.0`` (its ``* (kernelid ==
    kernelid)`` factor zeroes the set-difference term, ``fit.jl:28-31``):
    structurally dense, but depending only on kernel ids and on whether
    the pair's lowest common ancestor is a sum node. This class stores

    * ``same``: CSR of the same-kernel intersection ratios ``|obs_i ∩
      obs_j| / |obs_i|`` and its transpose ``sameT``;
    * ``iv[j]``: per-leaf DFS intervals covering exactly the leaves whose
      lowest common ancestor with ``j`` is a sum node (a subtree's leaves
      are a contiguous DFS range),

    and materializes rows and columns on demand: cross-kernel positions
    inside ``iv[j]`` are 1.0, same-kernel ones come from the CSR."""

    def __init__(self, same, sameT, kid, iv, L: int):
        self.same = same
        self.sameT = sameT
        self.kid = np.asarray(kid)
        self.iv = iv
        self.shape = (L, L)
        self.nnz = int(same.nnz)

    def _structural(self, j: int) -> np.ndarray:
        r = np.zeros(self.shape[0])
        kj = self.kid[j]
        for lo, hi in self.iv[j]:
            seg = r[lo:hi]
            seg[self.kid[lo:hi] != kj] = 1.0
        return r

    def _fill_same(self, r: np.ndarray, csr, j: int) -> np.ndarray:
        sl = slice(csr.indptr[j], csr.indptr[j + 1])
        r[csr.indices[sl]] = csr.data[sl]
        return r

    def row(self, j: int) -> np.ndarray:
        """Dense ``D[j, :]``."""
        return self._fill_same(self._structural(j), self.same, j)

    def col(self, j: int) -> np.ndarray:
        """Dense ``D[:, j]`` (the structural part is symmetric; the ratio
        part transposes)."""
        return self._fill_same(self._structural(j), self.sameT, j)

    def rows(self, idx) -> np.ndarray:
        """Dense ``D[idx, :]`` block ``[C, L]``."""
        return np.stack([self.row(int(j)) for j in np.asarray(idx)])

    def main_partners(self) -> np.ndarray:
        """``main[j] = argmax_i D[i, j] * D[j, i]`` with ``np.argmax``'s
        first-max ties, as the dense schedule selects partners
        (``fit.jl:77-86``), one materialized column at a time."""
        L = self.shape[0]
        main = np.zeros(L, dtype=np.int64)
        for j in range(L):
            main[j] = int(np.argmax(self.col(j) * self.row(j)))
        return main


def _overlap_matrix(root, leaves, sizes, kids, fmt: str):
    """The leaf-overlap matrix D (≙ ``getOverlap``, ``fit.jl:12-39``),
    computed sparsely: observation sets can only intersect where bounding
    boxes do, so candidate pairs come from a box-intersection sweep
    (``native.box_pairs``) and only their ``|obs_i ∩ obs_j|`` are counted
    (``native.pair_intersect``).

    ``D[n, m] = |obs_n ∩ obs_m| / |obs_n|`` for same-kernel pairs under a
    common sum node, ``1.0`` for different-kernel pairs under a common sum
    (the reference's operator-precedence quirk, kept), ``0`` otherwise.
    Pairs whose lowest common ancestor is a split have disjoint
    observations, so for single-kernel trees D is the intersection ratios
    alone.

    ``fmt``: ``'dense'`` | ``'sparse'`` | ``'auto'`` (sparse above
    ``DENSE_OVERLAP_MAX`` leaves). Sparse single-kernel D is a scipy CSR,
    sparse multi-kernel D a :class:`MixtureOverlap`."""
    L = len(leaves)
    from .utils.native import box_pairs, pair_intersect

    lb = np.stack([l.lb for l in leaves]).astype(np.float64)
    ub = np.stack([l.ub for l in leaves]).astype(np.float64)
    pi, pj = box_pairs(lb, ub)
    cnt = pair_intersect([l.obs for l in leaves], pi, pj).astype(np.float64)

    single_kernel = bool(np.all(kids == kids[0]))
    if fmt == "auto":
        fmt = "sparse" if L > DENSE_OVERLAP_MAX else "dense"
    if fmt == "sparse":
        import scipy.sparse as sp

        nz = cnt > 0
        if not single_kernel:
            # the CSR holds the same-kernel ratios only; cross-kernel pairs
            # are structural (MixtureOverlap)
            nz = nz & (kids[pi] == kids[pj])
        rows = np.concatenate([pi[nz], pj[nz]])
        cols = np.concatenate([pj[nz], pi[nz]])
        vals = np.concatenate([cnt[nz] / sizes[pi[nz]], cnt[nz] / sizes[pj[nz]]])
        same = sp.csr_matrix((vals, (rows, cols)), shape=(L, L),
                             dtype=np.float64)
        if single_kernel:
            return same

        # per-leaf sum-LCA intervals: leaves in different children of a sum
        # node have their lowest common ancestor exactly there
        iv = [[] for _ in range(L)]

        def walk_iv(node):
            if isinstance(node, LeafNode):
                return node.index, node.index + 1
            spans = [walk_iv(c) for c in node.children]
            lo = min(s[0] for s in spans)
            hi = max(s[1] for s in spans)
            assert hi - lo == sum(s[1] - s[0] for s in spans), (
                "subtree leaf indices are not DFS-contiguous")
            if isinstance(node, SumNode):
                for a, (alo, ahi) in enumerate(spans):
                    for b, (blo, bhi) in enumerate(spans):
                        if a != b:
                            for l in range(alo, ahi):
                                iv[l].append((blo, bhi))
            return lo, hi

        walk_iv(root)
        return MixtureOverlap(same, same.T.tocsr(), kids, iv, L)

    inter = np.zeros((L, L), dtype=np.float64)
    inter[pi, pj] = cnt
    inter[pj, pi] = cnt
    Dmat = np.zeros((L, L), dtype=np.float64)

    def walk(node) -> List[int]:
        if isinstance(node, LeafNode):
            return [node.index]
        grps = [walk(c) for c in node.children]
        if isinstance(node, SumNode):
            for a in range(len(grps)):
                for b in range(a + 1, len(grps)):
                    gi = np.asarray(grps[a])
                    gj = np.asarray(grps[b])
                    same = kids[gi][:, None] == kids[gj][None, :]
                    c = inter[np.ix_(gi, gj)]
                    # D[n,m] = 1 - |n\m|/|n| if same kernel else 1
                    Dmat[np.ix_(gi, gj)] = np.where(same, c / sizes[gi][:, None],
                                                    1.0)
                    Dmat[np.ix_(gj, gi)] = np.where(same.T,
                                                    c.T / sizes[gj][:, None], 1.0)
        return [i for g in grps for i in g]

    walk(root)
    return Dmat


def compile_tree(root: TreeNode, X: np.ndarray, pad_multiple: int = 8,
                 overlap: bool = True, overlap_format: str = "auto") -> SPNPlan:
    """Flatten the host-side tree into a static SPN plan (≙ the JAX
    package's ``compile_tree``).

    ``overlap=False`` skips the leaf-overlap analysis (the D matrix), which
    only the shared-Cholesky schedule needs; the plan's ``overlap`` is then
    ``None`` and :func:`build_schedule` raises. ``overlap_format``: how D
    is stored, ``'dense'``, ``'sparse'`` or ``'auto'`` (see
    :func:`_overlap_matrix`)."""
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
    sizes = np.array([l.obs.size for l in leaves], dtype=np.float64)
    Dmat = (_overlap_matrix(root, leaves, sizes, kids, overlap_format)
            if overlap else None)
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
        overlap=Dmat,
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


def _leaf_batch(plan: SPNPlan, ids, nmax: int, X, y, dtype, device):
    """The leaves ``ids`` padded to ``nmax`` as one ``LeafBatch`` on
    ``device``."""
    npdt = np.dtype(_NP_DTYPE[dtype])
    ids = np.asarray(ids, dtype=np.int64)
    xb, yb, mb, nb = _pad_leaf_arrays([plan.leaf_obs[l] for l in ids], nmax,
                                      X, y, npdt)
    arrays = (xb, yb, mb, nb, plan.leaf_mean[ids].astype(npdt),
              plan.leaf_kernelid[ids].astype(np.int32))
    return LeafBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrays))


def bucket_batches(plan: SPNPlan, spec: BucketSpec, X, y, dtype, device):
    """One padded ``LeafBatch`` per size bucket, its tensors on ``device``."""
    return tuple(_leaf_batch(plan, ids, nmax_b, X, y, dtype, device)
                 for nmax_b, ids in zip(spec.nmaxs, spec.leaf_ids))


# ---------------------------------------------------------------------------
# Shared-Cholesky schedule (≙ fit!'s dynamic case analysis, fit.jl:67-292)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SharedSchedule:
    """Static factor-reuse plan.

    The reference decides copy / row-delete / continue per leaf at run time
    (``fit.jl:88-119``); the case analysis depends only on the index sets,
    so it is computed once on the host: fully factor ``full_idx``; copy
    factors along ``(copy_j ← copy_i)``; Givens-delete rows for the
    ``del_*`` group; (delete-then-)continue the Cholesky for the ``cont_*``
    group."""

    full_idx: np.ndarray  # [F]
    copy_j: np.ndarray
    copy_i: np.ndarray
    del_j: np.ndarray
    del_i: np.ndarray
    del_pos: np.ndarray  # [Gd, Dmax] positions (in main's rows) to delete
    del_ndel: np.ndarray  # [Gd]
    del_keep: np.ndarray  # [Gd, Nmax] main-row position of each kept row
    cont_j: np.ndarray
    cont_i: np.ndarray
    cont_p: np.ndarray  # [Gc] number of already-factored leading rows
    cont_del_pos: np.ndarray  # [Gc, Dmax'] main-row positions to delete first
    cont_del_ndel: np.ndarray  # [Gc]
    cont_keep: np.ndarray  # [Gc, Nmax] main-row position of each kept row

    @property
    def num_derived(self) -> int:
        return self.copy_j.size + self.del_j.size + self.cont_j.size


def _share_case(oj: np.ndarray, oi: np.ndarray, tau: float):
    """Factor-reuse analysis of leaf ``oj`` against main ``oi`` (sorted
    global index arrays).

    ``prefix`` is the elements of ``oj`` up to main's last observation. If
    ``prefix ⊆ oi`` and the rows of ``oi`` not in ``prefix`` (ahead of the
    last kept row) are few (< τ·|oj|), main's factor row-deletes down to
    the factor of ``prefix`` and a continued Cholesky extends it to all of
    ``oj``. ``prefix == oj`` is the reference's pure row-delete path
    (``fit.jl:145-206``) and zero deletions its prefix extension
    (``fit.jl:208-292``); the mixed form is the superset that the
    reference's ``(true,false)`` machinery aims at (``fit.jl:251-281``) but
    never reaches.

    Returns ``None`` (no reuse) or ``(kind, dels, keep, k)`` with ``kind``
    in ``{'copy', 'delete', 'continue'}``, ``dels``/``keep`` positions in
    main's rows and ``k = |prefix|`` the continue start."""
    max_m = oi[-1]
    k = int(np.searchsorted(oj, max_m, side="right"))
    if k == 0:
        return None
    prefix = oj[:k]
    member = np.isin(oi, prefix)
    if int(member.sum()) != k:  # prefix ⊄ main
        return None
    keep = np.where(member)[0]
    # deletions past the last kept row never touch a kept row (a Givens
    # delete at r only corrects rows > r): drop them
    dels = np.where(~member)[0]
    dels = dels[dels < keep[-1]]
    # τ gates deletion-bearing derivations only (fit.jl:174,256 caps the
    # Givens update count); copies and pure prefix extensions derive at
    # any τ, τ=0 included
    if dels.size and dels.size >= tau * oj.size:
        return None
    if k == oj.size:
        if dels.size == 0 and keep.size == oi.size:
            return ("copy", dels, keep, k)
        return ("delete", dels, keep, k)
    return ("continue", dels, keep, k)


def build_schedule(plan: SPNPlan, tau: float = 0.05) -> SharedSchedule:
    """Compile the reference's ``fit!`` scheduling into static groups.

    Main partner ``i = argmax(D[:,j] .* D[j,:])`` (``fit.jl:77-86``); the
    case analysis generalizes ``fit.jl:107-116`` (:func:`_share_case`; the
    reference's kernel-id and ``first(obs)`` guards are implied by the
    prefix-membership test). Mains of derived leaves are always fully
    factored (the reference factors them on first use,
    ``fit.jl:97-100``)."""
    if plan.overlap is None:
        raise ValueError(
            "this plan was compiled with overlap=False (no D matrix); "
            "rebuild the model with overlap=True to use the shared-"
            "Cholesky schedule")
    import scipy.sparse as sp

    D = plan.overlap
    L = plan.num_leaves
    obs = plan.leaf_obs
    kid = plan.leaf_kernelid
    if isinstance(D, MixtureOverlap):
        main = D.main_partners()
    elif sp.issparse(D):
        # D ∘ Dᵀ keeps the CSR pattern; argmax per column matches np.argmax
        # (first index on ties and on all-zero columns)
        main = np.asarray(D.multiply(D.T).tocsc().argmax(axis=0)).ravel()
    else:
        main = np.argmax(D * D.T, axis=0)  # main[j] = i

    case = {}
    for j in range(L):
        i = int(main[j])
        if i == j or kid[i] != kid[j]:
            case[j] = ("full",)
            continue
        c = _share_case(obs[j], obs[i], tau)
        if c is None:
            case[j] = ("full",)
        elif c[0] == "copy":
            case[j] = ("copy", i)
        elif c[0] == "delete":
            case[j] = ("delete", i, c[1], c[2])
        else:
            case[j] = ("continue", i, c[3], c[1], c[2])

    # --- resolve dependencies ------------------------------------------
    # Copy chains go to their canonical source (identical observation sets
    # are transitive); copy cycles collapse onto their smallest index,
    # which becomes full. Mains of delete/continue leaves must be fully
    # factored, so a derived main is promoted to full. ``fit_shared`` then
    # runs full → delete → continue → copy.
    def canon(j, seen=None):
        seen = seen or set()
        while case[j][0] == "copy":
            if j in seen:
                j = min(seen)
                case[j] = ("full",)
                break
            seen.add(j)
            j = case[j][1]
        return j

    for j in range(L):
        if case[j][0] == "copy":
            src = canon(case[j][1], {j})
            case[j] = ("copy", src) if src != j else ("full",)
        elif case[j][0] in ("delete", "continue"):
            m = case[j][1]
            src = canon(m)
            if case[src][0] != "full":
                case[src] = ("full",)
            if src != m:
                # positions were computed against m's rows; identical
                # observation sets make them valid against src too
                case[j] = (case[j][0], src) + case[j][2:]

    derived = [j for j in range(L) if case[j][0] != "full"]
    full_idx = np.array(sorted({j for j in range(L) if case[j][0] == "full"}),
                        dtype=np.int32)

    copy_j = np.array([j for j in derived if case[j][0] == "copy"], dtype=np.int32)
    copy_i = np.array([case[j][1] for j in copy_j], dtype=np.int32)

    del_js = [j for j in derived if case[j][0] == "delete"]
    dmax = max((case[j][2].size for j in del_js), default=1)
    del_j = np.asarray(del_js, dtype=np.int32)
    del_i = np.array([case[j][1] for j in del_js], dtype=np.int32)
    del_pos = np.zeros((len(del_js), max(dmax, 1)), dtype=np.int32)
    del_ndel = np.zeros(len(del_js), dtype=np.int32)
    del_keep = np.zeros((len(del_js), plan.nmax), dtype=np.int32)
    for g, j in enumerate(del_js):
        _, _, dels, keep = case[j]
        del_pos[g, : dels.size] = dels
        del_ndel[g] = dels.size
        del_keep[g, : keep.size] = keep

    cont_js = [j for j in derived if case[j][0] == "continue"]
    cdmax = max((case[j][3].size for j in cont_js), default=1)
    cont_j = np.asarray(cont_js, dtype=np.int32)
    cont_i = np.array([case[j][1] for j in cont_js], dtype=np.int32)
    cont_p = np.array([case[j][2] for j in cont_js], dtype=np.int32)
    cont_del_pos = np.zeros((len(cont_js), max(cdmax, 1)), dtype=np.int32)
    cont_del_ndel = np.zeros(len(cont_js), dtype=np.int32)
    cont_keep = np.zeros((len(cont_js), plan.nmax), dtype=np.int32)
    for g, j in enumerate(cont_js):
        _, _, k, dels, keep = case[j]
        cont_del_pos[g, : dels.size] = dels
        cont_del_ndel[g] = dels.size
        # the gathered factor's leading k rows are the kept main rows; the
        # rest of the gather map is masked past P by chol_continue but must
        # stay in bounds
        cont_keep[g, : keep.size] = keep

    return SharedSchedule(
        full_idx=full_idx, copy_j=copy_j, copy_i=copy_i, del_j=del_j,
        del_i=del_i, del_pos=del_pos, del_ndel=del_ndel, del_keep=del_keep,
        cont_j=cont_j, cont_i=cont_i, cont_p=cont_p,
        cont_del_pos=cont_del_pos, cont_del_ndel=cont_del_ndel,
        cont_keep=cont_keep)
