"""SPN evaluation on the flattened plan: marginal likelihood, posterior
weight update and the per-leaf path weights (counterpart of the
fit/update/predict part of ``deepstructuredmixtures_tpu/infer.py``).

* ``upward`` — level-wise gather + segment-reduce over the plan's groups
  (≙ the ``mll``/``mll!`` recursions, ``optimize.jl:18-39``);
* ``update_weights`` — posterior sum-weight update and root log evidence
  (≙ ``update!``, ``common.jl:323-334``);
* ``path_logweights`` — each leaf's mixture log-weight, the sum of the
  sum-edge log-weights on its root-to-leaf path.

The weight update runs in float64 whatever the leaf dtype: its
``logsumexp`` normalization feeds the predictive moment matching, whose
cancellations would floor the f32 end-to-end variance (the JAX package's
``combine_in_f64`` default, here a plain ``.double()``).
"""
from __future__ import annotations

import torch

from .plan import SPNPlan


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def _segment_max(x, seg, num_segments):
    init = torch.full((num_segments,), -torch.inf, dtype=x.dtype, device=x.device)
    return init.scatter_reduce(0, seg, x, reduce="amax", include_self=True)


def _segment_sum(x, seg, num_segments):
    out = torch.zeros((num_segments,), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def _segment_logsumexp(x, seg, num_segments):
    m = _segment_max(x, seg, num_segments)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = _segment_sum(torch.exp(x - m_safe[seg]), seg, num_segments)
    return torch.where(torch.isfinite(m), m_safe + torch.log(s), m)


def upward(plan: SPNPlan, leaf_vals, logweights=None):
    """All node values ``[num_slots]`` from leaf values ``[L]``: sum of the
    children at split nodes, logsumexp of ``w + child`` at sum nodes, with
    ``w`` the uniform ``-log K`` (the mll semantics) or the given flat edge
    log-weights."""
    dev = leaf_vals.device
    vals = leaf_vals
    for g in plan.groups:
        child = vals[_index(g.child_slots, dev)]
        seg = _index(g.seg, dev)
        if g.kind == "split":
            new = _segment_sum(child, seg, g.n_parents)
        else:
            if logweights is None:
                w = torch.as_tensor(g.neg_logk, dtype=vals.dtype, device=dev)
            else:
                w = logweights[_index(g.edge_ids, dev)]
            new = _segment_logsumexp(child + w, seg, g.n_parents)
        vals = torch.cat([vals, new])
    return vals


def root_mll(plan: SPNPlan, leaf_mlls):
    """Root marginal log-likelihood (≙ ``mll(model)``, ``optimize.jl:25``)."""
    return upward(plan, leaf_mlls)[plan.root_slot]


def update_weights(plan: SPNPlan, leaf_mlls):
    """Posterior sum-node weights and root log evidence, in float64
    (≙ ``update!``, ``common.jl:323-334``): every sum node's edge weights
    become ``normalize(-log K + child mll)``. Returns ``(logweights [E],
    z_root)``."""
    leaf_mlls = leaf_mlls.double()
    dev = leaf_mlls.device
    vals = upward(plan, leaf_mlls)
    lw = torch.zeros((max(plan.n_sum_edges, 1),), dtype=torch.float64, device=dev)
    for g in plan.groups:
        if g.kind != "sum":
            continue
        seg = _index(g.seg, dev)
        raw = vals[_index(g.child_slots, dev)] + torch.as_tensor(
            g.neg_logk, dtype=torch.float64, device=dev)
        z = _segment_logsumexp(raw, seg, g.n_parents)
        lw[_index(g.edge_ids, dev)] = raw - z[seg]
    return lw, vals[plan.root_slot]


def path_logweights(plan: SPNPlan, logweights):
    """Per-leaf mixture log-weight ``[L]``: the sum of the sum-edge
    log-weights on the root-to-leaf path (sparse ``[L, Pmax]`` form)."""
    dev = logweights.device
    idx = _index(plan.path_edges, dev)
    msk = torch.as_tensor(plan.path_mask, device=dev)
    lw = torch.cat([logweights, logweights.new_zeros(1)])
    gathered = lw[torch.where(msk, idx, logweights.shape[0])]
    return torch.sum(gathered, dim=1)
