"""SPN evaluation on the flattened plan: marginal likelihood, posterior
weight update and the per-leaf path weights (counterpart of the
fit/update/predict part of ``deepstructuredmixtures_tpu/infer.py``).

* ``upward`` — level-wise gather + segment-reduce over the plan's groups
  (≙ the ``mll``/``mll!`` recursions, ``optimize.jl:18-39``);
* ``update_weights`` — posterior sum-weight update and root log evidence
  (≙ ``update!``, ``common.jl:323-334``); ``infer_weights`` (≙
  ``infer!``) and ``reset_weights`` (≙ ``reset_weights!``);
* ``leaf_responsibilities`` — each leaf's posterior responsibility, the
  gradient of the root mll with respect to the leaf mlls;
* ``leaf_membership`` — which leaves' boxes hold each test point;
* ``path_logweights`` — each leaf's mixture log-weight, the sum of the
  sum-edge log-weights on its root-to-leaf path;
* ``predict_poe`` / ``predict_gpoe`` / ``predict_rbcm`` — the product-of-
  experts fusions of per-leaf moments (``common.jl:145-273``).

The weight update and the fusions run in float64 whatever the leaf dtype: its
``logsumexp`` normalization feeds the predictive moment matching, whose
cancellations would floor the f32 end-to-end variance (the JAX package's
``combine_in_f64`` default, here a plain ``.double()``).
"""
from __future__ import annotations

import torch

from .plan import SPNPlan
from .utils import profiling


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
    dev = leaf_mlls.device
    with profiling.span("update_weights", device=dev):
        vals = upward(plan, leaf_mlls.double())
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


def infer_weights(plan: SPNPlan, leaf_mlls):
    """≙ ``infer!`` (``common.jl:336-355``): :func:`update_weights`, then
    every sum node above the leaf-level kernel-mixture sums reset to
    uniform. Returns ``(logweights [E], z_root)`` in float64."""
    lw, z = update_weights(plan, leaf_mlls)
    dev = lw.device
    is_leaf_sum = torch.as_tensor(plan.edge_is_leaf_sum, device=dev)
    uniform = torch.as_tensor(plan.edge_neg_logk, dtype=lw.dtype, device=dev)
    return torch.where(is_leaf_sum, lw, uniform), z


def leaf_responsibilities(plan: SPNPlan, leaf_mlls):
    """Posterior responsibility of every leaf under uniform sum weights,
    ``w_l = exp(mll_l + path_prefix − root)`` (≙ the per-leaf weight of
    ``∇mll!``, ``optimize.jl:42-89``): the gradient of the root mll with
    respect to the leaf mlls, in float64. Returns ``[L]``, summing to one
    per mixture path."""
    lm = leaf_mlls.detach().double().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(root_mll(plan, lm), lm)
    return g


def reset_weights(plan: SPNPlan, device=None):
    """Uniform ``-log K`` weights on every sum edge, float64 (≙
    ``reset_weights!``, ``common.jl:357-363``)."""
    return torch.as_tensor(plan.edge_neg_logk, dtype=torch.float64,
                           device=device)


def leaf_membership(plan: SPNPlan, xt):
    """Boolean ``[T, L]``: leaf active iff ``lb < x <= ub`` in every
    dimension, which is the recursive split routing (``getchild``,
    ``common.jl:101-122``), since split segments are half-open and sum
    children share the parent's box. ``xt [T, D]`` tensor."""
    lb = torch.as_tensor(plan.leaf_lb, dtype=xt.dtype, device=xt.device)
    ub = torch.as_tensor(plan.leaf_ub, dtype=xt.dtype, device=xt.device)
    ok = (xt[:, None, :] > lb[None]) & (xt[:, None, :] <= ub[None])
    return torch.all(ok, dim=-1)


def path_logweights(plan: SPNPlan, logweights):
    """Per-leaf mixture log-weight ``[L]``: the sum of the sum-edge
    log-weights on the root-to-leaf path (sparse ``[L, Pmax]`` form)."""
    dev = logweights.device
    idx = _index(plan.path_edges, dev)
    msk = torch.as_tensor(plan.path_mask, device=dev)
    lw = torch.cat([logweights, logweights.new_zeros(1)])
    gathered = lw[torch.where(msk, idx, logweights.shape[0])]
    return torch.sum(gathered, dim=1)


def predict_poe(mu, var):
    """Product-of-experts fusion over all experts, in float64 (≙
    ``_predictPoE`` + ``predictPoE``, ``common.jl:145-149,198-208,256-260``).
    ``mu, var [L, T]``; returns ``(mean [T], var [T])``."""
    mu, var = mu.double(), var.double()
    t = 1.0 / var
    tsum = torch.sum(t, dim=0)
    return torch.sum(t * mu, dim=0) / tsum, 1.0 / tsum


def _group_poe(plan: SPNPlan, mu, var):
    """Per-root-child PoE fusion: ``(mu_c [C, T], t_c [C, T])``."""
    gid = _index(plan.root_child_id, mu.device)
    n_groups = int(plan.root_child_id.max()) + 1
    t = 1.0 / var
    shape = (n_groups, mu.shape[1])
    tw = torch.zeros(shape, dtype=mu.dtype, device=mu.device).index_add_(0, gid, t)
    mw = torch.zeros(shape, dtype=mu.dtype, device=mu.device).index_add_(
        0, gid, t * mu)
    return mw / tw, tw


def predict_gpoe(plan: SPNPlan, mu, var):
    """Generalized PoE with ``β = 1/M``, M the number of root children, in
    float64 (≙ ``_predictgPoE``, ``common.jl:211-222,263-267``)."""
    mu_c, t_c = _group_poe(plan, mu.double(), var.double())
    beta = 1.0 / mu_c.shape[0]
    tsum = torch.sum(beta * t_c, dim=0)
    return torch.sum(beta * t_c * mu_c, dim=0) / tsum, 1.0 / tsum


def predict_rbcm(plan: SPNPlan, mu, var, prior_var):
    """Robust Bayesian committee machine, in float64 (≙ ``_predictrBCM``,
    ``common.jl:224-241,269-273``). ``prior_var [T]`` is the prior variance
    ``diag(k(x, x)) + noise`` of the first leaf GP
    (``common.jl:227-228``)."""
    mu_c, t_c = _group_poe(plan, mu.double(), var.double())
    prior_var = prior_var.double()
    s = prior_var[None, :]
    beta = 0.5 * (torch.log(s) - torch.log(1.0 / t_c))  # [C, T]
    C = 1.0 / prior_var + torch.sum(beta * t_c - beta / s, dim=0)
    return torch.sum(mu_c * beta * t_c, dim=0) / C, 1.0 / C
