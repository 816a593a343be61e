"""Model visualization (≙ the Plots.jl recipes in ``src/plot.jl``;
counterpart of ``deepstructuredmixtures_tpu/plotting.py``).

* ``plot_model`` — 1-D: predictive mean ± ``invΦ((1+β)/2)·σ`` ribbon plus
  training scatter (≙ ``plot.jl:18-83``); 2-D: n×n grid heatmap of the
  predictive mean or variance (≙ ``plot.jl:84-112``). ``show_splits``
  overlays the split thresholds (≙ node recipe, ``plot.jl:114-189``).
* ``plot_gp`` — raw exact-GP recipe (≙ ``plot.jl:191-226``).
* ``kernelid_function`` — which kernel dominates where, by posterior-
  weighted vote (≙ ``kernelidfunction``, ``plot.jl:5-16`` +
  ``kernelid``, ``common.jl:55-82``).

matplotlib is optional: importing this module without it raises only when a
plot function is called. Predictions come back from the model's device as
NumPy arrays.
"""
from __future__ import annotations

import numpy as np

from scipy.special import ndtri  # norminvcdf (plot.jl:3)

from .introspect import _membership


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for plotting") from e


def _moments(model, xt):
    """``(mu, var)`` of ``model.predict(xt)`` as NumPy arrays."""
    return (a.detach().cpu().numpy() for a in model.predict(xt))


def plot_model(model, beta: float = 0.95, n_grid: int = 200, show_splits=False,
               variance: bool = False, ax=None, path=None):
    """Plot a fitted model over its training domain. Returns the axis."""
    plt = _plt()
    X, y = model.X, model.y
    D = X.shape[1]
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))

    if D == 1:
        lo, hi = X[:, 0].min(), X[:, 0].max()
        pad = 0.05 * (hi - lo)
        xt = np.linspace(lo - pad, hi + pad, n_grid).reshape(-1, 1)
        mu, var = _moments(model, xt)
        q = ndtri((1.0 + beta) / 2.0)  # invΦ((1+β)/2), plot.jl:41
        sd = np.sqrt(np.maximum(var, 0.0))
        ax.fill_between(xt[:, 0], mu - q * sd, mu + q * sd, alpha=0.3,
                        label=f"{int(beta*100)}% interval")
        ax.plot(xt[:, 0], mu, lw=2, label="predictive mean")
        ax.scatter(X[:, 0], y, s=8, c="k", alpha=0.5, label="train")
        if show_splits:
            for s in _split_positions(model.root):
                ax.axvline(s, color="gray", ls="--", lw=0.7)
        ax.legend()
    elif D == 2:
        n = int(np.sqrt(n_grid)) * 4
        g1 = np.linspace(X[:, 0].min(), X[:, 0].max(), n)
        g2 = np.linspace(X[:, 1].min(), X[:, 1].max(), n)
        G1, G2 = np.meshgrid(g1, g2)
        xt = np.stack([G1.ravel(), G2.ravel()], axis=1)
        mu, var = _moments(model, xt)
        z = (var if variance else mu).reshape(n, n)
        im = ax.pcolormesh(G1, G2, z, shading="auto")
        ax.figure.colorbar(im, ax=ax)
        ax.scatter(X[:, 0], X[:, 1], s=4, c="k", alpha=0.4)
    else:
        raise ValueError("plot_model supports 1-D and 2-D inputs only")

    if path:
        ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    return ax


def _split_positions(node):
    from .tree import LeafNode, SplitNode

    if isinstance(node, LeafNode):
        return []
    out = []
    if isinstance(node, SplitNode):
        out.extend(t for t in node.thresholds[:-1] if np.isfinite(t))
    for c in node.children:
        out.extend(_split_positions(c))
    return out


def plot_gp(gp, beta: float = 0.95, n_grid: int = 200, ax=None, path=None):
    """Plot a standalone exact GP (≙ ``plot.jl:191-226``)."""
    plt = _plt()
    X = gp.x.cpu().numpy()
    y = gp.yc.cpu().numpy() + gp.mean_value
    if X.shape[1] != 1:
        raise ValueError("plot_gp supports 1-D inputs only")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    lo, hi = X[:, 0].min(), X[:, 0].max()
    pad = 0.05 * (hi - lo)
    xt = np.linspace(lo - pad, hi + pad, n_grid).reshape(-1, 1)
    mu, var = _moments(gp, xt)
    q = ndtri((1.0 + beta) / 2.0)
    sd = np.sqrt(np.maximum(var, 0.0))
    ax.fill_between(xt[:, 0], mu - q * sd, mu + q * sd, alpha=0.3)
    ax.plot(xt[:, 0], mu, lw=2)
    ax.scatter(X[:, 0], y, s=8, c="k", alpha=0.5)
    if path:
        ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    return ax


def kernelid_function(model, xt):
    """Dominant kernel id per test point, by posterior-weighted vote over
    active leaves (≙ ``kernelid``, ``common.jl:55-82``)."""
    xt, member, pw = _membership(model, xt)
    kid = np.asarray(model.plan.leaf_kernelid)
    T = xt.shape[0]
    out = np.zeros(T, dtype=np.int64)
    for t in range(T):
        act = np.where(member[t])[0]
        w = np.exp(pw[act])
        scores = {}
        for a, wa in zip(act, w):
            scores[kid[a]] = scores.get(kid[a], 0.0) + wa
        out[t] = max(scores, key=scores.get)
    return out
