"""Plain reference of a DSMGP with one isotropic squared-exponential kernel.

Written from the model's equations (Trapp et al., "Deep Structured
Mixtures of Gaussian Processes", AISTATS 2020; DeepStructuredMixtures.jl),
in plain PyTorch on whatever device it is given and NumPy on the host. It
imports nothing of the program under test and takes nothing the program
made: from the raw data it builds its own partition (``partition.py``),
its own leaf grams and factors, its own posterior weights and its own
moments.

* Leaf GP (one per leaf, on the leaf's points): ``K = s² exp(-|x-x'|² /
  (2 l²)) + (noise + jitter) I`` with ``s = exp(logsigma)``, ``l =
  exp(logl)``, ``noise = exp(2 lognoise)``, jitter 1e-8; the targets
  centred by the leaf's mean of y; ``mll = -(yᵀK⁻¹y + log|K| + n log 2π)/2``;
  at a test point ``mean = m + k*ᵀK⁻¹y``, ``var = s² - k*ᵀK⁻¹k* + noise``.
* SPN: a split node adds its children's values, a sum node with ``k``
  children takes ``log Σ exp(child) / k``; the posterior weight of a sum
  edge is ``exp(child - log k - node)``; the root's value is the log
  evidence. A test point's mixture runs over the leaves whose boxes
  ``lb < x <= ub`` hold it, each weighted by the product of the posterior
  weights on its path: ``mean = Σ w μ``, ``var = Σ w (σ² + μ²) - mean²``.
* The training objective is the root's value under uniform weights as a
  function of ``(logl, logsigma, lognoise)``, differentiated by autograd,
  and the optimizer is Adam as published (Kingma and Ba, 2015).

Leaves are computed in blocks of similar size, padded with identity rows,
zero targets and zero cross-covariances, which change nothing. ``dtype``
float64 is the reference; the control runs the same code in float32 with
TF32 allowed (:func:`precision`). In training the control forms each
gram by inner products, ``|x|² + |x'|² - 2<x, x'>``, as the program does,
and takes those products in TF32 (:func:`tf32`): the one step below the
program's float32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import partition

JITTER = 1e-8
LOG2PI = math.log(2.0 * math.pi)
#: bytes of one block's padded matrices, so that the reference fits beside
#: nothing else on the card
BLOCK_BYTES = 1 << 30


def tf32(t):
    """Float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest: the
    operand a tensor core takes with TF32 allowed. The same on any device,
    so the control reads alike on the CPU."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def precision(dtype):
    """Run in ``dtype``; float32 with TF32 allowed in matrix products (the
    control), float64 with the products as they are."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = dtype == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Model:
    """The reference's own tree over the raw data ``x [N, D]``, ``y [N]``
    under the configuration ``cfg`` (a configuration file's model keys)."""

    def __init__(self, x, y, cfg):
        kinds = [k["kind"] for k in cfg["kernels"]]
        if kinds != ["iso_se"]:
            raise ValueError(f"this reference holds one iso_se leaf kernel, not {kinds}: "
                             "a configuration whose model differs names its own reference")
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.cfg = cfg
        self.root, self.leaves = partition.build(self.x, self.y, cfg)
        self.sizes = np.array([lf["obs"].size for lf in self.leaves])
        self.lb = np.stack([lf["lb"] for lf in self.leaves])
        self.ub = np.stack([lf["ub"] for lf in self.leaves])

    # -- routing -----------------------------------------------------------
    def members(self, xt):
        """Per leaf, the indices of the test points its box holds."""
        xt = np.asarray(xt, dtype=np.float64)
        inside = np.all((xt[:, None, :] > self.lb[None]) & (xt[:, None, :] <= self.ub[None]),
                        axis=-1)
        return [np.nonzero(inside[:, i])[0] for i in range(len(self.leaves))]

    def blocks(self, itemsize):
        """Leaf index blocks of similar size, largest first."""
        order = np.argsort(-self.sizes, kind="stable")
        out, cur, nmax = [], [], 0
        for i in order:
            n = int(self.sizes[i])
            if cur and ((len(cur) + 1) * nmax * nmax * itemsize > BLOCK_BYTES
                        or n * 1.25 < nmax):
                out.append(cur)
                cur = []
            if not cur:
                nmax = n
            cur.append(int(i))
        if cur:
            out.append(cur)
        return out

    def _pack(self, ids, dtype, device):
        nmax = int(self.sizes[ids].max())
        C, D = len(ids), self.x.shape[1]
        xb = np.zeros((C, nmax, D))
        yb = np.zeros((C, nmax))
        mask = np.zeros((C, nmax), dtype=bool)
        for c, i in enumerate(ids):
            obs = self.leaves[i]["obs"]
            xb[c, :obs.size] = self.x[obs]
            yb[c, :obs.size] = self.y[obs] - self.leaves[i]["mean"]
            mask[c, :obs.size] = True
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return t(xb).to(dtype), t(yb).to(dtype), t(mask)

    def _noisy_gram(self, xb, mask, hyp, inner_tf32=False):
        logl, logsigma, lognoise = hyp[0], hyp[1], hyp[2]
        if inner_tf32:
            # the program's inner-product form, its product in TF32; a
            # product of two 11-bit significands is exact in float32
            sq = (xb * xb).sum(-1)
            xr = tf32(xb)
            d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(xr, xr.mT)).clamp_min(0.0)
        else:
            d2 = ((xb[:, :, None, :] - xb[:, None, :, :]) ** 2).sum(-1)
        K = torch.exp(2.0 * logsigma) * torch.exp(-0.5 * d2 * torch.exp(-2.0 * logl))
        K = torch.where(mask[:, :, None] & mask[:, None, :], K, 0.0)
        diag = torch.where(mask, torch.exp(2.0 * lognoise) + JITTER, 1.0)
        return K + torch.diag_embed(diag)

    def _block_mll(self, xb, yb, mask, hyp, inner_tf32=False):
        """Each leaf's mll, factor and whitened targets; a leaf whose gram is
        not positive definite has the mll NaN, as in the program."""
        Lf, info = torch.linalg.cholesky_ex(self._noisy_gram(xb, mask, hyp, inner_tf32))
        z = torch.linalg.solve_triangular(Lf, yb[..., None], upper=False)[..., 0]
        logdet = 2.0 * torch.log(torch.diagonal(Lf, dim1=-2, dim2=-1)).sum(-1)
        n = mask.sum(-1).to(xb.dtype)
        mll = -0.5 * ((z * z).sum(-1) + logdet + n * LOG2PI)
        return torch.where(info == 0, mll, torch.nan), Lf, z

    # -- the pass ------------------------------------------------------------
    def leaf_pass(self, hyp, xt, members, dtype, device):
        """Every leaf's mll ``[L]`` and, at its routed test points, its
        moments: lists of arrays (host, float64)."""
        hyp_t = torch.as_tensor(np.asarray(hyp, dtype=np.float64), device=device).to(dtype)
        xt_t = torch.as_tensor(np.asarray(xt, dtype=np.float64), device=device).to(dtype)
        L = len(self.leaves)
        mll = np.zeros(L)
        mus, vars_ = [None] * L, [None] * L
        s2 = torch.exp(2.0 * hyp_t[1])
        noise = torch.exp(2.0 * hyp_t[2])
        with torch.no_grad():
            for ids in self.blocks(torch.finfo(dtype).bits // 8):
                xb, yb, mask = self._pack(ids, dtype, device)
                m, Lf, z = self._block_mll(xb, yb, mask, hyp_t)
                mll[ids] = m.double().cpu().numpy()
                tmax = max(1, max(members[i].size for i in ids))
                idx = np.zeros((len(ids), tmax), dtype=np.int64)
                tmask = np.zeros((len(ids), tmax), dtype=bool)
                for c, i in enumerate(ids):
                    idx[c, :members[i].size] = members[i]
                    tmask[c, :members[i].size] = True
                tmask = torch.as_tensor(tmask, device=device)
                xq = xt_t[torch.as_tensor(idx, device=device)]  # [C, tmax, D]
                d2 = ((xb[:, :, None, :] - xq[:, None, :, :]) ** 2).sum(-1)
                Kt = s2 * torch.exp(-0.5 * d2 * torch.exp(-2.0 * hyp_t[0]))
                Kt = torch.where(mask[:, :, None] & tmask[:, None, :], Kt, 0.0)
                V = torch.linalg.solve_triangular(Lf, Kt, upper=False)
                mu = torch.matmul(V.mT, z[..., None])[..., 0]
                var = s2 - (V * V).sum(-2) + noise
                mu, var = mu.double().cpu().numpy(), var.double().cpu().numpy()
                for c, i in enumerate(ids):
                    k = members[i].size
                    mus[i] = mu[c, :k] + self.leaves[i]["mean"]
                    vars_[i] = var[c, :k]
                del xb, yb, mask, Lf, z, Kt, V
        return mll, mus, vars_

    # -- the SPN -----------------------------------------------------------
    def combine(self, mll, mus, vars_, members, T, dtype=np.float64):
        """``(log evidence, posterior edge weights [E] in the builder's edge
        order, mean [T], var [T])`` from the leaf results, in ``dtype``."""
        mll = np.asarray(mll, dtype=dtype)
        edges = []
        value = {}

        def up(node):
            kind, payload = node
            if kind == "leaf":
                return mll[payload]
            vals = np.array([up(c) for c in payload], dtype=dtype)
            if kind == "split":
                v = vals.sum(dtype=dtype)
            else:
                a = vals - dtype(math.log(len(payload)))
                mx = a.max()
                v = mx + np.log(np.exp(a - mx).sum(dtype=dtype))
            value[id(node)] = (vals, v)
            return v

        z = up(self.root)
        path = np.zeros(len(self.leaves), dtype=dtype)

        def down(node, logw):
            # edge ids in the builder's order: a sum node's edges, then its
            # subtrees, depth first
            kind, payload = node
            if kind == "leaf":
                path[payload] = logw
                return
            if kind == "sum":
                vals, v = value[id(node)]
                w = vals - dtype(math.log(len(payload))) - v
                edges.extend(w.tolist())
                for c, wc in zip(payload, w):
                    down(c, logw + wc)
            else:
                for c in payload:
                    down(c, logw)

        down(self.root, dtype(0.0))
        mean = np.zeros(T, dtype=dtype)
        second = np.zeros(T, dtype=dtype)
        for i, pts in enumerate(members):
            if pts.size:
                w = np.exp(path[i])
                mu = np.asarray(mus[i], dtype=dtype)
                np.add.at(mean, pts, w * mu)
                np.add.at(second, pts, w * (np.asarray(vars_[i], dtype=dtype) + mu * mu))
        return float(z), np.asarray(edges, dtype=np.float64), mean, second - mean * mean

    def predict(self, hyp, xt, dtype, device):
        """The whole pass: ``dict(mll, z, weights, mean, var)``, float64 on
        the host, and each leaf's moments at the points its box holds,
        leaf by leaf (``leaf_points``, ``leaf_mean``, ``leaf_var``);
        computed in ``dtype`` (float32 runs the combine in float32 too)."""
        members = self.members(xt)
        with precision(dtype):
            mll, mus, vars_ = self.leaf_pass(hyp, xt, members, dtype, device)
        npdt = np.float64 if dtype == torch.float64 else np.float32
        z, w, mean, var = self.combine(mll, mus, vars_, members, len(xt), npdt)
        cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0)  # noqa: E731
        return {"mll": mll, "z": z, "weights": np.exp(w),
                "mean": mean.astype(np.float64), "var": var.astype(np.float64),
                "leaf_points": cat(members), "leaf_mean": cat(mus),
                "leaf_var": cat(vars_)}

    # -- training ------------------------------------------------------------
    def value_and_grad(self, hyp, dtype, device, half=False):
        """Root mll under uniform weights and its gradient in the three
        hypers, by autograd, leaf block by leaf block; in float32 (the
        control) the grams' inner products in TF32. ``half`` plants a
        fault: the second half of the leaves is left out and the mean mll
        of the rest put in its place."""
        L = len(self.leaves)
        inner = dtype == torch.float32
        keep = L - L // 2 if half else L
        mll = np.zeros(L)
        blocks = [[i for i in ids if i < keep] for ids in self.blocks(torch.finfo(dtype).bits // 8)]
        blocks = [ids for ids in blocks if ids]
        with precision(dtype):
            h = torch.as_tensor(np.asarray(hyp, dtype=np.float64), device=device).to(dtype)
            with torch.no_grad():
                for ids in blocks:
                    xb, yb, mask = self._pack(ids, dtype, device)
                    mll[ids] = self._block_mll(xb, yb, mask, h, inner)[0].double().cpu().numpy()
            mll[keep:] = mll[:keep].mean()
            npdt = np.float64 if dtype == torch.float64 else np.float32
            z, w, _, _ = self.combine(mll, [np.zeros(0)] * L, None, [], 0, npdt)
            resp = self._responsibilities(w)
            resp[:keep] += resp[keep:].sum() / keep
            grad = torch.zeros(3, dtype=torch.float64, device=device)
            for ids in blocks:
                xb, yb, mask = self._pack(ids, dtype, device)
                hg = h.detach().clone().requires_grad_(True)
                m = self._block_mll(xb, yb, mask, hg, inner)[0]
                r = torch.as_tensor(resp[ids], device=device).to(dtype)
                (g,) = torch.autograd.grad((r * m).sum(), hg)
                grad += g.double()
                del xb, yb, mask, m, hg
        return z, grad.cpu().numpy()

    def _responsibilities(self, edge_logw):
        """Each leaf's share of the root's gradient: the product of the
        posterior weights on its path."""
        out = np.zeros(len(self.leaves))
        it = iter(edge_logw)

        def down(node, logw):
            kind, payload = node
            if kind == "leaf":
                out[payload] = logw
            elif kind == "sum":
                ws = [next(it) for _ in payload]
                for c, wc in zip(payload, ws):
                    down(c, logw + wc)
            else:
                for c in payload:
                    down(c, logw)

        down(self.root, 0.0)
        return np.exp(out)


def adam_ascent(value_and_grad, theta0, steps, lr, betas=(0.9, 0.999), eps=1e-8):
    """``steps`` of Adam ascending ``value_and_grad``: ``(values, grads,
    thetas)``, the value and gradient at each step's start and the
    parameters after each step."""
    theta = np.asarray(theta0, dtype=np.float64).copy()
    m = np.zeros_like(theta)
    v = np.zeros_like(theta)
    values, grads, thetas = [], [], []
    for t in range(1, steps + 1):
        val, g = value_and_grad(theta)
        values.append(val)
        grads.append(g)
        d = -g  # ascent: the optimizer descends the negated objective
        m = betas[0] * m + (1 - betas[0]) * d
        v = betas[1] * v + (1 - betas[1]) * d * d
        mhat = m / (1 - betas[0] ** t)
        vhat = v / (1 - betas[1] ** t)
        theta = theta - lr * mhat / (np.sqrt(vhat) + eps)
        thetas.append(theta.copy())
    return values, grads, thetas
