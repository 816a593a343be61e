"""Distributed blocked Cholesky over a mesh axis (counterpart of
``deepstructuredmixtures_tpu/parallel/dist_chol.py``).

One expert whose ``[N, N]`` covariance exceeds one device: the matrix is
row-sharded over the ranks of a mesh axis, rank ``me`` holding rows
``me * N/ndev ... (me + 1) * N/ndev - 1`` (its *row block*), and factored
by a right-looking blocked Cholesky. Per panel of ``block`` columns:

1. the owner of the diagonal block sends it to every rank, which factors
   it (``torch.linalg``; the JAX package psums a one-hot block, XLA's
   ``cholesky``);
2. every rank solves its rows below the panel against it;
3. an all-gather of the ``[N, block]`` panel;
4. every rank updates its own rows below the panel, columns from the
   panel's end on: the trailing block only, half the work of the JAX
   package's full-width masked product, the same values.

The factor is built in place in a copy of the row block, one ``[N/ndev,
N]`` buffer where the JAX package carries two. Every function takes and
returns row blocks (the counterpart of arrays sharded ``P(axis, None)``);
scalars and test-point results are replicated on every rank. The blocked
forward and backward solves work the same way, one collective per panel.

The ``B x B`` diagonal factor and the solves are ``torch.linalg``
(cuSOLVER/cuBLAS on the card): the JAX package runs XLA's ``cholesky``
and ``triangular_solve`` there, no Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from ..config import EPS
from ..kernels import gram, gram_diag
from ..ops.cholesky import cholesky_nosym
from .comm import EXPERT_AXIS, resolve

LOG2PI = math.log(2.0 * math.pi)


def _check_blocking(N: int, ndev: int, block: int):
    """Validate the (mesh, block) layout shared by every distributed op:
    rows per device and blocks must tile exactly, and each panel must lie
    within one shard. Returns ``(rows, block)``."""
    if N % ndev != 0:
        raise ValueError(f"N={N} not divisible by mesh size {ndev}")
    rows = N // ndev
    if rows % block != 0:
        raise ValueError(
            f"per-device rows {rows} not divisible by block {block}; "
            f"use a block <= {rows} that divides it"
        )
    return rows, block


def _layout(ax, N: int, block: int, local):
    """``rows`` per rank after :func:`_check_blocking`, with ``local`` (a
    row block) checked against it."""
    rows, _ = _check_blocking(N, ax.ndev, block)
    if local.shape[0] != rows:
        raise ValueError(
            f"this rank holds {local.shape[0]} rows of an N={N} matrix on "
            f"{ax.ndev} ranks; its row block has {rows}")
    return rows


def _below(s: int, block: int, base: int, rows: int) -> int:
    """Local index of this rank's first row below the panel at ``s``."""
    return min(max(s + block - base, 0), rows)


def _cholesky(A, ax, block):
    N = A.shape[1]
    rows = _layout(ax, N, block, A)
    base = ax.me * rows
    L = A.clone()  # factored in place
    for s in range(0, N, block):
        owner, lo = divmod(s, rows)
        if ax.me == owner:
            D = L[lo:lo + block, s:s + block].clone()
        else:
            D = L.new_empty((block, block))
        Lbb = cholesky_nosym(ax.broadcast(D, owner))
        if ax.me == owner:
            L[lo:lo + block, s:s + block] = Lbb
        first = _below(s, block, base, rows)
        P = L[first:, s:s + block]  # this rank's rows below the panel
        if P.shape[0]:
            # L21 Lbb' = A21
            P.copy_(torch.linalg.solve_triangular(Lbb.mT, P, upper=True,
                                                  left=False))
        if s + block < N:
            loc = L.new_zeros((rows, block))
            loc[first:] = P
            panel = ax.gather_rows(loc)  # [N, B], zero above the trailing rows
            if P.shape[0]:
                L[first:, s + block:].addmm_(P, panel[s + block:].mT, alpha=-1.0)
    # the strict upper triangle (global column > global row) still holds A
    return torch.tril(L, diagonal=base)


def sharded_cholesky(A, mesh, axis: str = EXPERT_AXIS, block: int = 256):
    """Lower Cholesky factor of SPD ``A [N, N]``, row-sharded over the
    mesh axis: ``A`` is this rank's row block ``[N/ndev, N]`` and so is the
    result. ``N`` must be divisible by ``ndev * block`` (pad with identity
    rows for ragged sizes, as :func:`sharded_gp_fit` does). A matrix that is
    not positive definite gives NaN from the failing panel on, as XLA's
    Cholesky does."""
    return _cholesky(A, resolve(mesh, axis), block)


def _solve_lower(Lf, b, ax, block):
    N = Lf.shape[1]
    rows = _layout(ax, N, block, Lf)
    base = ax.me * rows
    vec = b.ndim == 1
    r = (b[:, None] if vec else b).clone()  # residual, in b's dtype
    x = torch.zeros_like(r)
    T = r.shape[1]
    for s in range(0, N, block):
        owner, lo = divmod(s, rows)
        if ax.me == owner:
            blk = torch.cat([Lf[lo:lo + block, s:s + block].to(r.dtype),
                             r[lo:lo + block]], dim=1)
        else:
            blk = r.new_empty((block, block + T))
        ax.broadcast(blk, owner)
        xblk = torch.linalg.solve_triangular(blk[:, :block], blk[:, block:],
                                             upper=False)
        if ax.me == owner:
            x[lo:lo + block] = xblk
        first = _below(s, block, base, rows)
        if first < rows:
            r[first:].addmm_(Lf[first:, s:s + block].to(r.dtype), xblk,
                             alpha=-1.0)
    return x[:, 0] if vec else x


def sharded_solve_lower(Lf, b, mesh, axis: str = EXPERT_AXIS,
                        block: int = 256):
    """Forward substitution ``L X = B`` with ``Lf`` and ``b`` row blocks,
    ``b`` a vector ``[N/ndev]`` or a matrix ``[N/ndev, T]`` (the predictive
    cross-covariance solve, ≙ ``gp.cK.L \\ Knt``); returns ``X``'s row
    block. Per panel the owner sends its diagonal block and residual rows
    (one broadcast), every rank solves the block and updates its residual
    rows below it. The solve runs in ``b``'s dtype, the factor's blocks
    cast to it."""
    return _solve_lower(Lf, b, resolve(mesh, axis), block)


def _solve_lower_t(Lf, z, ax, block):
    N = Lf.shape[1]
    rows = _layout(ax, N, block, Lf)
    base = ax.me * rows
    vec = z.ndim == 1
    Z = z[:, None] if vec else z
    x = torch.zeros_like(Z)
    T = Z.shape[1]
    for s in reversed(range(0, N, block)):
        owner, lo = divmod(s, rows)
        first = _below(s, block, base, rows)
        # -sum_{j >= s+B} L[j, s:s+B]' x[j] over this rank's rows, plus the
        # owner's diagonal block and right-hand side: one psum per panel
        buf = Z.new_zeros((block, block + T))
        if first < rows:
            buf[:, block:] = -(Lf[first:, s:s + block].to(Z.dtype).mT
                               @ x[first:])
        if ax.me == owner:
            buf[:, :block] = Lf[lo:lo + block, s:s + block]
            buf[:, block:] += Z[lo:lo + block]
        ax.psum(buf)
        xblk = torch.linalg.solve_triangular(buf[:, :block].mT,
                                             buf[:, block:], upper=True)
        if ax.me == owner:
            x[lo:lo + block] = xblk
    return x[:, 0] if vec else x


def sharded_solve_lower_t(Lf, z, mesh, axis: str = EXPERT_AXIS,
                          block: int = 256):
    """Backward substitution ``L' x = z`` on the row-sharded lower ``Lf``,
    blocks last to first, straight on ``Lf`` (no transposed copy); the
    cross-rank sum ``Σ_j L_jk' x_j`` and the owner's diagonal block travel
    in one psum per panel. ``z`` is a row block ``[N/ndev]`` (or ``[N/ndev,
    T]``); returns ``x``'s row block, in ``z``'s dtype."""
    return _solve_lower_t(Lf, z, resolve(mesh, axis), block)


def _row_grid(ax, rows: int, N: int, device):
    gri = ax.me * rows + torch.arange(rows, device=device)[:, None]
    return gri, torch.arange(N, device=device)[None, :]


def _gram_rows(ax, kind, x, logl, logsigma, lognoise, valid_n, eps):
    """This rank's rows of the noisy gram, identity past ``valid_n``
    (exact no-ops downstream, as ``ops.cholesky.pad_identity``)."""
    N = x.shape[0]
    rows = N // ax.ndev
    gri, cj = _row_grid(ax, rows, N, x.device)
    K = gram(kind, logl, logsigma, x[ax.me * rows:(ax.me + 1) * rows], x)
    diag = cj == gri
    Kn = K + (torch.exp(2.0 * lognoise) + eps) * diag
    valid = (gri < valid_n) & (cj < valid_n)
    return torch.where(valid, Kn, diag.to(Kn.dtype))


def _hypers(x, logl, logsigma, lognoise):
    def t(v):
        return torch.as_tensor(v, dtype=x.dtype, device=x.device)

    return torch.atleast_1d(t(logl)), t(logsigma), t(lognoise)


def sharded_gp_fit(x, y, logl, logsigma, lognoise, mesh,
                   axis: str = EXPERT_AXIS, block: int = 256,
                   eps: float = EPS, valid_n=None, kind: str = "iso_se",
                   return_factor: bool = False):
    """Exact-GP fit of ONE giant leaf: each rank builds its rows of the
    gram, :func:`sharded_cholesky` factors them, two distributed solves
    give ``alpha``. Returns ``(alpha, mll)`` or, with ``return_factor``,
    ``(alpha, mll, Lf)``: ``alpha`` and ``Lf`` row blocks, ``mll`` a
    replicated 0-d tensor (≙ ``update_cholesky!`` + ``mll``,
    ``gaussianprocess.jl:87-108,163``, on experts past one device).

    ``x [N, D]`` and ``y [N]`` are whole (replicated) on every rank, ``N`` a
    multiple of ``ndev * block``. ``valid_n``: the true observation count
    when ``x``/``y`` were padded up to that tiling; the padding rows are
    masked to identity and ``y`` to zero there. ``kind``: any kernel kind
    of ``kernels.gram`` (``logl`` a per-dimension vector for ARD kinds)."""
    ax = resolve(mesh, axis)
    N = x.shape[0]
    rows, block = _check_blocking(N, ax.ndev, block)
    valid_n = N if valid_n is None else int(valid_n)
    logl, logsigma, lognoise = _hypers(x, logl, logsigma, lognoise)
    lo = ax.me * rows
    y_rows = torch.where(torch.arange(lo, lo + rows, device=y.device) < valid_n,
                         y[lo:lo + rows], 0.0)
    Lf = _cholesky(_gram_rows(ax, kind, x, logl, logsigma, lognoise, valid_n,
                              eps), ax, block)
    z = _solve_lower(Lf, y_rows, ax, block)
    alpha = _solve_lower_t(Lf, z, ax, block)
    # identity padding adds log(1) = 0 to the log-determinant and 0 to the
    # quadratic term (y is zero there): only the 2π count needs valid_n
    parts = ax.psum(torch.stack([
        torch.dot(y_rows, alpha),
        2.0 * torch.sum(torch.log(torch.diagonal(Lf, offset=lo)))]))
    mll = -0.5 * (parts[0] + parts[1] + valid_n * LOG2PI)
    if return_factor:
        return alpha, mll, Lf
    return alpha, mll


def sharded_gp_predict(Lf, x, y, logl, logsigma, lognoise, xt, mesh,
                       axis: str = EXPERT_AXIS, block: int = 256,
                       mean: float = 0.0, valid_n=None,
                       kind: str = "iso_se"):
    """Posterior prediction of the giant sharded leaf: ``(mu [T], var
    [T])``, replicated, with observation noise on the variance (≙
    ``prediction``, ``gaussianprocess.jl:110-137``). Each rank builds its
    rows of the cross-covariance ``K_nt`` (zero past ``valid_n``); one
    distributed forward solve on ``[y | K_nt]`` gives ``z`` and ``V``, the
    mean ``m + V'z`` and the variance ``k_tt - ||V||² + noise``.

    ``y`` is the whole (padded, centred) target vector, where the JAX
    package takes ``alpha`` and writes the mean ``m + K_nt'α``: equal in
    exact arithmetic. The solve runs in float64 against the factor and the
    moments come back in ``x``'s dtype, as in ``gp._predict`` and
    ``fit.cached_leaf_predict``: a float32 ``α`` puts the mean of a large
    ill-conditioned expert past the port's float32 bound (``PERF.md``)."""
    ax = resolve(mesh, axis)
    N = x.shape[0]
    rows, block = _check_blocking(N, ax.ndev, block)
    valid_n = N if valid_n is None else int(valid_n)
    logl, logsigma, lognoise = _hypers(x, logl, logsigma, lognoise)
    lo = ax.me * rows
    keep = (torch.arange(lo, lo + rows, device=x.device) < valid_n)[:, None]
    Knt = torch.where(keep, gram(kind, logl, logsigma, x[lo:lo + rows], xt),
                      0.0)
    rhs = torch.cat([torch.where(keep, y[lo:lo + rows, None], 0.0), Knt], 1)
    Z = _solve_lower(Lf, rhs.double(), ax, block)
    V = Z[:, 1:]
    parts = ax.psum(torch.stack([V.mT @ Z[:, 0], torch.sum(V * V, dim=0)]))
    mu = mean + parts[0]
    var = (gram_diag(kind, logl, logsigma, xt).double() - parts[1]
           + torch.exp(2.0 * lognoise).double())
    return mu.to(x.dtype), var.to(x.dtype)
