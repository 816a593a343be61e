"""Mixed-precision iterative refinement of the leaf-GP solve (counterpart
of ``deepstructuredmixtures_tpu/ops/refine.py``; opt-in through
``refine_steps``).

The float32 path's accuracy floor is the float32 rounding of the stored
covariance amplified through its inverse, so refining against the stored
matrix cannot help. Each step here recomputes the residual
``r = [y | K_nt] - K B`` against the TRUE kernel matrix instead, with a
float64 gram built on the fly in row blocks (O(n²) float64 work per step;
the O(n³) factorization stays float32), then applies the float32 factor
as the preconditioner: ``B += L^{-T} L^{-1} r``. The error contracts by
about ``cond(K) * eps_f32`` per step.

After refinement the predictive mean and variance leave the float32
floor; the mll keeps the float32 factor's log-determinant, its remaining
floor. Moments and mll come back in float64 and stay so through the SPN
combine, whose ``E[μ²] − mean²`` cancellation would re-floor float32
inputs.

The JAX package checks a global x64 flag first; torch has float64
without one.
"""
from __future__ import annotations

import torch

from ..config import EPS
from ..leafgp import (
    LOG2PI,
    centered_y,
    leaf_gram,
    leaf_gram_diag,
    leaf_noise,
)
from . import cholesky as chol

#: bytes of one float64 row block ``[C, rows, Nmax]`` of the residual's
#: gram together with the two temporaries of its size that the gram makes;
#: a leaf chunk whose block of ``row_chunk`` rows would exceed it takes
#: fewer rows per block (the leaf chunk, which the factor's launches
#: follow, is never cut)
ROW_BLOCK_BYTES = 2 << 30


def _batch64(batch):
    """The float64 view of a (possibly float32) LeafBatch."""
    return batch._replace(x=batch.x.double(), y=batch.y.double(),
                          mean=batch.mean.double())


def _row_chunk(C: int, nmax: int, row_chunk: int) -> int:
    """Rows per float64 gram block: ``row_chunk``, or fewer where the block
    and its temporaries would exceed :data:`ROW_BLOCK_BYTES`."""
    fit = ROW_BLOCK_BYTES // (3 * 8 * C * nmax)
    return max(1, min(row_chunk, nmax, fit))


def _true_matmul64(layout, theta64, b64, noise64, B64, row_chunk: int):
    """``(K + (noise+eps) I) @ B`` against the true (float64, recomputed)
    kernel matrix for the multi-rhs ``B64 [C, Nmax, T]``, in row blocks
    (:func:`_row_chunk`), so the float64 gram never exceeds ``[C, rows,
    Nmax]``. Padded rows are not masked here: callers mask the residual.
    Padded columns need no mask: ``B``'s padded rows are zero by the
    padding contract (identity factor rows, zeroed rhs)."""
    C, nmax, _ = B64.shape
    rc = _row_chunk(C, nmax, row_chunk)
    KB = torch.empty_like(B64)
    for s in range(0, nmax, rc):
        rows = b64._replace(x=b64.x[:, s:s + rc])  # leaf_gram reads x, kernelid
        Kb = leaf_gram(layout, theta64, rows, x2=b64.x)  # [C, rc, Nmax] f64
        KB[:, s:s + rc] = torch.matmul(Kb, B64)
        del Kb
    return KB + (noise64 + EPS)[:, None, None] * B64


def refined_mll(batch, Lf, alpha64):
    """The mll with the refined quad term ``y'α`` (float64) and the float32
    factor's log-determinant (the remaining floor)."""
    yc64 = centered_y(_batch64(batch))
    quad = torch.sum(yc64 * alpha64, dim=-1)
    logdet = chol.masked_logdet(Lf, batch.mask).double()
    nn = batch.n.double()
    return -0.5 * (quad + logdet + nn * LOG2PI)


def refine_joint(layout, theta, batch, Lf, z, V, xt_leaf, steps: int,
                 row_chunk: int = 2048):
    """Joint refinement of the alpha solve and the test-column solves in one
    true-K residual pass per step: the columns of ``[y_c | K_nt]`` refine
    independently, so stacking them pays the float64 gram once per step.

    Inputs are the streamed chunk's intermediates in the factor's dtype:
    ``z = L⁻¹y_c [C, Nmax]``, ``V = L⁻¹K_nt [C, Nmax, T]``; ``xt_leaf`` is
    shared ``[T, D]`` or per-leaf ``[C, T, D]``. Returns ``(mu, var, mll)
    [C, T] / [C]`` in float64 (≙ the reference's exact prediction and
    mll, ``gaussianprocess.jl:87-137``)."""
    b64 = _batch64(batch)
    theta64 = theta.double()
    noise64 = leaf_noise(layout, theta64, b64)
    xt64 = xt_leaf.double()
    mask3 = batch.mask[:, :, None]
    Knt64 = torch.where(mask3, leaf_gram(layout, theta64, b64, xt64), 0.0)
    rhs64 = torch.cat([centered_y(b64)[..., None], Knt64], dim=-1)

    # B0 = L⁻ᵀ [z | V]: one transposed solve seeds alpha and the test
    # columns together
    B = torch.linalg.solve_triangular(
        Lf.mT, torch.cat([z[..., None], V], dim=-1), upper=True).double()
    for _ in range(steps):
        R = rhs64 - _true_matmul64(layout, theta64, b64, noise64, B, row_chunk)
        R = torch.where(mask3, R, 0.0)
        d = torch.linalg.solve_triangular(
            Lf.mT, chol.solve_lower(Lf, R.to(Lf.dtype)), upper=True)
        B = B + d.double()
        del R, d
    alpha64 = B[..., 0]
    mll = refined_mll(batch, Lf, alpha64)
    mu = b64.mean[:, None] + torch.einsum("cnt,cn->ct", Knt64, alpha64)
    q = torch.einsum("cnt,cnt->ct", Knt64, B[..., 1:])
    var = leaf_gram_diag(layout, theta64, b64, xt64) - q + noise64[:, None]
    return mu, var, mll
