"""Masked batched dense linear algebra for padded leaf-GP batches — the
fit/predict half of ``deepstructuredmixtures_tpu/ops/cholesky.py``.

These were XLA ops in the JAX package (no Pallas kernel), so here they are
``torch.linalg`` calls (cuSOLVER / cuBLAS on the card). Padding contract:
padded rows and columns of a covariance become identity, so factor,
solves and log-determinant treat them as exact no-ops.
"""
from __future__ import annotations

import torch


def _eye_like(K):
    n = K.shape[-1]
    return torch.eye(n, dtype=K.dtype, device=K.device)


def pad_identity(K, mask):
    """Replace padded rows/cols of ``K [..., N, N]`` by identity;
    ``mask [..., N]`` is the boolean valid-row mask."""
    m2 = mask[..., :, None] & mask[..., None, :]
    return torch.where(m2, K, _eye_like(K))


def masked_gram_noise(K, mask, noise, eps):
    """Add ``noise + eps`` to the valid diagonal and identity-pad
    (≙ ``update_cholesky!``'s noise add, ``gaussianprocess.jl:94-98``).
    ``noise`` is a tensor broadcasting over the batch axes."""
    Kn = K + (noise[..., None, None] + eps) * _eye_like(K)
    return pad_identity(Kn, mask)


def cholesky_nosym(K):
    """Lower Cholesky factor, read from the lower triangle only (no
    symmetrization pass: our covariances are symmetric by construction).
    ``cholesky_ex`` does not synchronize with the card to check the
    factorization; like XLA's, a failed factor comes back non-finite
    instead of raising."""
    return torch.linalg.cholesky_ex(K)[0]


def solve_lower(L, B):
    """Triangular solve ``L^{-1} B`` (≙ ``gp.cK.L \\ Knt``,
    ``gaussianprocess.jl:120``)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def masked_logdet(L, mask):
    """``logdet(L L^T) = 2 sum log diag(L)`` over valid rows only."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ld = torch.where(mask, torch.log(torch.where(mask, d, 1.0)), 0.0)
    return 2.0 * torch.sum(ld, dim=-1)
