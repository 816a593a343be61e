"""Masked batched dense linear algebra for padded leaf-GP batches
(counterpart of ``deepstructuredmixtures_tpu/ops/cholesky.py``).

These were XLA ops in the JAX package (no Pallas kernel), so here they are
``torch.linalg`` calls (cuSOLVER / cuBLAS on the card). Padding contract:
padded rows and columns of a covariance become identity, so factor,
solves and log-determinant treat them as exact no-ops.

The factor-reuse toolkit of the shared-Cholesky fit (≙
``src/AdvancedCholeskey.jl``) works on a group axis ``G`` where the JAX
package ``vmap``s one matrix:

* :func:`givens_delete_rows` removes interior rows from lower factors by
  Givens rank-1 update sweeps, the mathematically correct update that the
  reference's ``lowrankupdate!`` intends (the JAX module docstring lists
  the reference's two defects). The sweeps are a Python loop over
  columns, all deletions of all groups at once as a wavefront; it starts
  at the smallest deleted row, since the rows above it are untouched;
* :func:`chol_continue` resumes a factorization from row ``P`` (trsm +
  syrk + potrf of the trailing block, ``AdvancedCholeskey.jl:152-174``)
  with static shapes and a per-group ``P`` by masking;
* :func:`factor_is_valid` is the PSD guard of the fallbacks.
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
    A matrix that is not positive definite comes back non-finite instead
    of raising, as from XLA's Cholesky (all NaN there): ``cholesky_ex``
    alone returns a finite partial factor and reports the failure only in
    ``info``, so the diagonal of a failed factor is set to NaN by ``info``
    on the device, with no host sync. Its log-determinant, solves, mll
    and ``factor_is_valid`` all see the NaN. Masking the diagonal alone
    touches ``n`` elements per matrix instead of ``n²``: a ``where`` over
    every factor made the streamed N=100k headline 1.4% slower on an H100
    (``chip_nosym_ab.py`` of commit bc8fd97)."""
    L, info = torch.linalg.cholesky_ex(K)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    d.copy_(torch.where((info > 0)[..., None], torch.nan, d))
    return L


def masked_cholesky(K, mask):
    """Lower Cholesky of an identity-padded covariance batch."""
    return cholesky_nosym(pad_identity(K, mask))


def cho_solve_lower(L, y):
    """Solve ``(L L^T) x = y`` given lower ``L``, ``y [..., N]``: the alpha
    weights (Rasmussen & Williams Alg. 2.1; reference
    ``gaussianprocess.jl:105``)."""
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def solve_lower(L, B):
    """Triangular solve ``L^{-1} B`` (≙ ``gp.cK.L \\ Knt``,
    ``gaussianprocess.jl:120``)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def masked_logdet(L, mask):
    """``logdet(L L^T) = 2 sum log diag(L)`` over valid rows only."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ld = torch.where(mask, torch.log(torch.where(mask, d, 1.0)), 0.0)
    return 2.0 * torch.sum(ld, dim=-1)


def givens_delete_rows(Lf, del_idx, n_del):
    """Delete rows from lower factors, group by group.

    ``Lf [G, N, N]`` lower factors; ``del_idx [G, Dmax]`` (int) ascending
    row positions per group, padded with anything; ``n_del [G]`` the
    valid count of each row. Returns new factors whose sub-factor on the
    kept indices (rows and columns ``del_idx`` logically dropped, left in
    place for the caller to gather) is the Cholesky factor of the original
    matrix without them (≙ the reference's per-row update loop,
    ``fit.jl:179-187``, with the corrected update).

    Deleting row ``r`` is the Givens rank-1 *update* ``L33' L33'^T = L33
    L33^T + v v^T`` with ``v = Lf[r+1:, r]``: a sweep over the columns
    ``i > r`` that rotates column ``i`` against ``v``. The JAX package runs
    pass ``k`` (the ``k``-th deletion of every group) after pass ``k - 1``.
    Here the passes run as a wavefront: at step ``t`` pass ``k`` works on
    column ``t - k``, which pass ``k - 1`` finished at step ``t - 1``, so
    every element sees the same operations in the same order as in the
    JAX package, while the Python loop takes ``N + Dmax`` steps instead of
    about ``N · Dmax``; a step is about 25 launches on ``[G, Dmax, N]``,
    and the loop is launch-bound. A column and ``v`` rotate as one complex
    vector: ``(col + i v) * conj(w)`` with ``w = (a + i b) / |a + i b|`` is
    ``(c col + s v) + i (c v - s col)`` for the rotation ``(c, s)`` that
    zeroes ``b = v[i]`` against ``a = Lf[i, i]``, and its row ``i`` is the
    new diagonal ``|a + i b|``. Padded identity rows stay invariant."""
    Lf = Lf.clone()
    G, n, _ = Lf.shape
    dev = Lf.device
    n_del = n_del.to(device=dev, dtype=torch.long)
    K = int(n_del.max()) if G else 0
    if K == 0:
        return Lf
    ks = torch.arange(K, device=dev)
    # r[g, k]: the k-th deleted row of group g; past the last row where the
    # group has fewer deletions
    r = torch.where(ks[None, :] < n_del[:, None],
                    del_idx[:, :K].to(device=dev, dtype=torch.long), n)
    ar = torch.arange(n, device=dev)
    one = torch.ones((), dtype=Lf.dtype, device=dev)
    v = torch.zeros((G, K, n), dtype=Lf.dtype, device=dev)
    # pass k reads its v from column r at step r + k and rotates column i > r
    # at step i + k
    for t in range(int((r + ks).min()), n + K - 1):
        k0, k1 = max(0, t - n + 1), min(K, t + 1)
        i = t - ks[k0:k1]  # the column of each pass in this step
        rk = r[:, k0:k1]
        cols = Lf[:, :, i].transpose(1, 2)  # [G, kk, N]
        vk = torch.where((rk == i)[..., None] & (ar > i[:, None]), cols,
                         v[:, k0:k1])
        z = torch.complex(cols, vk)
        z0 = z.gather(2, i[None, :, None].expand(G, -1, 1))[..., 0]
        rho = z0.abs()
        act = rk < i
        z = z * torch.where(act & (rho > 0), z0 / rho, one).conj()[..., None]
        upd = act[..., None] & (ar >= i[:, None])
        Lf[:, :, i] = torch.where(upd, z.real, cols).transpose(1, 2)
        v[:, k0:k1] = torch.where(upd, z.imag, vk)
    return Lf


def chol_continue(A, Ltop, P):
    """Resume lower Cholesky factorizations from row ``P``, group by group.

    ``A [G, N, N]`` full symmetric covariances (identity-padded); ``Ltop
    [G, N, N]`` whose leading ``P x P`` block is the known lower factor of
    ``A[:P, :P]``; ``P [G]`` the number of already-factored rows. Returns
    the full lower factors with ``L21 = A21 L11^{-T}`` and ``L22 =
    chol(A22 - L21 L21^T)`` (≙ trsm + syrk + potrf,
    ``AdvancedCholeskey.jl:158-171``), in static shapes by masking.

    ``S = A - U^T U`` cancels ``O(|A|)`` down to the Schur complement, so
    it runs in full float32 on the card: the package turns TF32 off (the
    JAX package asks for ``Precision.HIGHEST`` here for the same
    reason)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    in_p = torch.arange(n, device=A.device)[None, :] < P.to(A.device)[:, None]
    both_p = in_p[:, :, None] & in_p[:, None, :]
    neither_p = ~in_p[:, :, None] & ~in_p[:, None, :]
    # Lt = [[L11, 0], [0, I]]; T = Lt^{-1} A, whose rows < P are
    # L11^{-1} [A11 A12]
    Lt = torch.tril(torch.where(both_p, Ltop, eye))
    T = torch.linalg.solve_triangular(Lt, A, upper=False)
    U = torch.where(in_p[:, :, None], T, 0.0)
    S = A - U.mT @ U
    L22 = cholesky_nosym(torch.where(neither_p, S, eye))
    cross = in_p[:, :, None] & ~in_p[:, None, :]
    L21 = torch.where(cross, T, 0.0).mT
    return (torch.where(both_p, torch.tril(Ltop), 0.0) + L21
            + torch.where(neither_p, L22, 0.0))


def factor_is_valid(L, mask):
    """PSD guard: finite, non-negative diagonal on the valid rows, per
    matrix (≙ the reference's ``all(diag(...) .>= 0)`` and LAPACK ``info ==
    0`` fallbacks, ``fit.jl:197-201,280-290``)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = torch.isfinite(d) & (d >= 0)
    return torch.all(torch.where(mask, ok, True), dim=-1)
