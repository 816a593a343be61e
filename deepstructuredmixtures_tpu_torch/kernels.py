"""Covariance (kernel) functions on tensors (counterpart of
``deepstructuredmixtures_tpu/kernels.py``).

All kernels are parameterised in log scale with the reference's
semantics (``src/kernels.jl``): ``IsoSE(x, x') = exp(2 logsigma) *
exp(-0.5 ||x - x'||^2 exp(-2 logl))``; the ARD kernels are additive over
dimensions; linear kernels carry no variance parameter, though the
parameter layout keeps its slot.

Every function takes optional leading batch axes: ``logl [..., nl]``,
``logsigma [...]``, ``x1 [..., N, D]``, ``x2 [..., M, D]``. The JAX
package writes the unbatched form and ``vmap``s it over leaves; here the
leaf axis is a broadcast batch axis. Gradients come from autograd; the
additive ARD-SE gram has a hand-written backward (:class:`_ArdSEGram`).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

KIND_ISO_SE = "iso_se"
KIND_ARD_SE = "ard_se"
KIND_ISO_LINEAR = "iso_linear"
KIND_ARD_LINEAR = "ard_linear"

_ALL_KINDS = (KIND_ISO_SE, KIND_ARD_SE, KIND_ISO_LINEAR, KIND_ARD_LINEAR)


class KernelSpec(NamedTuple):
    """Static kernel description + initial log-hyperparameters.

    ``n_lengthscales`` is 1 for Iso kernels and D for ARD kernels; the
    packed per-kernel layout is ``[logl..., logsigma, lognoise]``.
    """

    kind: str
    logl: tuple  # initial log lengthscales (length 1 or D)
    logsigma: float  # initial log std (ignored by linear kernels)

    @property
    def n_lengthscales(self) -> int:
        return len(self.logl)

    @property
    def n_params(self) -> int:
        # [logl..., logsigma, lognoise] — variance slot always present
        return self.n_lengthscales + 2

    @property
    def has_variance(self) -> bool:
        return self.kind in (KIND_ISO_SE, KIND_ARD_SE)


def IsoSE(logl: float, logsigma: float) -> KernelSpec:
    """Isotropic squared-exponential kernel (reference ``kernels.jl:59-66``)."""
    return KernelSpec(KIND_ISO_SE, (float(logl),), float(logsigma))


def ArdSE(logl: Sequence[float], logsigma: float) -> KernelSpec:
    """ARD (additive-over-dims) SE kernel (reference ``kernels.jl:109-116``)."""
    return KernelSpec(KIND_ARD_SE, tuple(float(v) for v in logl), float(logsigma))


def IsoLinear(logl: float) -> KernelSpec:
    """Isotropic linear kernel (reference ``kernels.jl:174-179``)."""
    return KernelSpec(KIND_ISO_LINEAR, (float(logl),), 0.0)


def ArdLinear(logl: Sequence[float]) -> KernelSpec:
    """ARD linear kernel (reference ``kernels.jl:209-214``)."""
    return KernelSpec(KIND_ARD_LINEAR, tuple(float(v) for v in logl), 0.0)


def _sqdist(x1, x2):
    """Pairwise squared distances ``[..., N, M]`` by the inner-product
    expansion, clamped at 0 (the JAX package's form, so both packages
    round alike). Full-precision float32 matmuls on the card: the package
    turns TF32 off, because nearby points cancel ``n1 + n2`` against
    ``2<x1, x2>`` almost completely."""
    n1 = torch.sum(x1 * x1, dim=-1)
    n2 = torch.sum(x2 * x2, dim=-1)
    cross = torch.matmul(x1, x2.transpose(-1, -2))
    d = n1[..., :, None] + n2[..., None, :] - 2.0 * cross
    return torch.clamp_min(d, 0.0)


class _ArdSEGram(torch.autograd.Function):
    """Additive ARD-SE gram ``exp(2 logsigma) Σ_k T_k``, ``T_k = exp(-0.5
    (x1_k - x2_k')² exp(-2 logl_k))`` (≙ the reference's per-dim kappa
    accumulation, ``kernels.jl:39-49``), with a memory-lean backward (the
    JAX package's ``_ard_se_gram`` ``custom_vjp``).

    Plain autograd of the per-dimension loop would save every dimension's
    ``[..., N, M]`` exp output per leaf; that residual memory crashed the
    TPU during fine-tuning at n ≈ 16k, D = 4 (the JAX docstring). The
    forward saves only its inputs and ``K``; the backward recomputes each
    dimension's term, so its peak is a few ``[..., N, M]`` temporaries.
    Each gradient comes back in its own input's shape (inputs broadcast
    over the leading axes); when ``x1`` and ``x2`` are one tensor,
    autograd adds the two."""

    @staticmethod
    def forward(ctx, logl, logsigma, x1, x2):
        inv_l2 = torch.exp(-2.0 * logl)
        acc = None
        for k in range(x1.shape[-1]):
            diff = x1[..., :, k, None] - x2[..., None, :, k]
            term = torch.exp(-0.5 * (diff * diff) * inv_l2[..., k, None, None])
            acc = term if acc is None else acc + term
        K = torch.exp(2.0 * logsigma)[..., None, None] * acc
        ctx.save_for_backward(logl, logsigma, x1, x2, K)
        return K

    @staticmethod
    def backward(ctx, dK):
        logl, logsigma, x1, x2, K = ctx.saved_tensors
        need_l, need_s, need_x1, need_x2 = ctx.needs_input_grad
        s2 = torch.exp(2.0 * logsigma)[..., None, None]
        inv_l2 = torch.exp(-2.0 * logl)
        dlogsigma = 2.0 * torch.sum(dK * K, dim=(-2, -1)) if need_s else None
        dlogl, dx1, dx2 = [], [], []
        for k in range(x1.shape[-1]):
            diff = x1[..., :, k, None] - x2[..., None, :, k]  # [..., N, M]
            il = inv_l2[..., k, None, None]
            G = dK * (s2 * torch.exp(-0.5 * (diff * diff) * il))  # dK ⊙ s2·T_k
            # ∂K/∂logl_k = s2·T_k·diff²·il (through il = e^{-2 logl})
            if need_l:
                dlogl.append(torch.sum(G * (diff * diff) * il, dim=(-2, -1)))
            # ∂K/∂x1_ik = -s2·T_k·il·diff; ∂K/∂x2_jk = +s2·T_k·il·diff
            if need_x1 or need_x2:
                GD = G * diff
                dx1.append(-il[..., 0] * torch.sum(GD, dim=-1))
                dx2.append(il[..., 0] * torch.sum(GD, dim=-2))

        def fit(g, like):
            return g.sum_to_size(like.shape).to(like.dtype)

        return (fit(torch.stack(dlogl, dim=-1), logl) if need_l else None,
                fit(dlogsigma, logsigma) if need_s else None,
                fit(torch.stack(dx1, dim=-1), x1) if need_x1 else None,
                fit(torch.stack(dx2, dim=-1), x2) if need_x2 else None)


def gram(kind: str, logl, logsigma, x1, x2):
    """Kernel Gram matrix ``k(x1, x2)`` of shape ``[..., N, M]``."""
    if kind == KIND_ISO_SE:
        r2 = _sqdist(x1, x2)
        inv_l2 = torch.exp(-2.0 * logl[..., 0])[..., None, None]
        amp = torch.exp(2.0 * logsigma)[..., None, None]
        return amp * torch.exp(-0.5 * r2 * inv_l2)
    if kind == KIND_ARD_SE:
        # additive per-dim terms, one dimension at a time: the [N, M, D]
        # difference tensor would be GiBs per leaf at benchmark sizes
        return _ArdSEGram.apply(logl, logsigma, x1, x2)
    if kind == KIND_ISO_LINEAR:
        # kappa(z) = z / exp(2 logl), z = <x, x'> (kernels.jl:189,194)
        cross = torch.matmul(x1, x2.transpose(-1, -2))
        return cross * torch.exp(-2.0 * logl[..., 0])[..., None, None]
    if kind == KIND_ARD_LINEAR:
        # sum_d x_d x'_d / exp(2 logl_d) (kernels.jl:232,234-246)
        scaled = x1 * torch.exp(-2.0 * logl)[..., None, :]
        return torch.matmul(scaled, x2.transpose(-1, -2))
    raise ValueError(f"unknown kernel kind {kind!r}; expected one of {_ALL_KINDS}")


def gram_diag(kind: str, logl, logsigma, x):
    """Diagonal ``k(x_i, x_i)`` of shape ``[..., N]`` without forming the
    full matrix."""
    if kind == KIND_ISO_SE:
        return torch.exp(2.0 * logsigma)[..., None].expand(x.shape[:-1])
    if kind == KIND_ARD_SE:
        d = logl.shape[-1]
        return (torch.exp(2.0 * logsigma) * d)[..., None].expand(x.shape[:-1])
    if kind == KIND_ISO_LINEAR:
        return torch.sum(x * x, dim=-1) * torch.exp(-2.0 * logl[..., 0])[..., None]
    if kind == KIND_ARD_LINEAR:
        return torch.sum(x * x * torch.exp(-2.0 * logl)[..., None, :], dim=-1)
    raise ValueError(f"unknown kernel kind {kind!r}")


def init_params(spec: KernelSpec, dtype=None, *, device) -> dict:
    """Initial parameters ``{'logl': [nl], 'logsigma': scalar}`` on
    ``device`` (float64 unless ``dtype`` is given, as in the JAX
    package)."""
    dtype = dtype or torch.float64
    return {
        "logl": torch.tensor(spec.logl, dtype=dtype, device=device),
        "logsigma": torch.tensor(spec.logsigma, dtype=dtype, device=device),
    }


def normalize_kernels(kernels) -> tuple:
    """A tuple of KernelSpec (the reference allows a single kernel or a
    vector of kernels for leaf-level kernel mixtures)."""
    if isinstance(kernels, KernelSpec):
        return (kernels,)
    ks = tuple(kernels)
    for k in ks:
        if not isinstance(k, KernelSpec):
            raise TypeError(f"expected KernelSpec, got {k!r}")
    return ks
