"""In-place batched blocked Cholesky: the CUDA kernel
``csrc/blocked_cholesky.cu`` and its plain PyTorch version.

Counterpart of ``deepstructuredmixtures_tpu/ops/pallas_potrf.py``
(``hbm_blocked_cholesky``, the Pallas TPU kernel). It factors the buckets
whose factors the hybrid store keeps (``fit.streamed_leaf_factors``): every
bucket above the fused kernel's domain, on CUDA in float32. Its output
contract is stricter than the TPU kernel's: the strict upper triangle is
exactly 0 (the TPU kernel's ``tril=True``), identity-padded rows and
columns stay the identity, and a matrix that is not positive definite
comes back non-finite without raising (as ``ops.cholesky.cholesky_nosym``
does). Any ``G >= 1`` and any ``n``: ragged edges are masked, so the bucket
widths of ``plan.bucketize`` (multiples of 8 above 1024) need no extra
padding. The kernel blocks on two levels (256-wide outer panels for the big
trailing update, 64-wide inner steps whose rows below the diagonal block
are a product with the block's inverse) and overlaps its serial chain with
the update on a side stream that it joins before returning; its design
note is at the top of the CUDA source.

The kernel is built and loaded by ``ops/build.py``. On a CPU tensor
:func:`blocked_cholesky` runs :func:`blocked_cholesky_reference`; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_chol import MAX_N

#: two-level blocking of the kernel and of its plain version: outer panels
#: of ``NBO`` columns (the rank of the big trailing update), inner steps of
#: ``NB`` columns (the diagonal block that is factored and inverted)
NB = 64
NBO = 256

#: kernel launches so far (one per call of the CUDA path)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def supported(nmax: int, dtype, device) -> bool:
    """Whether the hybrid fit factors a bucket with this kernel: a CUDA
    device, float32, and ``nmax`` above the fused kernel's domain
    (``fused_chol.MAX_N``)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and nmax > MAX_N)


def blocked_cholesky_reference(a):
    """Plain PyTorch version with the kernel's two-level blocking. Per
    ``NBO``-wide outer panel, ``NB``-wide inner steps that touch only their
    own columns (left-looking inside the panel): the step's columns take
    the update from the panel's earlier steps (the kernel brings the later
    diagonal blocks up to date step by step, the same sum in another
    order), the diagonal block goes to
    ``torch.linalg.cholesky_ex`` (a failed block becomes NaN, so a matrix
    that is not positive definite comes back non-finite), and the rows
    below it become a product with ``inv(L11)`` as in the kernel, not a
    substitution. After the panel, one rank-``NBO`` ``baddbmm`` on the
    trailing matrix; then ``tril``. Reads the lower triangle of the
    diagonal blocks only. Returns a new tensor in the dtype of ``a``."""
    n = a.shape[-1]
    out = a.clone()
    eye = torch.eye(NB, dtype=a.dtype, device=a.device)
    for S in range(0, n, NBO):
        pe = min(S + NBO, n)
        for s in range(S, pe, NB):
            e = min(s + NB, n)
            if s > S:
                out[:, s:, s:e].baddbmm_(out[:, s:, S:s], out[:, s:e, S:s].mT,
                                         alpha=-1.0)
            L11, info = torch.linalg.cholesky_ex(out[:, s:e, s:e])
            L11 = torch.where((info == 0)[:, None, None], L11, torch.nan)
            out[:, s:e, s:e] = L11
            if e < n:
                inv = torch.linalg.solve_triangular(
                    L11, eye[: e - s, : e - s].expand_as(L11), upper=False)
                out[:, e:, s:e] = out[:, e:, s:e] @ inv.mT
        if pe < n:
            L21 = out[:, pe:, S:pe]
            out[:, pe:, pe:].baddbmm_(L21, L21.mT, alpha=-1.0)
    return torch.tril(out)


def blocked_cholesky(a):
    """Lower Cholesky factors of the SPD matrices ``a [G, n, n]``, written
    over ``a``; returns ``a``. Only the lower triangle of ``a`` is read.

    In place so that the hybrid fit factors the gram buffer it allocated
    instead of a second one (up to 1 GiB per leaf at n = 16232); the only
    scratch is 32 KiB per matrix for the inverses of two diagonal blocks.
    The call is one unit of work on the current stream. On CUDA
    ``a`` must be a contiguous float32 tensor; a CPU tensor of any float
    dtype takes the plain version."""
    global LAUNCHES
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be [G, n, n], got shape {tuple(a.shape)}")
    if a.device.type == "cpu":
        return a.copy_(blocked_cholesky_reference(a))
    if a.device.type != "cuda":
        raise ValueError(f"blocked_cholesky: unsupported device {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    G, n, _ = a.shape
    if G > 65535:
        raise ValueError(f"G={G} exceeds the launch grid's 65535")
    if G == 0 or n == 0:
        return a
    fn = build.load("blocked_cholesky", "dsm_blocked_cholesky", _ARGTYPES)
    # scratch of the kernel: inv(L11) of the current diagonal block and of
    # the next one
    work = torch.empty((G, 2, NB, NB), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), work.data_ptr(), G, n, stream)
    if err != 0:
        raise RuntimeError(f"blocked_cholesky: CUDA error {err} at launch")
    LAUNCHES += 1
    return a
