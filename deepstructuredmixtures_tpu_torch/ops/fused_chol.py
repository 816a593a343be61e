"""Fused IsoSE gram + Cholesky per leaf expert: the CUDA kernel
``csrc/fused_gram_cholesky.cu`` and its plain PyTorch version.

Counterpart of ``deepstructuredmixtures_tpu/ops/pallas_chol.py``
(``fused_gram_cholesky``, the Pallas TPU kernel). Same signature, same
output contract: ``[L, N, N]`` float32 lower factors, identity on the
padded diagonal, zeros on padded rows and columns, strict upper triangle
exactly 0. The kernel's design note is at the top of the CUDA source.

The kernel is built and loaded by ``ops/build.py`` (``nvcc`` on first use,
a plain C shared library under ``build/kernels/``, ``ctypes``). On a CPU
tensor :func:`fused_gram_cholesky` runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import EPS
from ..kernels import gram
from . import build
from .cholesky import masked_gram_noise

BLOCK = 128
MAX_N = 1024

#: kernel launches so far (one per call of the CUDA path)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]


def supported(nmax: int, dtype, kinds, device) -> bool:
    """Whether the fused kernel applies — by domain only: a CUDA device,
    float32, a single IsoSE kernel, ``nmax`` a multiple of 128 and at most
    1024 (the JAX gate, ``ops/pallas_chol.py:283-308``)."""
    return (
        torch.device(device).type == "cuda"
        and dtype == torch.float32
        and tuple(kinds) == ("iso_se",)
        and nmax % BLOCK == 0
        and nmax <= MAX_N
    )


def fused_gram_cholesky_reference(x, n, logl, logsigma, noise, eps: float = EPS):
    """Plain PyTorch version: the port's IsoSE ``gram`` +
    ``masked_gram_noise`` + ``torch.linalg.cholesky`` + ``tril``, in the
    dtype of ``x``."""
    N = x.shape[1]
    K = gram("iso_se", logl[:, None], logsigma, x, x)
    mask = torch.arange(N, device=x.device)[None, :] < n[:, None]
    Kn = masked_gram_noise(K, mask, noise, eps)
    return torch.tril(torch.linalg.cholesky(Kn))


def fused_gram_cholesky(x, n, logl, logsigma, noise, eps: float = EPS):
    """Batched fused IsoSE gram + Cholesky.

    ``x [L, N, D]`` float32 (N a multiple of 128, at most 1024), ``n [L]``
    int32 valid sizes, ``logl/logsigma/noise [L]`` float32 per-leaf
    scalars. Returns the lower factors ``[L, N, N]`` (identity on
    padding). A CPU tensor takes the plain version."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_gram_cholesky_reference(x, n, logl, logsigma, noise, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gram_cholesky: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be [L, N, D], got shape {tuple(x.shape)}")
    L, N, D = x.shape
    if N % BLOCK != 0 or N > MAX_N:
        raise ValueError(
            f"N={N} must be a multiple of {BLOCK} and at most {MAX_N}")
    args = {"x": x, "logl": logl, "logsigma": logsigma, "noise": noise}
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    args["n"] = n
    if n.dtype != torch.int32:
        raise TypeError(f"n must be int32, got {n.dtype}")
    for name, t in args.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "x" and tuple(t.shape) != (L,):
            raise ValueError(f"{name} must have shape ({L},), got {tuple(t.shape)}")
    out = torch.empty((L, N, N), dtype=torch.float32, device=x.device)
    if L == 0:
        return out
    fn = build.load("fused_gram_cholesky", "dsm_fused_gram_cholesky", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), n.data_ptr(), logl.data_ptr(), logsigma.data_ptr(),
            noise.data_ptr(), out.data_ptr(), L, N, D, eps, stream)
    if err != 0:
        raise RuntimeError(f"fused_gram_cholesky: CUDA error {err} at launch")
    LAUNCHES += 1
    return out
