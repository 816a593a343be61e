"""Fused IsoSE gram + Cholesky per leaf expert: the CUDA kernel
``csrc/fused_gram_cholesky.cu`` and its plain PyTorch version.

Counterpart of ``deepstructuredmixtures_tpu/ops/pallas_chol.py``
(``fused_gram_cholesky``, the Pallas TPU kernel). Same signature, same
output contract: ``[L, N, N]`` float32 lower factors, identity on the
padded diagonal, zeros on padded rows and columns, strict upper triangle
exactly 0. The kernel's design note is at the top of the CUDA source.

The kernel is compiled with ``nvcc`` on first use into ``build/kernels/``
(git-ignored) under a name carrying the source's hash, so an edited source
rebuilds; it is a plain C shared library loaded with ``ctypes``. On a CPU
tensor :func:`fused_gram_cholesky` runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..config import EPS
from ..kernels import gram
from .cholesky import masked_gram_noise

BLOCK = 128
MAX_N = 1024

#: kernel launches so far (one per call of the CUDA path)
LAUNCHES = 0

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_gram_cholesky.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None


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


def library_path() -> Path:
    """The shared library for the current source, compiled if missing.
    The compiler's report (registers, shared memory, spills) is kept next
    to it as ``.log``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libfused_gram_cholesky_{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {_SRC} (exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(library_path()))
        lib.dsm_fused_gram_cholesky.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.dsm_fused_gram_cholesky.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dsm_fused_gram_cholesky(
            x.data_ptr(), n.data_ptr(), logl.data_ptr(), logsigma.data_ptr(),
            noise.data_ptr(), out.data_ptr(), L, N, D, eps, stream)
    if err != 0:
        raise RuntimeError(f"fused_gram_cholesky: CUDA error {err} at launch")
    LAUNCHES += 1
    return out
