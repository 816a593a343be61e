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
tensor it launches the kernel or raises. How many blocks work on one leaf
is chosen here, by :func:`launch_plan`, from the batch's shape and the
card's SM count.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..config import EPS
from ..kernels import gram
from . import build
from .cholesky import cholesky_nosym, masked_gram_noise

BLOCK = 128
MAX_N = 1024
#: the kernel's tile edge: the width of a panel and of a diagonal block
TILE = 64
#: most blocks of one leaf (a cluster above the portable 8, which the
#: kernel's info call allows)
MAX_CLUSTER = 16
#: the kernel's static shared memory: the diagonal tile, its inverse and
#: scratch (``DiagSmem`` of ``csrc/chol_common.cuh``), which the two
#: operand tiles of a product overlay; ``chip_smoke.py`` checks it against
#: what the compiled kernel reports
SMEM_BYTES = 4 * (2 * TILE * (TILE + 1) + 32 * 33 + TILE)
#: the shared memory one block may use on an H100
SMEM_LIMIT = 232_448

#: kernel launches so far (one per call of the CUDA path)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_INFO_ARGTYPES = [ctypes.POINTER(ctypes.c_int)] * 2
#: per device index: (SMs, resident blocks of the kernel per SM, its
#: static shared memory in bytes)
_DEVICE_INFO: Dict[int, Tuple[int, int, int]] = {}


@dataclass(frozen=True)
class LaunchPlan:
    """How one call of the kernel covers its ``leaves`` of ``n`` rows:
    ``blocks_per_leaf`` blocks (a thread-block cluster when above 1) on each
    leaf, ``grid`` blocks in all, each with ``smem_bytes`` of shared
    memory."""

    leaves: int
    n: int
    blocks_per_leaf: int
    grid: int
    smem_bytes: int

    def block_leaf(self, block: int) -> Tuple[int, int]:
        """``(leaf, rank)`` of block ``block``: the leaf it works on and its
        rank in that leaf's cluster, as the kernel reads them."""
        return divmod(block, self.blocks_per_leaf)


def launch_plan(L: int, N: int, sms: int) -> LaunchPlan:
    """The kernel's launch for ``L`` leaves of ``N`` rows on a card of
    ``sms`` SMs, as measured on an H100 (``chip_fused_ab.py --sweep``):
    one block per leaf from ``2 * sms`` leaves on (two such blocks share an
    SM, so one leaf's serial diagonal chain runs beside another leaf's
    products); two from ``sms / 2`` leaves (fewer blocks would leave SMs
    with one leaf and nothing to hide its chain behind); below that, the
    largest cluster of 2-16 blocks that still gives every block an SM of
    its own and no more blocks than the first step has update tiles."""
    tiles = N // TILE
    useful = min(MAX_CLUSTER, max(1, tiles * (tiles - 1) // 2))
    if L >= 2 * sms:
        c = 1
    elif 2 * L >= sms:
        c = min(2, useful)
    else:
        c = 1
        while 2 * c <= useful and L * 2 * c <= sms:
            c *= 2
    return LaunchPlan(leaves=L, n=N, blocks_per_leaf=c, grid=L * c,
                      smem_bytes=SMEM_BYTES)


def device_info(device) -> Tuple[int, int, int]:
    """``(SMs, resident blocks of the kernel per SM, its static shared
    memory)`` of a CUDA device, asked once per device, before the first
    launch there (builds the kernel; allows its clusters of 16)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _DEVICE_INFO:
        fn = build.load("fused_gram_cholesky", "dsm_fused_gram_cholesky_info",
                        _INFO_ARGTYPES)
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.byref(blocks), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"fused_gram_cholesky: CUDA error {err} in its info")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _DEVICE_INFO[index] = (sms, blocks.value, smem.value)
    return _DEVICE_INFO[index]


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
    ``masked_gram_noise`` + ``cholesky_nosym`` + ``tril``, in the dtype of
    ``x``. As with the kernel, a leaf whose gram is not positive definite
    comes back non-finite without raising."""
    N = x.shape[1]
    K = gram("iso_se", logl[:, None], logsigma, x, x)
    mask = torch.arange(N, device=x.device)[None, :] < n[:, None]
    Kn = masked_gram_noise(K, mask, noise, eps)
    return torch.tril(cholesky_nosym(Kn))


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
    plan = launch_plan(L, N, device_info(x.device)[0])
    fn = build.load("fused_gram_cholesky", "dsm_fused_gram_cholesky", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), n.data_ptr(), logl.data_ptr(), logsigma.data_ptr(),
            noise.data_ptr(), out.data_ptr(), L, N, D, eps,
            plan.blocks_per_leaf, stream)
    if err != 0:
        raise RuntimeError(f"fused_gram_cholesky: CUDA error {err} at launch")
    LAUNCHES += 1
    return out
