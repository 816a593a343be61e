"""Flat hyperparameter vector packing (counterpart of
``deepstructuredmixtures_tpu/hyper.py``).

One hyper vector, tied across all leaves, with the layout
``[lengthscales..., log std, log noise]`` per kernel in log scale
(reference ``gaussianprocess.jl:147-161``), concatenated over the kernel
mixture in kernel order (``optimize.jl:185-198``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .kernels import KernelSpec


class HyperLayout(NamedTuple):
    """Static description of the flat hyper vector for a kernel mixture.

    ``blocks[k] = (offset, n_lengthscales)`` for kernelid ``k``; each block
    is ``[logl..., logsigma, lognoise]``, ``n_lengthscales + 2`` wide.
    """

    kinds: Tuple[str, ...]
    blocks: Tuple[Tuple[int, int], ...]
    total: int

    def slice_of(self, kernelid: int) -> Tuple[int, int]:
        """``(start, stop)`` of kernelid's block in the flat vector."""
        off, nl = self.blocks[kernelid]
        return off, off + nl + 2


def make_layout(kernels: Sequence[KernelSpec]) -> HyperLayout:
    kinds = tuple(k.kind for k in kernels)
    blocks = []
    off = 0
    for k in kernels:
        blocks.append((off, k.n_lengthscales))
        off += k.n_params
    return HyperLayout(kinds, tuple(blocks), off)


def initial_vector(kernels: Sequence[KernelSpec], log_noise: float) -> np.ndarray:
    """Flat initial hyper vector from the kernel specs + observation noise."""
    parts = []
    for k in kernels:
        parts.append(np.asarray(k.logl, dtype=np.float64))
        parts.append(np.asarray([k.logsigma], dtype=np.float64))
        parts.append(np.asarray([log_noise], dtype=np.float64))
    return np.concatenate(parts)


def unpack(layout: HyperLayout, theta, kernelid: int):
    """``(logl [nl], logsigma, lognoise)`` of one kernel block, from a flat
    ``theta [P]`` or a per-leaf ``theta [L, P]`` (leading axes pass
    through)."""
    off, nl = layout.blocks[kernelid]
    logl = theta[..., off : off + nl]
    logsigma = theta[..., off + nl]
    lognoise = theta[..., off + nl + 1]
    return logl, logsigma, lognoise


def noise_from(lognoise):
    """Observation noise variance ``exp(2*logNoise)``
    (reference ``gaussianprocess.jl:39``)."""
    return torch.exp(2.0 * lognoise)
