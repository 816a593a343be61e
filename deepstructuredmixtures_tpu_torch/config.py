"""Global configuration of the PyTorch DSMGP port.

Counterpart of ``deepstructuredmixtures_tpu/config.py``: the global jitter
``EPS``, the immutable ``DSMGPConfig`` flag struct and ``as_2d``. The one
difference is the default dtype, which follows the device instead of a
global x64 switch: float64 on the CPU (the reference's LAPACK numerics,
used by the parity tests) and float32 on a CUDA device (the fast path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

# Global jitter added to the noisy diagonal of every training covariance
# (reference: DeepStructuredMixtures.jl:27 and gaussianprocess.jl:94).
EPS = 1e-8


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on a CUDA device."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.float64
    if kind == "cuda":
        return torch.float32
    raise ValueError(f"unsupported device {device!r}; expected cpu or cuda")


@dataclasses.dataclass(frozen=True)
class DSMGPConfig:
    """Structure-builder configuration (field-for-field the JAX package's
    ``DSMGPConfig``): ``V`` is always the number of children per sum node
    and ``K`` the number of splits per split node."""

    mean_fun: Optional[object]  # ConstMean or None (per-leaf mean of y)
    kernels: Union[object, Sequence[object]]  # KernelSpec or list thereof
    observation_noise: float  # log noise (reference: logNoise)
    min_data: int  # minimum observations per expert (M)
    K: int  # splits per split node
    V: int  # children per sum node
    depth: int  # maximum depth in sum layers
    bnoise: float  # split-position noise epsilon
    sum_root: bool  # use a sum node as root


def as_2d(x) -> np.ndarray:
    """Coerce inputs to an (N, D) float64 array (reference assumes matrices)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D input array, got shape {x.shape}")
    return x
