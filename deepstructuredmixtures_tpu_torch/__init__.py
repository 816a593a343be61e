"""deepstructuredmixtures_tpu_torch — the PyTorch / CUDA port of
``deepstructuredmixtures_tpu`` (Deep Structured Mixtures of Gaussian
Processes), beside the JAX package it is held to.

This package imports ``torch`` and NumPy, never JAX. It covers the
serving path: ``build_dsmgp`` (host tree, plan and size buckets on an
explicit device) → ``fit`` (streamed leaf likelihoods) → ``update``
(posterior sum weights) → ``predict`` (routed mixture prediction). The
fused gram+Cholesky kernel is hand-written CUDA (``csrc/``), built with
``nvcc`` on first use.

Importing the package turns TF32 off for float32 matmuls and
convolutions: grams and Cholesky updates need full float32 (nearby points
cancel in the squared distances, and the trailing updates cancel
O(|K|) down to O(noise)).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import EPS  # noqa: E402
from .kernels import ArdLinear, ArdSE, IsoLinear, IsoSE  # noqa: E402
from .means import ConstMean  # noqa: E402
from .models import build_dsmgp  # noqa: E402

__all__ = [
    "EPS",
    "IsoSE",
    "ArdSE",
    "IsoLinear",
    "ArdLinear",
    "ConstMean",
    "build_dsmgp",
]

__version__ = "0.1.0"
