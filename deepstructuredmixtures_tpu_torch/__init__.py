"""deepstructuredmixtures_tpu_torch — the PyTorch / CUDA port of
``deepstructuredmixtures_tpu`` (Deep Structured Mixtures of Gaussian
Processes), beside the JAX package it is held to.

This package imports ``torch``, NumPy and scipy (for the sparse leaf
overlap), never JAX. It covers fitting and serving: ``build_dsmgp`` /
``build_poe`` / ``build_bcm`` (host tree, plan, size buckets, the
leaf-overlap matrix and the shared-Cholesky schedule, on an explicit
device) → ``fit`` (the full store, which keeps every leaf's factor at the
global nmax and is the default when that fits in 2 GiB; the light store
with its alpha cache; or the hybrid store that keeps the largest buckets'
factors; ``method='shared'`` derives factors from overlapping leaves by
copies, Givens row deletion and continued Cholesky) → ``update`` /
``infer`` (posterior sum weights) → ``predict`` (routed mixture
prediction, or the PoE fusions), plus ``checkpoint`` (the JAX package's
npz format) and ``serve`` (``Predictor``, ``MicroBatcher``, HTTP). The two
factorization kernels, fused gram+Cholesky and blocked Cholesky, are
hand-written CUDA (``csrc/``), built with ``nvcc`` on first use.

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
from .models import (  # noqa: E402
    DSMGP,
    GPoE,
    PoE,
    RBCM,
    build_bcm,
    build_dsmgp,
    build_poe,
)

__all__ = [
    "EPS",
    "IsoSE",
    "ArdSE",
    "IsoLinear",
    "ArdLinear",
    "ConstMean",
    "DSMGP",
    "PoE",
    "GPoE",
    "RBCM",
    "build_dsmgp",
    "build_poe",
    "build_bcm",
]

__version__ = "0.1.0"
