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
prediction, ``refine_steps=k`` for float64 true-K refinement of the float32
solves, or the PoE fusions), plus the standalone exact
``GaussianProcess``, training (``train``: tied hypers by mll ascent;
``train_gp``; ``finetune``: per-leaf hypers, with a sparse pair-list
backward), each with a ``torch.optim`` optimizer factory, ``checkpoint``
(the JAX package's npz format), ``serve`` (``Predictor``,
``MicroBatcher``, HTTP) and the host-side utilities (``introspect``,
``metrics``, ``datasets``, ``plotting``, ``utils.profiling``), and the
multi-device path on ``torch.distributed`` (``parallel``: ``fit(mesh=)``
with the distributed Cholesky of giant leaves, sharded training and
fine-tuning). The two factorization kernels, fused
gram+Cholesky and blocked Cholesky, are hand-written CUDA (``csrc/``),
built with ``nvcc`` on first use; training differentiates through
``torch.linalg`` and refits through the kernels.

Importing the package turns TF32 off for float32 matmuls and
convolutions: grams and Cholesky updates need full float32 (nearby points
cancel in the squared distances, and the trailing updates cancel
O(|K|) down to O(noise)).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import EPS, DSMGPConfig  # noqa: E402
from .kernels import ArdLinear, ArdSE, IsoLinear, IsoSE, KernelSpec  # noqa: E402
from .means import ConstMean  # noqa: E402
from .metrics import mae, mse, nlpd, sae, sse  # noqa: E402
from .datasets import nonstationary  # noqa: E402
from .models import (  # noqa: E402
    DSMGP,
    GPoE,
    GaussianProcess,
    PoE,
    RBCM,
    build_bcm,
    build_dsmgp,
    build_poe,
)
from .introspect import (  # noqa: E402
    blockindecies,
    blockmatrix,
    get_log_noise,
    left_gp,
    observation_counts,
    rand_init,
    right_gp,
)
from .plotting import kernelid_function  # noqa: E402
from .train import finetune, train, train_gp  # noqa: E402
from . import checkpoint  # noqa: E402


def prediction(model, xt):
    """Alias for ``model.predict`` (reference README API:
    ``m, s = prediction(model, testx)``)."""
    return model.predict(xt)


__all__ = [
    "DSMGPConfig",
    "EPS",
    "IsoSE",
    "ArdSE",
    "IsoLinear",
    "ArdLinear",
    "KernelSpec",
    "ConstMean",
    "mse",
    "sse",
    "mae",
    "sae",
    "nlpd",
    "nonstationary",
    "DSMGP",
    "PoE",
    "GPoE",
    "RBCM",
    "GaussianProcess",
    "build_dsmgp",
    "build_poe",
    "build_bcm",
    "prediction",
    "blockmatrix",
    "blockindecies",
    "observation_counts",
    "get_log_noise",
    "left_gp",
    "right_gp",
    "rand_init",
    "kernelid_function",
    "train",
    "train_gp",
    "finetune",
    "checkpoint",
]

__version__ = "0.1.0"
