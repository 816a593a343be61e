"""Carry weights and state from a JAX model to a port model.

The port builds the same tree, plan and buckets as the JAX package for the
same data, seed and config, so a model's state is its flat hyper vector
``theta`` and its sum-edge ``logweights``, passed as NumPy arrays
(``np.asarray(jax_model.theta)``, ``np.asarray(jax_model.logweights)``).
A standalone GP's state is its kernel, ``theta``, inputs, centered
targets and mean (:func:`gp_from_jax_arrays`). This module imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .gp import GaussianProcess
from .kernels import KernelSpec
from .means import ConstMean


def from_jax_arrays(model, theta, logweights=None):
    """Load ``theta`` (and optionally ``logweights``) into ``model``, a port
    model built from the same data, seed and config; returns ``model``.
    Loading ``theta`` drops the fit, as ``set_params`` does."""
    theta = np.asarray(theta)
    if theta.shape[-1] != model.layout.total:
        raise ValueError(
            f"theta has {theta.shape[-1]} hypers per row, the model's layout "
            f"{model.layout.total}")
    model.set_params(theta)
    if logweights is not None:
        lw = np.array(logweights, dtype=np.float64)
        if lw.shape != (max(model.plan.n_sum_edges, 1),):
            raise ValueError(
                f"logweights has shape {lw.shape}, the plan "
                f"{(max(model.plan.n_sum_edges, 1),)}")
        model.logweights = torch.as_tensor(lw, device=model.device)
    return model


def gp_from_jax_arrays(kernel, theta, x, yc, mean, *, device, dtype=None):
    """The port's :class:`GaussianProcess` with a JAX GP's state: its
    ``kernel`` (a KernelSpec of either package: kind, logl, logsigma),
    ``theta``, ``x``, centered targets ``yc`` and constant ``mean``
    (``np.asarray(jgp.theta)``, ``np.asarray(jgp.x)``,
    ``np.asarray(jgp.yc)``, ``jgp.mean_value``), on ``device``."""
    spec = KernelSpec(kernel.kind, tuple(float(v) for v in kernel.logl),
                      float(kernel.logsigma))
    theta = np.asarray(theta, dtype=np.float64)
    if theta.shape != (spec.n_params,):
        raise ValueError(f"theta has shape {theta.shape}, the kernel "
                         f"{(spec.n_params,)}")
    yc = np.asarray(yc, dtype=np.float64)
    gp = GaussianProcess(x, yc + mean, mean=ConstMean(float(mean)),
                         kernel=spec, device=device, dtype=dtype)
    gp.yc = torch.tensor(yc, dtype=gp.x.dtype, device=gp.device)
    gp.set_params(theta)
    return gp
