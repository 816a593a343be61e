"""Carry weights and state from a JAX model to a port model.

The port builds the same tree, plan and buckets as the JAX package for the
same data, seed and config, so a model's state is its flat hyper vector
``theta`` and its sum-edge ``logweights``, passed as NumPy arrays
(``np.asarray(jax_model.theta)``, ``np.asarray(jax_model.logweights)``).
This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


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
