"""Evaluation metrics (≙ ``src/scorefunctions.jl``; a NumPy copy of
``deepstructuredmixtures_tpu/metrics.py``)."""
from __future__ import annotations

import numpy as np

LOG2PI = float(np.log(2.0 * np.pi))


def _se(y_true, y_pred):
    return (np.asarray(y_true) - np.asarray(y_pred)) ** 2


def mse(y_true, y_pred) -> float:
    """Mean squared error (``scorefunctions.jl:7``)."""
    return float(np.mean(_se(y_true, y_pred)))


def sse(y_true, y_pred) -> float:
    """Standard error of the squared error (``scorefunctions.jl:8``)."""
    e = _se(y_true, y_pred)
    return float(np.std(e, ddof=1) / np.sqrt(e.shape[0]))


def _ae(y_true, y_pred):
    return np.abs(np.asarray(y_true) - np.asarray(y_pred))


def mae(y_true, y_pred) -> float:
    """Mean absolute error (``scorefunctions.jl:12``)."""
    return float(np.mean(_ae(y_true, y_pred)))


def sae(y_true, y_pred) -> float:
    """Standard error of the absolute error (``scorefunctions.jl:13``)."""
    e = _ae(y_true, y_pred)
    return float(np.std(e, ddof=1) / np.sqrt(e.shape[0]))


def nlpd(y_true, mu, var) -> float:
    """Mean negative log predictive density under ``Normal(mu, var)``
    (``scorefunctions.jl:16``)."""
    y_true = np.asarray(y_true)
    mu = np.asarray(mu)
    var = np.asarray(var)
    ll = -0.5 * (LOG2PI + np.log(var) + (y_true - mu) ** 2 / var)
    return float(-np.mean(ll))
