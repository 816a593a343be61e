"""Synthetic datasets (≙ ``src/datasets.jl``; a NumPy copy of
``deepstructuredmixtures_tpu/datasets.py``, same RNG trajectory)."""
from __future__ import annotations

import numpy as np


def _normpdf(m, s, x):
    return np.exp(-0.5 * ((x - m) / s) ** 2) / (s * np.sqrt(2.0 * np.pi))


def nonstationary(n: int, sigma2: float = 0.4, seed=None):
    """1-D piecewise-sine signal with input-dependent heteroscedastic noise
    — the paper's toy benchmark (≙ ``nonstationary``, ``datasets.jl:5-27``).

    Returns ``(x [n, 1], y [n], noise [n])``.
    """
    rng = np.random.default_rng(seed)
    x = np.linspace(-200.0, 200.0, n)

    i1 = int(np.ceil(0.25 * n))
    i2 = int(np.ceil(0.75 * n))
    f1 = np.concatenate(
        [
            3.0 * np.sin(-3.0 + 0.2 * x[:i1]),
            0.0 * np.sin(0.1 * x[i1:i2]),
            3.0 * np.sin(2.8 + 0.2 * x[i2:]),
        ]
    )
    f2 = 100.0 * _normpdf(110.0, 20.0, x) + 100.0 * _normpdf(-10.0, 20.0, x)

    x = x - x.mean()
    x = x / x.std(ddof=1)
    f1 = f1 - f1.mean()
    f1 = f1 / f1.std(ddof=1)

    noise = np.sqrt(sigma2 * np.exp(f2))
    y = f1 + noise * rng.standard_normal(x.shape)
    x = x * 10.0
    return x.reshape(-1, 1), y, noise
