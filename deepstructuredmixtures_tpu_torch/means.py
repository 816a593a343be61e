"""Mean functions (counterpart of ``deepstructuredmixtures_tpu/means.py``).

Only ``ConstMean`` exists in the reference (``src/means.jl``). ``None``
means "per-leaf ConstMean(mean(y))", the reference builder default
(``src/treeStructure.jl:271,292``).
"""
from __future__ import annotations

from typing import NamedTuple


class ConstMean(NamedTuple):
    """Constant mean function (reference: ``src/means.jl:7-9``)."""

    m: float


def resolve_mean(mean_fun, y) -> float:
    """The constant mean for a leaf's targets: ``None`` gives the per-leaf
    empirical mean, otherwise the configured constant."""
    if mean_fun is None:
        return float(y.mean())
    if isinstance(mean_fun, ConstMean):
        return float(mean_fun.m)
    raise TypeError(f"unsupported mean function: {mean_fun!r}")
