"""``solve_ms.serve``: device milliseconds per served batch of the
triangular-solve kernels (the float64 solves against the cached factors in
``fit.bucketed_hybrid_predict`` → ``cached_leaf_predict``), over the traced
batches. Moves ``served_points_per_s``."""

from benchmark import tracing


def read(run):
    return tracing.per_unit_ms(run, "triangular_solves")
