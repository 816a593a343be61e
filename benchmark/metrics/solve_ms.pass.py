"""``solve_ms.pass``: device milliseconds per pass of the program's ``solve``
spans (``fit._forward_solve``: the float64 cast and the forward solve of
``[y | K_nt]``), over its ``streamed_predict`` spans in the traced
passes. Moves ``pass_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "solve", "streamed_predict")
