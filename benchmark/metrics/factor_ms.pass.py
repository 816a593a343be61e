"""``factor_ms.pass``: device milliseconds per pass of the program's
``factor`` spans (``fit._factor``: the blocked kernel above nmax 1024,
whose side stream joins the caller's before it returns; the fused kernel
or ``cholesky_nosym`` elsewhere), over its ``streamed_predict`` spans in
the traced passes. Moves ``pass_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "factor", "streamed_predict")
