"""``gram_ms.pass``: device milliseconds per pass of the program's ``gram``
spans (``fit._factor``: the noisy gram; ``fit._forward_solve``: the
cross-gram, its masking and the right-hand side), over its
``streamed_predict`` spans in the traced passes. Moves ``pass_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "gram", "streamed_predict")
