"""``moments_ms.pass``: device milliseconds per pass of the program's
``moments`` spans (``fit._moments``: the mean, ``k_tt``, the variance and
their casts; ``fit.streamed_leaf_predict``: the leaf mll), over its
``streamed_predict`` spans in the traced passes. Moves ``pass_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "moments", "streamed_predict")
