"""``elementwise_ms.pass``: device milliseconds per pass of the kernels that
are no factor, solve or product (the gram, masking, casts and copies of
the streamed fit and predict: ``fit.bucketed_streamed_predict``,
``leafgp``, ``kernels.gram``), summed over the traced passes. Moves
``pass_s``."""

from benchmark import tracing


def read(run):
    return tracing.per_unit_ms(run, "other")
