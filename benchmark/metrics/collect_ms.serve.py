"""``collect_ms.serve``: the mean host milliseconds of the program's
``serve.collect`` spans (``serve.MicroBatcher._collect``: from a batch's
first request taken to the batch closed) in the traced stretch. Moves
``served_points_per_s``."""

from benchmark import spans


def read(run):
    return spans.host_mean(run, "serve.collect")
