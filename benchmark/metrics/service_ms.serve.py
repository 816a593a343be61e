"""``service_ms.serve``: the mean host milliseconds of the program's
``serve.batch`` spans (``serve.MicroBatcher._serve``: a batch's predict,
which ends in the copy of its moments to the host, so it holds the
device's work) in the traced stretch. Moves ``served_points_per_s``."""

from benchmark import spans


def read(run):
    return spans.host_mean(run, "serve.batch")
