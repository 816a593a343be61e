"""``queue_wait_ms.serve``: the median host milliseconds of the program's
``serve.queue`` spans (``serve.MicroBatcher``: from a request's put to the
worker taking it into a batch) for the requests put in the traced
stretch. Moves ``served_points_per_s``."""

from benchmark import spans


def read(run):
    return spans.host_median(run, "serve.queue")
