"""``request_p50_ms.serve``: the median latency, from the client's call to
its reply on the host clock, of the requests of the window. Moves
``served_points_per_s``."""

import statistics


def read(run):
    lat = run.rec.spans.get("request_ms")
    return statistics.median(lat) if lat else None
