"""``request_p95_ms.serve``: the 95th percentile latency, from the client's
call to its reply on the host clock, of the requests of the window. The
closed loop holds the server at capacity, where the tail swings with how
the clients' requests fall into batches, so it is a per-layer metric
beside ``served_points_per_s``."""

import numpy as np


def read(run):
    lat = run.rec.spans.get("request_ms")
    return float(np.percentile(lat, 95)) if lat else None
