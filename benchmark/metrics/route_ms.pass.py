"""``route_ms.pass``: milliseconds per pass of the host routing of the test
points (``model._route``: the leaf boxes, ``native.route_box`` and
``pack_routes``) and their copy to the device; the benchmark's host-clock
span, averaged over every pass of the traced run. Moves ``pass_s``."""


def read(run):
    spans = run.rec.spans.get("route")
    return 1e3 * sum(spans) / len(spans) if spans else None
