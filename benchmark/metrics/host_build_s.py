"""``host_build_s``: seconds of the host build, the benchmark's host-clock
span around the program's ``build_dsmgp`` (the tree, the plan, the size
buckets and the leaf batches put on the device). Moves ``setup_s``."""


def read(run):
    spans = run.rec.spans.get("build")
    return spans[0] if spans else None
