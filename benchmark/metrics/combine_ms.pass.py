"""``combine_ms.pass``: milliseconds per pass of the SPN combine, the
posterior weight update (``infer.update_weights``) and the routed moment
match (``models._routed_moment_match``); the benchmark's span, synchronized
with the device at both ends in the traced run. Moves ``pass_s``."""


def read(run):
    spans = run.rec.spans.get("combine")
    return 1e3 * sum(spans) / len(spans) if spans else None
