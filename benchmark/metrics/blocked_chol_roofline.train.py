"""``blocked_chol_roofline.train`` (%): the blocked Cholesky kernel in the
traced training iterations (the objective's kept route,
``train._KeptLeafMll``), its least time over its time on the card.

Per factorization of a leaf the operations and bytes of
``blocked_chol_roofline.pass`` (n³/3; 8n²). How many factorizations an
iteration makes of each leaf is counted, not assumed: the kernel's
launches in the traced iterations over its launches in one light fit of
the same model (``fit.bucketed_leaf_mlls``, which factors every leaf once,
chunk by chunk as the objective does). The time on the card is the union
of its four CUDA kernels' intervals. Moves ``train_step_s``."""

from benchmark import harness, peaks, tracing

_pass = harness.load_reader("blocked_chol_roofline.pass")


def read(run):
    busy = tracing.group_union_s(run, "blocked_cholesky")
    c = run.rec.counters
    if not busy or not c.get("blocked_launches") or not c.get("blocked_launches_per_fit"):
        return None
    per_leaf = c["blocked_launches"] / c["blocked_launches_per_fit"]
    flops, nbytes = _pass.counts(run.work["buckets"], per_leaf)
    if not flops:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes) / busy
