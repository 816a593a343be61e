"""``blocked_chol_roofline.pass`` (%): the blocked Cholesky kernel
(``ops/potrf.py`` → ``csrc/blocked_cholesky.cu``) in the traced passes,
its least time over its time on the card.

Operations and bytes, per leaf of a bucket in the kernel's domain (the
streamed path factors every bucket above nmax 1024 with it, once per leaf
and pass) at the leaf's valid size n: n³/3 operations (one Cholesky) and
8n² bytes (the float32 n × n gram read once and its factor written once,
in place). The least time is the larger
of the two bounds at the published peaks (``peaks.py``). The time on the
card is the union of the intervals of its four CUDA kernels: it runs its
serial chain and its trailing update on two streams, so their sum would
count the overlap twice. Nothing is read if the kernel did not run.
Moves ``pass_s``."""

from benchmark import peaks, tracing

DOMAIN_MIN_NMAX = 1025


def counts(buckets, factorizations=1.0):
    n = [float(v) for b in buckets if b["nmax"] >= DOMAIN_MIN_NMAX for v in b["n"]]
    flops = factorizations * sum(v ** 3 / 3.0 for v in n)
    nbytes = factorizations * sum(8.0 * v * v for v in n)
    return flops, nbytes


def read(run):
    busy = tracing.group_union_s(run, "blocked_cholesky")
    if not busy or not run.rec.counters.get("blocked_launches"):
        return None
    flops, nbytes = counts(run.work["buckets"], run.trace["units"])
    if not flops:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes) / busy
