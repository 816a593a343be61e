"""``chol_useful_share.pass`` (%): the Cholesky work a pass needs over the
work it does. Needed: n³/3 for each leaf at its valid size n
(``run.work``), each leaf factored once a pass. Done: the
``padded_flops`` of the program's ``factor`` spans (leaves × nmax³/3 of
each chunk, from its host shape) per ``streamed_predict`` span of the
traced passes. The rest is the size buckets' padding. Moves ``pass_s``."""

from benchmark import spans


def read(run):
    done = spans.per_unit(run, "factor", "streamed_predict",
                          lambda r: r["attrs"]["padded_flops"])
    if not done:
        return None
    return 100.0 * sum(float(n) ** 3 / 3.0 for n in run.work["leaf_n"]) / done
