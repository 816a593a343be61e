"""``batch_points.serve``: test points per batch of the serving front
(``serve.MicroBatcher``): its counters ``batched_points`` over ``batches``
for the window. Moves ``served_points_per_s``."""


def read(run):
    c = run.rec.counters
    return c["batched_points"] / c["batches"] if c.get("batches") else None
