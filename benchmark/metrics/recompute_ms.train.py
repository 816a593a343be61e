"""``recompute_ms.train``: device milliseconds per traced iteration of the
program's ``train.recompute`` spans (per leaf chunk, its mlls again with
a graph), over its ``train.value`` spans. Moves ``train_step_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "train.recompute", "train.value")
