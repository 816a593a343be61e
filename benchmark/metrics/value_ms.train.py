"""``value_ms.train``: device milliseconds per traced iteration of the
program's ``train.value`` span (``train.make_value_and_grad_bucketed``:
every bucket's leaf mlls without a graph, and the root mll). Moves
``train_step_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "train.value", "train.value")
