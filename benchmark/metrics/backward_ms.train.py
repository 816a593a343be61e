"""``backward_ms.train``: device milliseconds per traced iteration of the
program's ``train.backward`` spans (per leaf chunk, its ``.backward``:
the closed-form float64 backward ``train._KeptLeafMll.backward`` and the
gram's), over its ``train.value`` spans. Moves ``train_step_s``."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, "train.backward", "train.value")
