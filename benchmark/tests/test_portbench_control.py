"""The control (the reference computed one step below the program's
float32 with TF32 off, put in the program's place) comes out not correct
where the program's runs are correct: at each cell's own size on the card,
on three seeds, and for the training cell also at a small size on the CPU,
where the control's grams take their inner products in TF32 by rounding.
The card's cases need a CUDA device; there run
``python -m pytest benchmark/tests -m cuda``."""
from __future__ import annotations

import pytest

from portbench_small import CELLS, small

from benchmark import check, control, harness

SEEDS = (4000000001, 4000000002, 4000000003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_cache_dirs()
    limits = harness.load_limits(cell)
    rows, _ = control.readings(cell, SEEDS, SEEDS, 1.0)
    for r in rows:
        assert check.judge(r["program"], limits)["correct"], r
        assert not check.judge(r["control"], limits)["correct"], r


def test_training_control_is_caught_small():
    cfg, tr = small("d2_n100k_train")
    limits = harness.load_limits("d2_n100k_train")
    rows, _ = control.readings("d2_n100k_train", (11, 12), (11, 12), 0.2, device="cpu",
                               cfg=cfg, traffic=tr)
    for r in rows:
        assert check.judge(r["program"], limits)["correct"], r
        assert not check.judge(r["control"], limits)["correct"], r
