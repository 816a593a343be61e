"""The configuration's kernel list and data recipe give the existing
configuration exactly what the harness's fixed formulas gave it: the same
data, test points and starting hypers bit for bit, at two seeds, and the
same model as the port's builder given ``IsoSE(0, 0)`` directly."""
from __future__ import annotations

import numpy as np
import pytest

from portbench_small import small

from benchmark import harness

SEEDS = (20240601, 4294967311123)


def _old_data(cfg, seed):
    """The harness's formula before configurations named their recipe."""
    rng = np.random.default_rng(harness.seed_key(seed))
    x = np.sort(rng.uniform(0.0, 1.0, cfg["n_train"])).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, cfg["noise_std"], cfg["n_train"])
    return x, y


@pytest.mark.parametrize("full", [False, True], ids=["small", "cell_size"])
@pytest.mark.parametrize("seed", SEEDS)
def test_data_test_points_and_hypers_are_unchanged(seed, full):
    cfg, _ = small("d2_n100k_pass")
    if full:
        cfg = harness.load_config(harness.load_spec(),
                                  harness.cell_entry(harness.load_spec(), "d2_n100k_pass"))
    x, y = harness.make_data(cfg, seed)
    x0, y0 = _old_data(cfg, seed)
    assert x.dtype == x0.dtype and y.dtype == y0.dtype
    assert np.array_equal(x, x0) and np.array_equal(y, y0)
    xt = harness.test_points(cfg, seed)
    xt0 = np.linspace(cfg["test_lo"], cfg["test_hi"], cfg["n_test"]).reshape(-1, 1)
    assert np.array_equal(xt, xt0) and np.array_equal(harness.test_points(cfg), xt0)
    hyp = harness.hypers(cfg)
    assert hyp.dtype == np.float64 and hyp.tolist() == [0.0, 0.0, -1.0]


def test_model_is_the_one_built_with_isose_directly():
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    cfg, _ = small("d2_n100k_pass")
    x, y = harness.make_data(cfg, SEEDS[1])
    mine = harness.build_model(cfg, x, y, "cpu")
    direct = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, depth=2, eps=0.5,
                              kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0, seed=0,
                              device="cpu", dtype=torch.float32, do_fit=False,
                              overlap=False)
    assert mine.layout == direct.layout
    assert [o.size for o in mine.plan.leaf_obs] == [o.size for o in direct.plan.leaf_obs]
    assert list(mine.bucket_spec.nmaxs) == list(direct.bucket_spec.nmaxs)
    assert [list(i) for i in mine.bucket_spec.leaf_ids] == [
        list(i) for i in direct.bucket_spec.leaf_ids]
    assert mine.theta.dtype == direct.theta.dtype
    assert torch.equal(mine.theta, direct.theta)
