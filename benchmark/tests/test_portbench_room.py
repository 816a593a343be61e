"""A configuration states its whole model, so that other leaf kernels and
other data come in as files alone: in a copy of the benchmark's folder, a
configuration that names the three-kernel mixture on the existing recipe,
and one that names a 4-D ARD SE kernel with a 4-D recipe written beside
it, go through the ``pass``, ``train`` and ``serve`` drivers at a small
size on the CPU, without the comparison; an unknown kind raises, and the
IsoSE reference refuses any other model."""
from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest

from portbench_small import ROOT, small

from benchmark import harness
from benchmark.reference import dsmgp_isose

MIX3 = [{"kind": "iso_se", "logl": 0.0, "logsigma": 0.0},
        {"kind": "ard_se", "logl": [0.0], "logsigma": 0.0},
        {"kind": "iso_linear", "logl": 0.0}]
ARD4 = [{"kind": "ard_se", "logl": [0.0, 0.1, -0.1, 0.2], "logsigma": 0.0}]

RECIPE_4D = '''"""Four-dimensional test data: x uniform on [0, 1]^4, y a sum of sines."""
import numpy as np

from benchmark.harness import seed_key


def make(cfg, seed):
    rng = np.random.default_rng(seed_key(seed))
    x = rng.uniform(0.0, 1.0, (cfg["n_train"], 4))
    y = np.sin(2 * np.pi * x).sum(axis=1) + rng.normal(0.0, cfg["noise_std"], cfg["n_train"])
    return x, y


def test_points(cfg, seed):
    return np.random.default_rng([seed_key(seed), 9]).uniform(0.0, 1.0, (cfg["n_test"], 4))
'''

CASES = {"mix3": (MIX3, "uniform_sin4pi", 1), "ard4": (ARD4, "uniform_4d", 4)}


@pytest.fixture
def copied(tmp_path, monkeypatch):
    """The benchmark's folder copied, with the 4-D recipe added as a file,
    and the harness finding its files there."""
    copy = tmp_path / "benchmark"
    shutil.copytree(f"{ROOT}/benchmark", copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "data" / "uniform_4d.py").write_text(RECIPE_4D)
    monkeypatch.setattr(harness, "HERE", copy)
    return copy


def _config(copy, case):
    """The case's configuration, written into the copy and read back."""
    kernels, recipe, _ = CASES[case]
    cfg, _ = small("d2_n100k_pass")
    cfg = dict(cfg, name=f"small_{case}", kernels=kernels, data=recipe, n_train=1200,
               n_test=60, dtype="float64")
    path = copy / "configs" / f"small_{case}.json"
    path.write_text(json.dumps(cfg))
    return json.loads(path.read_text())


def _run_driver(cfg, traffic, seed=31415926535):
    tr = harness.load_traffic(traffic)
    if tr["kind"] == "serve":
        tr = dict(tr, clients=3, points_per_request=8, max_batch_points=32, chunk_points=16,
                  warm_rounds=1)
    run = harness.Run({"name": traffic, "chips": 1}, cfg, tr, seed, 0.3, 0, "cpu",
                      time.perf_counter())
    harness.load_driver(tr["kind"]).run(run)
    assert run.attempted >= 1 and run.failed == 0
    return run.outputs


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_follows_the_kernel_list(copied, case):
    cfg = _config(copied, case)
    kernels, _, dim = CASES[case]
    x, y = harness.make_data(cfg, 7)
    assert x.shape == (1200, dim) and y.shape == (1200,)
    assert harness.test_points(cfg, 7).shape == (60, dim)
    model = harness.build_model(cfg, x, y, "cpu")
    assert model.layout.kinds == tuple(k["kind"] for k in kernels)
    counts = np.bincount(model.plan.leaf_kernelid, minlength=len(kernels))
    assert len(counts) == len(kernels) and np.all(counts == counts[0]) and counts[0] > 0
    np.testing.assert_array_equal(model.theta.numpy(), harness.hypers(cfg))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_train_and_serve_run_on_it(copied, case):
    cfg = _config(copied, case)
    dim = CASES[case][2]
    out = _run_driver(cfg, "streamed_pass")
    assert out["x"].shape[1] == dim and out["xt"].shape == (60, dim)
    for k in ("mean", "var", "mll", "leaf_mean", "leaf_var"):
        assert np.all(np.isfinite(out[k])), k
    assert np.isfinite(out["z"]) and np.all(out["var"] > 0)
    out = _run_driver(cfg, "tied_train")
    np.testing.assert_array_equal(out["theta0"], harness.hypers(cfg))
    for k in ("values", "first_grad", "theta_k"):
        assert np.all(np.isfinite(out[k])), k
    assert not np.array_equal(out["theta_k"], out["theta0"])
    out = _run_driver(cfg, "cached_serve")
    assert out["requests"]
    for q, mean, var in out["requests"]:
        assert q.shape == (8, dim) and mean.shape == (8,) and var.shape == (8,)
        assert np.all(np.isfinite(mean)) and np.all(np.isfinite(var))


def test_an_unknown_kind_raises(copied):
    cfg = _config(copied, "mix3")
    x, y = harness.make_data(cfg, 7)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        harness.build_model(dict(cfg, kernels=[{"kind": "rbf", "logl": 0.0,
                                                "logsigma": 0.0}]), x, y, "cpu")
    with pytest.raises(ValueError, match="no variance"):
        harness.build_model(dict(cfg, kernels=[{"kind": "iso_linear", "logl": 0.0,
                                                "logsigma": 0.0}]), x, y, "cpu")
    with pytest.raises(KeyError):
        harness.build_model(dict(cfg, kernels=[{"kind": "iso_se", "logl": 0.0}]), x, y, "cpu")


def test_the_isose_reference_refuses_another_model(copied):
    cfg = _config(copied, "mix3")
    x, y = harness.make_data(cfg, 7)
    with pytest.raises(ValueError, match="names its own reference"):
        dsmgp_isose.Model(x, y, cfg)
    with pytest.raises(ValueError, match="names its own reference"):
        dsmgp_isose.Model(x, y, dict(cfg, kernels=CASES["ard4"][0]))
