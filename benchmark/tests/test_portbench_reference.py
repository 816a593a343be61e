"""The plain reference against the port, both in float64 on the CPU at a
small size: the same partition, leaf mlls, evidence, posterior weights,
moments and training gradient; and the reference imports nothing of the
program."""
from __future__ import annotations

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from portbench_small import N_TRAIN, ROOT, small

from benchmark import harness
from benchmark.reference import dsmgp_isose as ref


@pytest.fixture(scope="module", params=[2, 4], ids=["depth2", "depth4"])
def pair(request):
    # depth 4: the headline's model on the depth-4 tree, which no cell runs
    # yet, so that a cell added for it finds its reference tested
    cfg, _ = small("d2_n100k_pass")
    cfg = dict(cfg, dtype="float64", depth=request.param, n_train=N_TRAIN[request.param])
    x, y = harness.make_data(cfg, 987654321987)
    return cfg, x, y, harness.build_model(cfg, x, y, "cpu"), ref.Model(x, y, cfg)


def test_same_partition(pair):
    _, _, _, port, mine = pair
    assert len(port.plan.leaf_obs) == len(mine.leaves)
    for a, b in zip(port.plan.leaf_obs, mine.leaves):
        np.testing.assert_array_equal(a, b["obs"])
    np.testing.assert_array_equal(port.plan.leaf_lb, mine.lb)
    np.testing.assert_array_equal(port.plan.leaf_ub, mine.ub)


def test_pass_matches_the_port_in_float64(pair):
    from deepstructuredmixtures_tpu_torch import fit, infer
    from deepstructuredmixtures_tpu_torch.models import _routed_moment_match

    cfg, _, _, port, mine = pair
    xt = harness.test_points(cfg)
    tidx, tmask = port._route(xt)
    ti = torch.as_tensor(tidx, dtype=torch.long)
    mu, var, mll = fit.bucketed_streamed_predict(
        port.layout, port.theta, port.bucket_batches, port.bucket_spec.leaf_ids,
        port.num_leaves, torch.as_tensor(xt), ti)
    lw, z = infer.update_weights(port.plan, mll)
    mean, v = _routed_moment_match(port.plan, mu, var, lw, ti, torch.as_tensor(tmask),
                                   len(xt))
    r = mine.predict(harness.hypers(cfg), xt, torch.float64, torch.device("cpu"))
    np.testing.assert_allclose(mll.numpy(), r["mll"], rtol=1e-10, atol=1e-9)
    assert float(z) == pytest.approx(r["z"], rel=1e-12)
    np.testing.assert_allclose(np.exp(lw.numpy()), r["weights"], atol=1e-10)
    np.testing.assert_allclose(mean.numpy(), r["mean"], atol=1e-9)
    np.testing.assert_allclose(v.numpy(), r["var"], rtol=1e-8)


def test_training_gradient_matches_the_port_in_float64(pair):
    train = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    cfg, _, _, port, mine = pair
    hyp = harness.hypers(cfg) + np.array([0.1, -0.2, 0.05])
    val, g = train._train_vg(port)(torch.as_tensor(hyp))
    z, g_ref = mine.value_and_grad(hyp, torch.float64, torch.device("cpu"))
    assert float(val) == pytest.approx(z, rel=1e-12)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8, atol=1e-8)


def test_adam_follows_torch():
    theta = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=1e-3)
    grads = [np.array([1.0, -2.0, 0.5]), np.array([0.3, 0.1, -4.0]), np.array([2.0, 2.0, 2.0])]
    for g in grads:
        theta.grad = -torch.as_tensor(g)
        opt.step()
    it = iter(grads)
    _, _, thetas = ref.adam_ascent(lambda th: (0.0, next(it)), [0.0, 0.0, -1.0], 3, 1e-3)
    np.testing.assert_allclose(thetas[-1], theta.detach().numpy(), rtol=1e-12)


def test_reference_imports_nothing_of_the_program():
    for path in pathlib.Path(ROOT, "benchmark", "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("deepstructuredmixtures_tpu_torch",
                                               "deepstructuredmixtures_tpu", "jax",
                                               "benchmark"), (path, n)
