"""The port's host layer against the JAX package: tree, plan, size buckets,
padded batches and test-point routing must be EXACTLY equal for the same
data and seed (the tree's RNG trajectory included)."""
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm

from .torch_threads import one_torch_thread  # noqa: F401

# (seed, N, D, kernel mixture?[, depth]) — three 1-D headline-like trees,
# one 2-D kernel-mixture tree (leaf-level sums draw Dirichlet weights from
# the same RNG stream), and the N=20k tree at depth 3 (1,728 leaves, eight
# buckets in the fused kernel's domain)
CASES = [(0, 2000, 1, False), (1, 2000, 1, False), (2, 1800, 1, False),
         (3, 1500, 2, True), (0, 20000, 1, False, 3)]


def _case_id(c):
    return f"seed{c[0]}-d{c[2]}" + (f"-n{c[1]}-depth{c[4]}" if len(c) > 4 else "")


def _data(seed, n, d):
    rng = np.random.default_rng(100 + seed)
    x = rng.uniform(0.0, 1.0, (n, d))
    if d == 1:
        x = np.sort(x, axis=0)
    y = np.sin(x.sum(axis=1) * 4 * np.pi) + rng.normal(0.0, 0.2, n)
    return x, y


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def pair(request):
    seed, n, d, mixture = request.param[:4]
    depth = request.param[4] if len(request.param) > 4 else 2
    x, y = _data(seed, n, d)
    if mixture:
        kj = [dsm.IsoSE(0.0, 0.0), dsm.IsoLinear(0.1)]
        kt = [tdsm.IsoSE(0.0, 0.0), tdsm.IsoLinear(0.1)]
    else:
        kj, kt = dsm.IsoSE(0.0, 0.0), tdsm.IsoSE(0.0, 0.0)
    common = dict(V=3, K=4, M=30, log_noise=-1.0, seed=seed, do_fit=False,
                  depth=depth)
    jm = dsm.build_dsmgp(x, y, kernel=kj, overlap=False, **common)
    tm = tdsm.build_dsmgp(x, y, kernel=kt, device="cpu", **common)
    return jm, tm


def test_tree_and_plan_equal(pair):
    jm, tm = pair
    jp, tp = jm.plan, tm.plan
    assert len(jp.leaf_obs) == len(tp.leaf_obs)
    for a, b in zip(jp.leaf_obs, tp.leaf_obs):
        np.testing.assert_array_equal(a, b)
    scalars = ("num_leaves", "nmax", "dim", "num_slots", "root_slot",
               "n_sum_edges", "pad_multiple")
    for name in scalars:
        assert getattr(jp, name) == getattr(tp, name), name
    arrays = ("leaf_lb", "leaf_ub", "leaf_kernelid", "leaf_mean",
              "init_logweights", "edge_is_leaf_sum", "edge_neg_logk",
              "path_edges", "path_mask", "root_child_id")
    for name in arrays:
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(jp.groups) == len(tp.groups)
    for gj, gt in zip(jp.groups, tp.groups):
        assert (gj.kind, gj.n_parents) == (gt.kind, gt.n_parents)
        for name in ("child_slots", "seg", "edge_ids", "neg_logk"):
            np.testing.assert_array_equal(getattr(gj, name), getattr(gt, name))


def test_buckets_and_batches_equal(pair):
    jm, tm = pair
    assert jm.bucket_spec.nmaxs == tm.bucket_spec.nmaxs
    for a, b in zip(jm.bucket_spec.leaf_ids, tm.bucket_spec.leaf_ids):
        np.testing.assert_array_equal(a, b)
    for bj, bt in zip(jm.bucket_batches, tm.bucket_batches):
        for name in bj._fields:
            a, b = np.asarray(getattr(bj, name)), getattr(bt, name)
            assert b.device.type == "cpu"
            assert a.dtype == b.numpy().dtype, name
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert tm.theta.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(jm.theta), tm.get_params())


def test_routing_equal(pair):
    jm, tm = pair
    d = jm.plan.dim
    rng = np.random.default_rng(7)
    for t in (1, 37, 900):
        xt = rng.uniform(-0.05, 1.05, (t, d))
        (ti_j, tm_j), (ti_t, tm_t) = jm._route(xt), tm._route(xt)
        np.testing.assert_array_equal(ti_j, ti_t)
        np.testing.assert_array_equal(tm_j, tm_t)
