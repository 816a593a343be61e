"""Phase 16 of ``chip_smoke.py``, the scale frontier, on the CPU: its seed
file check, its gates against sampled float64 leaf oracles and its float64
NumPy replica of the SPN combine, held to ``bench.py``'s and to the JAX
package's on a toy depth-4 tree (N=1,000, M=30: 1,278 leaves, 200 test
points); and the repo's two seed files, well formed for their stamps.

The port's pipeline runs in float64 on one torch thread; JAX's combine
is computed once per session (``tests/session_refs.py``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke as cs
from deepstructuredmixtures_tpu import infer as jinfer
from deepstructuredmixtures_tpu import models as jmodels

from .oracle import OracleGP
from .session_refs import once
from .torch_threads import one_torch_thread  # noqa: F401

N_TOY, T_TOY = 1_000, 200
XT = np.linspace(-0.05, 1.05, T_TOY).reshape(-1, 1)


@pytest.fixture(scope="module")
def toy():
    """The frontier's model at N=1,000 in float64 on the CPU, its routes
    and one run of the phase's pipeline (``streamed_pipeline(leaves=True)``)
    at the toy's 200 test points."""
    model = cs.frontier_model(N_TOY, torch.float64, "cpu")
    tidx, tmask = model._route(XT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "T_TEST", T_TOY)
        mean, var, z, mu_l, var_l, mll = cs.streamed_pipeline(model,
                                                              leaves=True)()
    return dict(model=model, tidx=tidx, tmask=tmask, mean=mean.numpy(),
                var=var.numpy(), z=float(z), mu=mu_l.numpy(), var_l=var_l.numpy(),
                mll=mll.numpy())


def _jax_combine(toy):
    """JAX's ``infer.update_weights`` and ``models._routed_moment_match`` on
    the port's leaf mlls and moments, on the JAX package's own plan (each
    under ``jax.jit``: op by op they compile for seconds); and
    ``bench.model_flops`` on that plan."""
    x, y = cs.make_data(N_TOY)
    jm = bench.build_model(x, y, np.float64, cs.FRONTIER_M,
                           depth=cs.FRONTIER_DEPTH, overlap=False)
    lw, z = jax.jit(lambda m: jinfer.update_weights(jm.plan, m))(toy["mll"])
    mean, var = jax.jit(lambda mu, var, lw: jmodels._routed_moment_match(
        jm.plan, mu, var, lw, toy["tidx"], toy["tmask"], T_TOY))(
        toy["mu"], toy["var_l"], lw)
    return {"lw": lw, "z": z, "mean": mean, "var": var,
            "leaves": jm.num_leaves,
            "flops": bench.model_flops(jm.plan, toy["tidx"], toy["tmask"])}


@pytest.fixture(scope="module")
def jax_combine(toy, tmp_path_factory):
    return once(tmp_path_factory, "frontier_jax_combine",
                lambda: _jax_combine(toy))


def _replica(toy):
    plan = toy["model"].plan
    lw, z = cs.np_update_weights(plan, toy["mll"])
    mean, var = cs.np_moment_match(plan, toy["mu"], toy["var_l"], lw,
                                   toy["tidx"], toy["tmask"], T_TOY)
    return lw, z, mean, var


def test_toy_tree_is_deep(toy):
    assert toy["model"].num_leaves == 1_278
    assert toy["tmask"].sum(axis=1).max() > 1


def test_combine_replica_equals_bench(toy):
    """The phase's replica is ``bench._np_update_weights`` /
    ``_np_moment_match``."""
    plan = toy["model"].plan
    lw, z, mean, var = _replica(toy)
    lw_b, z_b = bench._np_update_weights(plan, toy["mll"])
    mean_b, var_b = bench._np_moment_match(plan, toy["mu"], toy["var_l"], lw_b,
                                           toy["tidx"], toy["tmask"], T_TOY)
    np.testing.assert_array_equal(lw, lw_b)
    assert z == z_b
    np.testing.assert_array_equal(mean, mean_b)
    np.testing.assert_array_equal(var, var_b)


def test_combine_replica_equals_jax(toy, jax_combine):
    """The replica against the JAX package's weight update and routed
    moment matching on the same leaf moments, float64, 1e-10."""
    assert int(jax_combine["leaves"]) == toy["model"].num_leaves
    lw, z, mean, var = _replica(toy)
    np.testing.assert_allclose(lw, jax_combine["lw"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(z, jax_combine["z"], rtol=1e-10)
    np.testing.assert_allclose(mean, jax_combine["mean"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var, jax_combine["var"], rtol=1e-10)


def test_combine_replica_holds_the_port(toy):
    """The phase's combine gate on the port's own float64 pipeline: far
    inside ``COMBINE_TOL``."""
    _, z, mean, var = _replica(toy)
    errs = cs._moment_errors(toy["mean"], toy["var"], mean, var)
    assert errs["mean_abs"] <= 1e-10 and errs["var_rel"] <= 1e-10, errs
    assert abs(toy["z"] - z) <= 1e-10 * abs(z)
    assert all(errs[k] <= cs.COMBINE_TOL[k] for k in cs.COMBINE_TOL)


def test_model_flops_equals_bench(toy, jax_combine):
    got = cs.model_flops(toy["model"].plan, toy["tmask"])
    assert got == pytest.approx(float(jax_combine["flops"]), rel=1e-12)


def _oracle_seed(toy):
    """A seed file of the toy tree in ``_seed_n1m_baseline.py``'s format,
    from the float64 NumPy GP of ``tests/oracle.py``: 24 leaves spread over
    the sizes, the smallest and the largest among them."""
    plan = toy["model"].plan
    x, y = cs.make_data(N_TOY)
    sizes = np.array([o.size for o in plan.leaf_obs])
    order = np.argsort(sizes, kind="stable")
    leaves = np.unique(order[np.linspace(0, order.size - 1, 24).astype(int)])
    tmax = toy["tidx"].shape[1]
    mu = np.zeros((leaves.size, tmax))
    var = np.zeros((leaves.size, tmax))
    mlls, tcount = [], []
    for i, leaf in enumerate(leaves):
        obs = plan.leaf_obs[leaf]
        gp = OracleGP(x[obs], y[obs], "iso_se", 0.0, 0.0, -1.0)
        nt = int(toy["tmask"][leaf].sum())
        if nt:
            mu[i, :nt], var[i, :nt] = gp.predict(XT[toy["tidx"][leaf][:nt]])
        mlls.append(gp.mll())
        tcount.append(nt)
    return dict(leaves=leaves, mlls=np.array(mlls), mu=mu, var=var,
                tcount=np.array(tcount), n=np.int64(N_TOY),
                depth=np.int64(cs.FRONTIER_DEPTH), m=np.int64(cs.FRONTIER_M))


@pytest.fixture(scope="module")
def seed_file(toy, tmp_path_factory):
    seed = _oracle_seed(toy)
    path = tmp_path_factory.mktemp("seed") / "toy_sampled_moments.npz"
    np.savez(path, **seed)
    return path, seed


def _load(path, toy):
    return cs.load_seed(path, N_TOY, cs.FRONTIER_DEPTH, cs.FRONTIER_M,
                        toy["model"].num_leaves)


def test_gate_holds_the_port_to_the_oracle_seed(toy, seed_file):
    """The port's float64 CPU pipeline against a seed file written from the
    float64 NumPy oracle: the phase's checks pass and its errors are at the
    level of float64 round-off, far inside ``ORACLE_TOL``."""
    path, _ = seed_file
    seed = _load(path, toy)
    assert seed["leaves"].size > 10 and seed["tcount"].max() > 0
    cs.check_seed_tree(seed, toy["tmask"])
    errs, worst = cs.seed_errors(seed, toy["mll"], toy["mu"], toy["var_l"])
    assert worst in seed["leaves"]
    assert errs["mll_rel"] <= 1e-10, errs
    assert errs["mean_abs"] <= 1e-10, errs
    assert errs["var_rel"] <= 1e-10, errs


@pytest.mark.parametrize("what", ["mll", "mean", "variance"])
def test_gate_sees_one_wrong_leaf(toy, seed_file, what):
    """One sampled leaf's mll, routed mean or variance moved past its bound
    shows in the phase's errors."""
    path, _ = seed_file
    seed = _load(path, toy)
    i = int(np.argmax(seed["tcount"]))
    leaf = int(seed["leaves"][i])
    mll, mu, var = toy["mll"].copy(), toy["mu"].copy(), toy["var_l"].copy()
    if what == "mll":
        mll[leaf] += 2e-3 * max(1.0, abs(mll[leaf]))
    elif what == "mean":
        mu[leaf, seed["tcount"][i] - 1] += 1e-2
    else:
        var[leaf, 0] *= 1.002
    errs, worst = cs.seed_errors(seed, mll, mu, var)
    key = {"mll": "mll_rel", "mean": "mean_abs", "variance": "var_rel"}[what]
    assert errs[key] > cs.ORACLE_TOL[key]
    if what == "mll":
        assert worst == leaf


@pytest.mark.parametrize("bad", ["n", "depth", "m", "leaf_id", "negative_id",
                                 "duplicate_id", "mu_rows", "var_shape",
                                 "tcount_width", "missing_stamp"])
def test_seed_check_refuses(toy, seed_file, tmp_path, bad):
    """A seed file stamped for another run, with a leaf id outside the tree
    or arrays of inconsistent shapes is refused before any pass."""
    _, seed = seed_file
    seed = dict(seed)
    L = toy["model"].num_leaves
    if bad in ("n", "depth", "m"):
        seed[bad] = seed[bad] + 1
    elif bad == "leaf_id":
        seed["leaves"] = seed["leaves"].copy()
        seed["leaves"][-1] = L
    elif bad == "negative_id":
        seed["leaves"] = seed["leaves"].copy()
        seed["leaves"][0] = -1
    elif bad == "duplicate_id":
        seed["leaves"] = seed["leaves"].copy()
        seed["leaves"][1] = seed["leaves"][0]
    elif bad == "mu_rows":
        seed["mu"] = seed["mu"][:-1]
    elif bad == "var_shape":
        seed["var"] = seed["var"][:, :-1]
    elif bad == "tcount_width":
        seed["tcount"] = seed["tcount"].copy()
        seed["tcount"][0] = seed["mu"].shape[1] + 1
    else:
        del seed["depth"]
    path = tmp_path / "bad.npz"
    np.savez(path, **seed)
    with pytest.raises(AssertionError):
        _load(path, toy)


def test_seed_check_refuses_another_tree(toy, seed_file):
    """The tree-identity check: routed test counts of another tree (here
    one leaf's count off by one) are refused."""
    path, _ = seed_file
    seed = _load(path, toy)
    cs.check_seed_tree(seed, toy["tmask"])
    other = dict(seed, tcount=seed["tcount"].copy())
    other["tcount"][int(np.argmax(other["tcount"]))] -= 1
    with pytest.raises(AssertionError, match="another tree"):
        cs.check_seed_tree(other, toy["tmask"])


@pytest.mark.parametrize("n_train,name,count", [
    (500_000, "n500k_sampled_moments.npz", 105),
    (1_000_000, "n1m_sampled_moments.npz", 123)])
def test_repo_seed_files_well_formed(n_train, name, count):
    """Both seed files of the repo pass the phase's check for their stamps
    (depth 4, M=30, 20,736 leaves) and hold finite oracles: positive
    variances over each leaf's routed points, zeros past them."""
    seed = cs.load_seed(os.path.join(cs.REPO, name), n_train, 4, 30,
                        (3 * 4) ** 4)
    assert seed["leaves"].size == count
    assert seed["mu"].shape == (count, 128)
    assert np.isfinite(seed["mlls"]).all() and (seed["mlls"] < 0).all()
    routed = np.arange(128)[None, :] < seed["tcount"][:, None]
    assert np.isfinite(seed["mu"]).all() and np.isfinite(seed["var"]).all()
    assert (seed["var"][routed] > 0).all()
    assert not seed["mu"][~routed].any() and not seed["var"][~routed].any()
    with pytest.raises(AssertionError, match="stamped"):
        cs.load_seed(os.path.join(cs.REPO, name), n_train // 2, 4, 30,
                     (3 * 4) ** 4)
