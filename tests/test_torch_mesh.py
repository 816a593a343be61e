"""The port's multi-device path against the JAX package, in float64 on the
CPU: a world of 4 gloo ranks (``tests/torch_mesh_ranks.py``, spawned once
for the module) against the JAX package on ``jax.sharding`` meshes of 4 of
the 8 fake CPU devices of ``tests/conftest.py``, with the same blocks.

Held at 1e-10 (relative to ``max(1, |value|)`` for mlls) to the JAX
package and to the port's own single-device run: the distributed Cholesky
and both solves, ``_check_blocking``'s errors, the giant-leaf GP with its
padding, ``GaussianProcess.fit(mesh=)``, the sharded leaf mlls, gradient,
fit, routed and streamed predicts (JAX's mesh functions), ``fit(mesh=)``
of DSMGP and PoE with giant leaves (JAX's single-device models), the
refusals and the multi-axis mesh. The 2-3 iteration histories at 1e-8, as
in ``tests/test_torch_train.py``: ``train(mesh=)`` against JAX's ``train``,
``finetune(mesh=)`` against JAX's ``finetune``, the train step against
one device (see :func:`_jax_refs`). The ranks also run the dry run
(``parallel.dryrun.check``).

The ranks and a process computing JAX's ``finetune`` references start
before the other JAX references are computed, so all run side by side;
each JAX reference is computed once.
"""
import contextlib
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import deepstructuredmixtures_tpu as dsm
from deepstructuredmixtures_tpu import fit as jfit
from deepstructuredmixtures_tpu.parallel import (
    dist_chol as jdc,
    make_mesh as jmake_mesh,
    make_sharded_mll_fn,
    make_sharded_routed_predict,
    sharded_cholesky,
    sharded_fit,
    sharded_solve_lower,
    sharded_solve_lower_t,
)

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import parallel as tparallel

from . import torch_mesh_ranks as R

WORLD = 4
TOL, TRAJ_TOL = 1e-10, 1e-8
#: the ranks' whole run; it takes seconds (a cut-off, not an expectation)
RANKS_TIMEOUT_S = 600
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX's ``finetune`` of :data:`R.FINETUNES`, in a process of its own with
#: XLA's CPU ops on one thread: its candidate loop is many small parallel
#: ops, which in the pytest worker, beside 5 busy workers on an 8-CPU host,
#: ran about 30 times slower than alone (93 s for the two runs) as their
#: threads waited on one another. Its monolithic route (the candidates
#: vmapped) is the one JAX's own tests hold to the bucketed route at 1e-8.
_JAX_FINETUNES = """
import sys

import jax

jax.config.update("jax_enable_x64", True)
import numpy as np
import optax

import deepstructuredmixtures_tpu as dsm
from tests import torch_mesh_ranks as R

ref = {}
for name, iters in R.FINETUNES:
    m = R.build(dsm, name)
    ref[f"finetune_{name}_hist"] = dsm.finetune(
        m, optax.adam(1e-2), iterations=iters, lam=1e-9, progress=False)
    ref[f"finetune_{name}_theta"] = np.asarray(m.theta)
np.savez(sys.argv[1], **ref)
"""


def _start_jax_finetunes(path, log):
    """Start :data:`_JAX_FINETUNES`, writing to ``path``; its output goes
    to the open file ``log``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", _JAX_FINETUNES, path],
                            cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)

@contextlib.contextmanager
def _one_blas_thread():
    """Children inherit the environment when spawned: one BLAS thread each,
    as each runs torch on one thread (several ranks of several threads on
    toy matrices only wait on one another)."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _message(exc, fn):
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def _jax_refs():
    """Every JAX reference. The parallel functions run on meshes of 4 fake
    devices; the model-level entry points (``fit(mesh=)`` of DSMGP and PoE,
    ``train(mesh=)``, ``finetune(mesh=)``) are held to JAX's single-device
    runs of the same calls, which the JAX package's own tests hold to its
    mesh runs (``tests/test_dist_chol.py``, ``tests/test_sharding.py``,
    ``tests/test_train.py``): its mesh programs compile for tens of seconds,
    several times longer under the parallel suite. ``finetune`` runs in a
    process of its own (:data:`_JAX_FINETUNES`)."""
    mesh = jmake_mesh(WORLD)
    ref = {}
    # the factor is unique: both blocks are held to block 64's
    ref["chol"] = sharded_cholesky(jnp.asarray(R.spd(1024)), mesh, block=64)
    L, _, B, z, Z = (jnp.asarray(a) for a in R.solve_inputs())
    ref["solve_lower_mat"] = sharded_solve_lower(L, B, mesh, block=64)
    ref["solve_lower_vec"] = ref["solve_lower_mat"][:, 0]  # b = B[:, 0]
    ref["solve_lower_t_vec"] = sharded_solve_lower_t(L, z, mesh, block=64)
    ref["solve_lower_t_mat"] = jnp.stack([
        sharded_solve_lower_t(L, Z[:, k], mesh, block=64)
        for k in range(Z.shape[1])], axis=1)
    ref["err_rows_block"] = _message(
        ValueError, lambda: jdc._check_blocking(1024, WORLD, 96))
    ref["err_mesh_size"] = _message(
        ValueError, lambda: jdc._check_blocking(102, WORLD, 32))

    # GaussianProcess.fit(mesh=) pads to the 4 x 64 tiling and calls
    # sharded_gp_fit / sharded_gp_predict on its centred targets, as the
    # port's direct calls do
    x, y = R.gp_data()
    g = dsm.GaussianProcess(x, y, kernel=dsm.IsoSE(-1.0, 0.0),
                            log_noise=-1.5).fit(mesh=mesh, block=64)
    ref["gp_mll"] = ref["gpfit_mll"] = g.mll()
    ref["gpfit_alpha"] = g._state[1]
    ref["gp_mu"], ref["gp_var"] = g.predict(R.XT33)
    ref["gpfit_mu"], ref["gpfit_var"] = ref["gp_mu"], ref["gp_var"]
    ref["gp_err_grad"] = _message(NotImplementedError, g.grad_mll)
    ref["gp_err_full_cov"] = _message(
        NotImplementedError, lambda: g.predict(R.XT33, full_cov=True))
    ref["gp_err_train_gp"] = _message(
        NotImplementedError, lambda: dsm.train_gp(g, iterations=1))
    g.set_params(np.asarray(g.theta) + 0.05)
    ref["gp_mu2"], ref["gp_var2"] = g.predict(R.XT33)

    m = R.build(dsm, "s1")
    f, _ = make_sharded_mll_fn(m.layout, m.plan, m.batch, mesh)
    ref["mll"], ref["grad"] = jax.jit(jax.value_and_grad(f))(m.theta)
    ref["fit_mll"] = sharded_fit(m.layout, m.theta, m.batch,
                                 mesh).mll[:m.num_leaves]
    tidx, tmask = m._route(R.XT73)
    fr, prepare = make_sharded_routed_predict(m.layout, m.plan, m.batch, mesh)
    ref["routed_z"], ref["routed_mean"], ref["routed_var"] = fr(
        m.theta, jnp.asarray(R.XT73), *prepare(tidx, tmask))
    # the streamed path: JAX's local one, jitted (its sharded form retraces
    # its shard_map at every call)
    tidx, tmask = m._route(R.XT60)
    ids, nl = m.bucket_spec.leaf_ids, m.num_leaves
    for k, v in zip(("mu", "var", "mll"), jax.jit(
            lambda th, bb, xt, ti, tm: jfit.bucketed_streamed_predict(
                m.layout, th, bb, ids, nl, xt, ti, tm))(
                    m.theta, m.bucket_batches, jnp.asarray(R.XT60),
                    jnp.asarray(tidx), jnp.asarray(tmask))):
        ref[f"streamed_routed_{k}"] = v
    ref["streamed_all_mll"] = ref["streamed_routed_mll"]

    md = R.build(dsm, "giant")
    md.fit()
    ref["giant_leaf_mll"] = md.leaf_mlls()
    ref["giant_z"] = md.update()
    ref["giant_mean"], ref["giant_var"] = md.predict(R.XT41)
    ref["giant_mean_only"] = ref["giant_mean"]
    md._giant = {0: None}  # as after fit(mesh=...): refine_steps is refused
    ref["giant_err_refine"] = _message(
        ValueError, lambda: md.predict(R.XT41, refine_steps=1))
    for store, method in (("full", "auto"), ("auto", "shared")):
        ref[f"giant_err_{method}_{store}"] = _message(ValueError, lambda: md.fit(
            mesh=mesh, store=store, method=method))
    multi = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("a", "b"))
    ref["giant_err_multi"] = _message(ValueError, lambda: md.fit(
        mesh=multi, giant_leaf_bytes=1, block=16))

    p = R.build(dsm, "poe")
    p.fit()
    ref["poe_all_mean"], ref["poe_all_var"] = p.predict(R.XT41)
    ref["poe_mix_mean"], ref["poe_mix_var"] = (ref["poe_all_mean"],
                                               ref["poe_all_var"])
    m = R.build(dsm, "s13")
    ref["train_hist"] = dsm.train(m, optax.adam(5e-2), iterations=3,
                                  lam=1e-9, randinit=False, progress=False)
    ref["train_theta"] = m.theta
    m = R.build(dsm, "ft")
    m.theta = jnp.broadcast_to(m.theta, (m.num_leaves, m.theta.size))
    ref["train_err_untied"] = _message(ValueError, lambda: dsm.train(
        m, optax.adam(5e-2), iterations=1, randinit=False, mesh=mesh))
    m = R.build(dsm, "s13")
    m.bucket_batches = None
    ref["train_err_chunk"] = _message(ValueError, lambda: dsm.train(
        m, optax.adam(5e-2), iterations=1, randinit=False, mesh=mesh,
        chunk=1))
    return {k: v if isinstance(v, str) else np.asarray(v)
            for k, v in ref.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: the ranks' results (rank 0's ``npz``) and the JAX
    references, computed while the ranks run."""
    d = tmp_path_factory.mktemp("mesh")
    out = str(d / "out{}.npz")
    log = open(d / "finetune.log", "w+")
    ft = _start_jax_finetunes(str(d / "finetune.npz"), log)
    with _one_blas_thread():
        ctx = torch.multiprocessing.start_processes(
            R.run, args=(WORLD, str(d / "store"), out), nprocs=WORLD,
            join=False, start_method="spawn")
    try:
        ref = _jax_refs()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks ran past "
                                   f"{RANKS_TIMEOUT_S} s")
        ft.wait(timeout=max(1.0, deadline - time.monotonic()))
        log.seek(0)
        assert ft.returncode == 0, log.read()[-4000:]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        if ft.poll() is None:
            ft.kill()
        log.close()
    with np.load(d / "finetune.npz") as z:
        ref.update({k: z[k] for k in z.files})
    port = {}
    for rank in reversed(range(WORLD)):  # rank 0's last: all agree anyway
        with np.load(out.format(rank)) as z:
            port.update({k: z[k] for k in z.files})
    return port, ref


def _close(port, ref, key, tol=TOL, single=True, rel=False):
    """``port[key]`` within ``tol`` of the JAX reference and of the port's
    single-device run (``key + '_single'``); ``rel``: relative to
    ``max(1, |value|)``."""
    a = port[key]
    scale = np.maximum(1.0, np.abs(a)) if rel else 1.0
    for name, b in (("jax", ref.get(key)),
                    ("one device", port.get(key + "_single") if single else None)):
        if b is None:
            continue
        b = np.asarray(b)
        assert a.shape == b.shape, (key, name, a.shape, b.shape)
        err = np.max(np.abs(a - b) / scale)
        assert err <= tol, f"{key} vs {name}: {err}"


# ---------------------------------------------------------------------------
# parallel.dist_chol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", R.CHOL_BLOCKS)
def test_sharded_cholesky_matches_jax(runs, block):
    """The factor at each block size against JAX's at block 64 (a Cholesky
    factor is unique) and against one device; its strict upper triangle is
    exactly 0."""
    port, ref = runs
    L = port[f"chol{block}"]
    for other in (ref["chol"], port["chol_single"]):
        assert np.max(np.abs(L - other)) <= TOL
    assert np.abs(np.triu(L, 1)).max() == 0.0


@pytest.mark.parametrize("key", ["lower_vec", "lower_mat", "lower_t_vec",
                                 "lower_t_mat"])
def test_sharded_solves_match_jax(runs, key):
    _close(*runs, f"solve_{key}")


def test_check_blocking_errors_as_in_jax(runs):
    """The same messages, raised by the functions that tile (a block that
    does not divide the rows of a rank, a size that does not divide over
    the ranks); a row block of the wrong height is refused too."""
    port, ref = runs
    for key in ("err_rows_block", "err_solve_block", "err_solve_t_block"):
        assert str(port[key]) == ref["err_rows_block"] != ""
    assert str(port["err_mesh_size"]) == ref["err_mesh_size"] != ""
    assert "its row block has 64" in str(port["err_row_block"])
    assert "spans the world" in str(port["err_make_mesh"])
    with pytest.raises(RuntimeError, match="init_process_group"):
        tparallel.make_mesh()  # no process group in this process


def test_parallel_exports_jax_names():
    import deepstructuredmixtures_tpu.parallel as jparallel

    assert tparallel.__all__ == jparallel.__all__
    assert all(callable(getattr(tparallel, k)) for k in tparallel.__all__)


def test_sharded_gp_fit_and_predict_with_padding_match_jax(runs):
    """N=700 padded to the 4 x 64 tiling: alpha is 0 on the padding, and
    alpha, mll, mean and variance agree with JAX and with one device."""
    port, ref = runs
    alpha = port["gpfit_alpha"]
    assert np.abs(alpha[700:]).max() == 0.0
    _close(port, ref, "gpfit_alpha", single=False)
    assert np.max(np.abs(alpha[:700] - port["gpfit_alpha_single"])) <= TOL
    _close(port, ref, "gpfit_mll", rel=True)
    for key in ("gpfit_mu", "gpfit_var"):
        _close(port, ref, key)


def test_gaussian_process_on_mesh_matches_jax(runs):
    """``fit(mesh=)`` pads to the tiling and predicts distributed; after
    ``set_params`` the refit stays on the mesh."""
    port, ref = runs
    _close(port, ref, "gp_mll", rel=True)
    for key in ("gp_mu", "gp_var", "gp_mu2", "gp_var2"):
        _close(port, ref, key)
    assert port["gp_stays_on_mesh"]


def test_gaussian_process_mesh_refusals_as_in_jax(runs):
    port, ref = runs
    for key in ("gp_err_grad", "gp_err_full_cov", "gp_err_train_gp"):
        assert str(port[key]) == ref[key] != ""


# ---------------------------------------------------------------------------
# parallel.mesh
# ---------------------------------------------------------------------------


def test_pad_leaves_and_shard_batch(runs):
    """Padding leaves are fully masked; each rank holds a quarter of the
    padded leaf axis."""
    port, _ = runs
    assert port["pad_ok"]
    L = R.build(tdsm, "s1", device="cpu").num_leaves
    assert port["shard_rows"] == -(-L // WORLD)


def test_sharded_mll_and_grad_match_jax(runs):
    port, ref = runs
    _close(port, ref, "mll", rel=True)
    _close(port, ref, "grad")


def test_sharded_fit_matches_jax(runs):
    _close(*runs, "fit_mll", rel=True)


def test_sharded_routed_predict_matches_jax(runs):
    port, ref = runs
    _close(port, ref, "routed_z", rel=True)
    for key in ("routed_mean", "routed_var"):
        _close(port, ref, key)


def test_sharded_train_step_matches_jax(runs):
    """Two sharded steps (Adam lr 5e-2) against two on one device; the first
    step's value is JAX's sharded mll."""
    port, ref = runs
    _close(port, ref, "step_vals", TRAJ_TOL)
    _close(port, ref, "step_theta", TRAJ_TOL)
    v = float(port["step_vals"][0])
    assert abs(v - float(ref["mll"])) <= TOL * max(1.0, abs(v))


@pytest.mark.parametrize("tag", ["routed", "all"])
def test_sharded_streamed_predict_matches_jax(runs, tag):
    """Routed (DSMGP) and every leaf at every point (the PoE family): the
    leaf mlls, which routing does not change, and the moments against
    JAX's streamed path and one device."""
    port, ref = runs
    _close(port, ref, f"streamed_{tag}_mll", rel=True)
    for k in ("mu", "var"):
        _close(port, ref, f"streamed_{tag}_{k}")


# ---------------------------------------------------------------------------
# fit(mesh=...): giant leaves on the distributed Cholesky
# ---------------------------------------------------------------------------


def test_mesh_fit_giant_leaves_match_jax(runs):
    """DSMGP with the largest bucket's leaves giant and the rest normal:
    leaf mlls, ``update``, ``predict`` and the mean-only path from the
    alphas."""
    port, ref = runs
    assert port["giant_distributed"] == port["giant_expected"] >= 1
    assert port["giant_alpha_cached"]
    _close(port, ref, "giant_leaf_mll", rel=True)
    _close(port, ref, "giant_z", rel=True)
    for key in ("giant_mean", "giant_var", "giant_mean_only"):
        _close(port, ref, key)


@pytest.mark.parametrize("name", ["poe_all", "poe_mix"])
def test_mesh_fit_poe_matches_jax(runs, name):
    """PoE with every leaf giant, and with the largest bucket giant."""
    port, ref = runs
    n, L = int(port[f"{name}_distributed"]), int(port[f"{name}_leaves"])
    assert n == L if name == "poe_all" else 0 < n < L
    for key in (f"{name}_mean", f"{name}_var"):
        _close(port, ref, key)


def test_mesh_fit_guards_as_in_jax(runs):
    """``refine_steps``, ``store='full'`` and ``method='shared'`` raise as in
    JAX; a 2 x 2 mesh needs ``axis`` for ``fit``, ``GaussianProcess.fit``
    and ``finetune``; ``set_params`` drops the giant factors."""
    port, ref = runs
    for key in ("giant_err_refine", "giant_err_auto_full",
                "giant_err_shared_auto", "giant_err_multi"):
        assert str(port[key]) == ref[key] != ""
    for key in ("gp_err_multi", "finetune_err_multi"):
        assert "single mesh axis" in str(port[key])
    assert port["giant_cleared"]


# ---------------------------------------------------------------------------
# train(mesh=...), finetune(mesh=...)
# ---------------------------------------------------------------------------


def test_sharded_value_and_grad_bucketed_matches_jax(runs):
    """One leaf per chunk on each rank: the value is the first of JAX's
    ``train(mesh=)`` history on the same model; value and gradient equal
    the single-device ``make_value_and_grad_bucketed``'s."""
    port, ref = runs
    _close(port, ref, "vg_value", rel=True)
    _close(port, ref, "vg_grad")
    v = float(port["vg_value"])
    assert abs(v - float(ref["train_hist"][0])) <= TOL * max(1.0, abs(v))


def test_train_on_mesh_matches_jax(runs):
    """Three iterations (Adam lr 5e-2, ``chunk=1``) against optax on the JAX
    mesh; a model without size buckets trains through the sharded
    monolithic objective; a ``randinit`` start is the same on every
    rank."""
    port, ref = runs
    _close(port, ref, "train_hist", TRAJ_TOL)
    _close(port, ref, "train_theta", TRAJ_TOL)
    for other in (port["train_hist_single"], ref["train_hist"]):
        assert np.max(np.abs(port["train_nobucket_hist"]
                             - other[:2])) <= TRAJ_TOL
    assert port["train_randinit_replicated"]


def test_train_mesh_refusals_as_in_jax(runs):
    port, ref = runs
    for key in ("train_err_untied", "train_err_chunk"):
        assert str(port[key]) == ref[key] != ""


@pytest.mark.parametrize("name", ["ft", "few"])
def test_finetune_on_mesh_matches_one_device(runs, name):
    """The candidate-sharded route (sparse pair list on ``ft``, its overlap
    20% dense) against JAX's ``finetune`` and the port's single-device
    bucketed route; ``few`` has fewer leaves (candidates) than ranks."""
    port, ref = runs
    if name == "few":
        assert port["finetune_few_leaves"] < WORLD
    _close(port, ref, f"finetune_{name}_hist", TRAJ_TOL)
    _close(port, ref, f"finetune_{name}_theta", TRAJ_TOL)


def test_finetune_on_one_axis_of_a_2x2_mesh(runs):
    """``axis='b'`` shards the candidates over two ranks of the four: the
    same history and hypers as JAX's ``finetune`` and as one device."""
    port, ref = runs
    for key in ("hist", "theta"):
        for other in (ref[f"finetune_few_{key}"],
                      port[f"finetune_few_{key}_single"]):
            assert np.max(np.abs(port[f"finetune_axis_{key}"]
                                 - other)) <= TRAJ_TOL


def test_dryrun_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's default device is the card: without one it exits
    before it spawns a rank."""
    from deepstructuredmixtures_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        dryrun.main(["--nproc", "2"])


def test_dryrun_gates(runs):
    """``parallel.dryrun.check`` in the 4 ranks: every check within 1e-8 of
    one device."""
    port, _ = runs
    errs = {k: float(v) for k, v in port.items() if k.startswith("dryrun_")}
    assert len(errs) == 7, errs
    assert max(errs.values()) <= 1e-8, errs
