"""The JAX package's remaining public names in the port, each against the
JAX package in float64 on the CPU: ``checkpoint.save_dcp`` / ``load_dcp``
(the counterpart of ``save_orbax`` / ``load_orbax``), the six ``ops``
exports with ``masked_cholesky`` and ``cho_solve_lower``,
``leafgp.factorize`` / ``leaf_mll`` / ``leaf_predict`` and
``HyperLayout.slice_of``; and the port's examples, run in this process on
the CPU at a cut iteration count."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu.ops as jops
import deepstructuredmixtures_tpu_torch as tdsm
import deepstructuredmixtures_tpu_torch.ops as tops
from deepstructuredmixtures_tpu import leafgp as jleafgp
from deepstructuredmixtures_tpu.hyper import make_layout as j_make_layout
from deepstructuredmixtures_tpu_torch import checkpoint, convert
from deepstructuredmixtures_tpu_torch import leafgp as tleafgp
from deepstructuredmixtures_tpu_torch.hyper import make_layout

from .torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10
_rng = np.random.default_rng(2)
X = np.sort(_rng.uniform(0, 1, 300)).reshape(-1, 1)
Y = np.sin(X[:, 0] * 4 * np.pi) + _rng.normal(0, 0.2, 300)
XT = np.linspace(-0.05, 1.05, 40).reshape(-1, 1)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def pair():
    """A JAX model away from its start hypers, updated, and the port's model
    of the same data, seed and config carrying its hypers and weights."""
    kw = dict(V=2, K=3, M=20, log_noise=-1.0, seed=3, do_fit=False)
    jm = dsm.build_dsmgp(X, Y, kernel=dsm.IsoSE(0.0, 0.0), **kw)
    jm.set_params(jnp.asarray([-1.3, 0.2, -1.4]))
    jm.update()
    tm = tdsm.build_dsmgp(X, Y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu", **kw)
    convert.from_jax_arrays(tm, np.asarray(jm.theta), np.asarray(jm.logweights))
    return jm, tm, jm.predict(XT)


def test_dcp_round_trip_equals_npz_and_predicts_as_jax(pair, tmp_path):
    jm, tm, ref = pair
    checkpoint.save_dcp(tm, str(tmp_path / "dcp"))
    checkpoint.save(tm, str(tmp_path / "m.npz"))
    a = checkpoint.load_dcp(str(tmp_path / "dcp"), device="cpu")
    b = checkpoint.load(str(tmp_path / "m.npz"), device="cpu")
    assert type(a) is type(b) is type(tm)
    assert checkpoint._meta(a) == checkpoint._meta(b) == checkpoint._meta(tm)
    for k, v in checkpoint._arrays(a).items():
        np.testing.assert_array_equal(v, checkpoint._arrays(b)[k])
    assert a.theta.dtype == tm.theta.dtype
    for t, j in zip(a.predict(XT), ref):
        _close(t, j)
    # a per-leaf hyper matrix and float32 survive too
    tm32 = tdsm.build_dsmgp(X, Y, V=2, K=3, M=20, log_noise=-1.0, seed=3,
                            do_fit=False, device="cpu", dtype=torch.float32)
    tm32.set_params(np.tile(tm32.get_params(), (tm32.num_leaves, 1)))
    checkpoint.save_dcp(tm32, str(tmp_path / "dcp32"))
    c = checkpoint.load_dcp(str(tmp_path / "dcp32"), device="cpu")
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(_np(c.theta), _np(tm32.theta))


def test_ops_exports_match_jax():
    assert tops.__all__ == jops.__all__
    rng = np.random.default_rng(4)
    A = rng.standard_normal((3, 7, 7))
    K = A @ A.transpose(0, 2, 1) + 7 * np.eye(7)
    mask = np.arange(7)[None, :] < np.array([7, 5, 2])[:, None]
    Lt = tops.masked_cholesky(torch.as_tensor(K), torch.as_tensor(mask))
    Lj = jops.masked_cholesky(jnp.asarray(K), jnp.asarray(mask))
    _close(Lt, Lj)
    y = rng.standard_normal((3, 7))
    _close(tops.cho_solve_lower(Lt, torch.as_tensor(y)),
           jops.cho_solve_lower(Lj, jnp.asarray(y)))
    _close(tops.masked_logdet(Lt, torch.as_tensor(mask)),
           jops.masked_logdet(Lj, jnp.asarray(mask)))
    noise = np.array([0.1, 0.2, 0.3])
    _close(tops.masked_gram_noise(torch.as_tensor(K), torch.as_tensor(mask),
                                  torch.as_tensor(noise), 1e-8),
           jops.masked_gram_noise(jnp.asarray(K), jnp.asarray(mask),
                                  jnp.asarray(noise), 1e-8))
    for name in ("givens_delete_rows", "chol_continue"):
        assert callable(getattr(tops, name))


def test_leafgp_factorize_mll_predict_match_jax(pair):
    """On the first four leaves of the monolithic batch."""
    jm, tm, _ = pair
    jb = type(jm.batch)(*(a[:4] for a in jm.batch))
    tb = tm.batch.rows(0, 4)
    # one jitted program each (op-by-op dispatch is slow under load)
    factorize = jax.jit(jleafgp.factorize, static_argnums=0)
    leaf_predict = jax.jit(jleafgp.leaf_predict, static_argnums=0)
    jpost = factorize(jm.layout, jm.theta, jb)
    tpost = tleafgp.factorize(tm.layout, tm.theta, tb)
    for t, j in zip(tpost, jpost):
        _close(t, j)
    yc = tleafgp.centered_y(tb)
    _close(tleafgp.leaf_mll(tpost.chol, yc, tpost.alpha, tb), jpost.mll)
    for t, j in zip(tleafgp.leaf_predict(tm.layout, tm.theta, tb, tpost,
                                         torch.as_tensor(XT)),
                    leaf_predict(jm.layout, jm.theta, jb, jpost,
                                 jnp.asarray(XT))):
        _close(t, j)


def test_hyper_layout_slice_of_matches_jax():
    tk = (tdsm.IsoSE(0.0, 0.0), tdsm.ArdSE([0.0] * 3, 0.0), tdsm.IsoLinear(0.0))
    jk = (dsm.IsoSE(0.0, 0.0), dsm.ArdSE([0.0] * 3, 0.0), dsm.IsoLinear(0.0))
    t, j = make_layout(tk), j_make_layout(jk)
    assert [t.slice_of(k) for k in range(3)] == [j.slice_of(k) for k in range(3)]
    assert t.slice_of(2)[1] == t.total


def _example(name, argv, capsys):
    main = runpy.run_path(os.path.join(REPO, "examples", name),
                          run_name="example")["main"]
    main(argv)
    return capsys.readouterr().out


def test_examples_run_on_the_cpu(capsys):
    """The README workflow and the nonstationary comparison with
    ``--device cpu`` at a cut iteration count: the table holds a finite
    RMSE, MAE and NLPD for each of the four models."""
    out = _example("torch_readme_workflow.py", ["--device", "cpu",
                                                "--iterations", "3"], capsys)
    assert "trained 3 iters" in out and "predictive mean range" in out
    out = _example("torch_nonstationary_comparison.py",
                   ["--device", "cpu", "--iterations", "3"], capsys)
    rows = {line.split()[0]: line.split()[1:] for line in out.splitlines()[1:]}
    assert sorted(rows) == ["DSMGP", "PoE", "gPoE", "rBCM"]
    for vals in rows.values():
        assert len(vals) == 3 and np.isfinite([float(v) for v in vals]).all()
