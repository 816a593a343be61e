"""The port's fit → update → routed-predict path against the JAX package,
end to end in float64 on the CPU.

Both build the headline model (V=3, K=4, M=30, depth 2, IsoSE(0, 0), log
noise -1, seed 0) on N=2000 points, where every size bucket is in the
fused kernel's domain (so on the card the port would run it; here its
plain path runs). The port's model takes the JAX model's hypers through
``convert.from_jax_arrays``. Root log evidence, sum weights and the routed
predictive mean and variance must agree to 1e-10 relative.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import convert
from deepstructuredmixtures_tpu_torch.ops import fused_chol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


def _data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, n)
    return x, y


@pytest.fixture(scope="module")
def runs():
    x, y = _data()
    xt = np.linspace(-0.05, 1.05, 400).reshape(-1, 1)
    common = dict(V=3, K=4, M=30, log_noise=-1.0, seed=0, do_fit=False)
    jm = dsm.build_dsmgp(x, y, kernel=dsm.IsoSE(0.0, 0.0), overlap=False, **common)
    jm.fit(store="light", cache_alpha=False)
    jres = dict(mll=jm.mll(), leaf=np.asarray(jm.leaf_mlls()), z=jm.update(),
                lw=np.asarray(jm.logweights))
    jres["mean"], jres["var"] = (np.asarray(a) for a in jm.predict(xt))

    tm = tdsm.build_dsmgp(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu", **common)
    convert.from_jax_arrays(tm, np.asarray(jm.theta))
    tm.fit(store="light")
    tres = dict(mll=tm.mll(), leaf=tm.leaf_mlls().numpy(), z=tm.update(),
                lw=tm.logweights.numpy())
    mean, var = tm.predict(xt)
    tres["mean"], tres["var"] = mean.numpy(), var.numpy()
    return jm, tm, jres, tres


def test_every_bucket_in_kernel_domain(runs):
    jm, tm, _, _ = runs
    for nmax in tm.bucket_spec.nmaxs:
        assert fused_chol.supported(nmax, torch.float32, tm.layout.kinds, "cuda")
        assert not fused_chol.supported(nmax, tm.dtype, tm.layout.kinds, tm.device)
    assert fused_chol.LAUNCHES == 0


def test_leaf_and_root_mll_match(runs):
    _, _, j, t = runs
    np.testing.assert_allclose(t["leaf"], j["leaf"], rtol=RTOL)
    np.testing.assert_allclose(t["mll"], j["mll"], rtol=RTOL)


def test_update_matches(runs):
    _, tm, j, t = runs
    np.testing.assert_allclose(t["z"], j["z"], rtol=RTOL)
    assert tm.logweights.dtype == torch.float64
    np.testing.assert_allclose(t["lw"], j["lw"], rtol=RTOL, atol=1e-12)


def test_predict_matches(runs):
    _, _, j, t = runs
    assert t["mean"].shape == j["mean"].shape == (400,)
    np.testing.assert_allclose(t["mean"], j["mean"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(t["var"], j["var"], rtol=RTOL)


@pytest.fixture(scope="module")
def runs_depth3():
    """The same pipeline on a depth-3 tree (N=1500: 961 leaves of at most
    128 rows, all in one bucket of the fused kernel's domain): per side the
    root mll, sum weights and routed moments at 300 test points."""
    x, y = _data(n=1500)
    xt = np.linspace(-0.05, 1.05, 300).reshape(-1, 1)
    common = dict(V=3, K=4, M=30, log_noise=-1.0, seed=0, do_fit=False, depth=3)
    jm = dsm.build_dsmgp(x, y, kernel=dsm.IsoSE(0.0, 0.0), overlap=False, **common)
    jm.fit(store="light", cache_alpha=False)
    jres = dict(mll=jm.mll(), z=jm.update(), weights=np.asarray(jm.logweights))
    jres["mean"], jres["var"] = (np.asarray(a) for a in jm.predict(xt))
    tm = tdsm.build_dsmgp(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu", **common)
    convert.from_jax_arrays(tm, np.asarray(jm.theta))
    tm.fit(store="light")
    tres = dict(mll=tm.mll(), z=tm.update(), weights=tm.logweights.numpy())
    mean, var = tm.predict(xt)
    tres["mean"], tres["var"] = mean.numpy(), var.numpy()
    assert tm.num_leaves == jm.num_leaves > 900
    return jres, tres


@pytest.mark.parametrize("what", ["mll", "z", "weights", "mean", "var"])
def test_depth3_slice_matches(runs_depth3, what):
    j, t = runs_depth3
    np.testing.assert_allclose(t[what], j[what], rtol=RTOL, atol=1e-12)


def test_from_jax_arrays_loads_logweights(runs):
    jm, tm, j, t = runs
    x, y = _data()
    fresh = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cpu", do_fit=False)
    convert.from_jax_arrays(fresh, np.asarray(jm.theta), np.asarray(jm.logweights))
    fresh.fit(store="light")
    xt = np.linspace(0.2, 0.3, 5)
    mean_j, var_j = (np.asarray(a) for a in jm.predict(xt))
    mean_t, var_t = (a.numpy() for a in fresh.predict(xt))
    np.testing.assert_allclose(mean_t, mean_j, rtol=RTOL)
    np.testing.assert_allclose(var_t, var_j, rtol=RTOL)
    with pytest.raises(ValueError):
        convert.from_jax_arrays(fresh, np.zeros(5))


@pytest.mark.parametrize("call", [
    lambda m: m.fit(mesh=object()),
    lambda m: tdsm.GaussianProcess(m.X, m.y, device="cpu").fit(mesh=object()),
], ids=["mesh", "gp_mesh"])
def test_later_options_raise(runs, call):
    """``mesh`` takes a ``DeviceMesh`` and refuses anything else
    (``tests/test_torch_mesh.py`` runs both on one)."""
    _, tm, _, _ = runs
    with pytest.raises(TypeError, match="DeviceMesh"):
        call(tm)


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "import deepstructuredmixtures_tpu_torch as t\n"
        "from deepstructuredmixtures_tpu_torch import checkpoint, serve\n"
        "from deepstructuredmixtures_tpu_torch import datasets, gp, introspect\n"
        "from deepstructuredmixtures_tpu_torch import metrics, plotting\n"
        "from deepstructuredmixtures_tpu_torch.ops import potrf, refine\n"
        "from deepstructuredmixtures_tpu_torch.utils import profiling\n"
        "x = np.linspace(0, 1, 200); y = np.sin(6 * x)\n"
        "m = t.build_dsmgp(x, y, M=20, device='cpu', seed=1)\n"
        "m.update(); m.predict(np.linspace(0, 1, 9))\n"
        "m.predict(np.linspace(0, 1, 9), refine_steps=1)\n"
        "t.GaussianProcess(x, y, device='cpu').fit().predict(x[:5])\n"
        "t.left_gp(m).mll(); t.get_log_noise(m, x[:3])\n"
        "m.fit(store='hybrid'); m.predict(np.linspace(0, 1, 9))\n"
        "assert all(f is not None for f in m._bucket_factors)\n"
        "m = t.build_dsmgp(x, y, M=20, device='cpu', seed=1, overlap=True)\n"
        "assert m.posterior is not None and m.schedule is not None\n"
        "m.fit(store='full'); m.fit(method='shared'); m.update()\n"
        "m.predict(np.linspace(0, 1, 9))\n"
        "t.train(m, iterations=2, randinit=False)\n"
        "t.finetune(m, iterations=1); m.predict(np.linspace(0, 1, 9))\n"
        "t.train_gp(t.GaussianProcess(x, y, device='cpu'), iterations=2,"
        " randinit=False)\n"
        "import os, tempfile, torch.distributed as dist\n"
        "from deepstructuredmixtures_tpu_torch import leafgp, ops\n"
        "g = t.build_dsmgp(x, y, M=20, device='cpu', seed=1, do_fit=False)\n"
        "b = g.batch.rows(0, 2)\n"
        "post = leafgp.factorize(g.layout, g.theta, b)\n"
        "leafgp.leaf_predict(g.layout, g.theta, b, post, b.x[0, :3])\n"
        "ops.cho_solve_lower(post.chol, b.y)\n"
        "d = os.path.join(tempfile.mkdtemp(), 'dcp')\n"
        "checkpoint.save_dcp(m, d); checkpoint.load_dcp(d, device='cpu')\n"
        "for build in (t.build_poe, t.build_bcm):\n"
        "    p = build(x, y, M=20, device='cpu', seed=1)\n"
        "    p.fit_naive(); p.predict(np.linspace(0, 1, 9))\n"
        "k = [t.IsoSE(0.0, 0.0), t.ArdSE([0.0], 0.0), t.IsoLinear(0.0)]\n"
        "m = t.build_dsmgp(x, y, M=20, kernel=k, device='cpu', seed=1,"
        " overlap_format='sparse')\n"
        "t.finetune(m, iterations=1, leaves=[0], bucketed=True)\n"
        "from deepstructuredmixtures_tpu_torch import parallel\n"
        "from deepstructuredmixtures_tpu_torch.parallel import dryrun\n"
        "store = os.path.join(tempfile.mkdtemp(), 'store')\n"
        "dist.init_process_group('gloo', init_method='file://' + store,"
        " rank=0, world_size=1)\n"
        "mesh = parallel.make_mesh()\n"
        "m = t.build_dsmgp(x, y, M=20, device='cpu', seed=1, do_fit=False)\n"
        "m.fit(mesh=mesh, giant_leaf_bytes=1, block=64); m.update()\n"
        "assert m.last_fit_diagnostics['distributed_leaves'] == m.num_leaves\n"
        "m.predict(np.linspace(0, 1, 9))\n"
        "t.GaussianProcess(x, y, device='cpu').fit(mesh=mesh).predict(x[:5])\n"
        "dist.destroy_process_group()\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('deepstructuredmixtures_tpu.')"
        " or k == 'deepstructuredmixtures_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
