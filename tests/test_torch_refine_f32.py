"""Mixed-precision refinement of float32 leaves in the port, on the CPU
(``dtype=float32`` in both packages), against the gates of
``tests/test_refine.py``: after two steps, against that file's float64
NumPy oracle, mll < 5e-6 relative, mean < 5e-6 absolute, variance < 1e-5
relative, and the float32 floor visibly beaten; the combined
``predict(refine_steps=2)`` against the float64 reference engine and
against JAX's own refined float32 output, variance < 1e-5 relative and
mean < 5e-6. The toy tree and helpers are those of
``tests/test_torch_refine.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .reference_engine import make_engine
from .test_refine import _oracle_leaf
from .test_torch_refine import XT, XT31, _jax_model, _np, _port_model, _streamed
from .torch_threads import one_torch_thread  # noqa: F401

# float32 gates of tests/test_refine.py
MLL_REL, MEAN_ABS, VAR_REL = 5e-6, 5e-6, 1e-5


@pytest.fixture(scope="module")
def f32():
    """Float32 leaves on the CPU in both packages: the port's streamed leaf
    moments with 0 and 2 steps, and both packages' combined predictions
    (unrefined and 2 steps) beside the reference engine's."""
    jm, tm = _jax_model(jnp.float32), _port_model(torch.float32)
    res = {s: _streamed(tm, s, XT, False) for s in (0, 2)}
    jm.fit(method="batched")
    jm.update()
    tm.fit()
    tm.update()
    eng = make_engine(jm)
    eng.update()
    res["engine"] = eng.predict(XT31)
    res["jax2"] = tuple(_np(a) for a in jm.predict(XT31, refine_steps=2))
    res["port0"] = tuple(_np(a) for a in tm.predict(XT31))
    res["port2"] = tuple(_np(a) for a in tm.predict(XT31, refine_steps=2))
    return tm, res



def test_f32_refined_leaves_meet_the_oracle_gates(f32):
    tm, res = f32
    err = {s: dict(mll=0.0, mu=0.0, var=0.0) for s in (0, 2)}
    for l in range(tm.num_leaves):
        mll_o, mu_o, var_o = _oracle_leaf(tm, l, XT)
        for s in (0, 2):
            mu, var, mll = (a[l] for a in res[s])
            err[s]["mll"] = max(err[s]["mll"], abs(mll - mll_o) / abs(mll_o))
            err[s]["mu"] = max(err[s]["mu"], np.max(np.abs(mu - mu_o)))
            err[s]["var"] = max(err[s]["var"],
                                np.max(np.abs(var - var_o) / np.abs(var_o)))
    assert res[2][0].dtype == np.float64 and res[0][0].dtype == np.float32
    assert err[2]["mll"] < MLL_REL, err
    assert err[2]["mu"] < MEAN_ABS, err
    assert err[2]["var"] < VAR_REL, err
    # the float32 floor is beaten, not nudged
    assert err[2]["mu"] < err[0]["mu"] / 20, err
    assert err[2]["var"] < err[0]["var"] / 20, err


@pytest.mark.parametrize("ref", ["engine", "jax2"])
def test_f32_refined_predict_meets_the_combined_gates(f32, ref):
    """The combined refined prediction against the float64 reference engine
    (on the JAX model's tree and hypers) and against JAX's refined float32
    prediction; the unrefined one is visibly worse than the engine."""
    _, res = f32
    omu, ovar = res[ref]
    m2, v2 = res["port2"]
    assert m2.dtype == v2.dtype == np.float64
    e2 = np.max(np.abs(v2 - ovar) / ovar)
    assert e2 < VAR_REL, e2
    assert np.max(np.abs(m2 - omu)) < MEAN_ABS
    if ref == "engine":
        e0 = np.max(np.abs(res["port0"][1] - ovar) / ovar)
        assert e2 < max(e0 / 20, 1e-5), (e0, e2)
