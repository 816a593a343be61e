"""The port's leaf-GP math against the JAX package in float64 on the CPU:
kernels (all four kinds), masked noise, leaf mlls and the streamed
fit+predict of one bucket. Inputs come from a NumPy seed and cross as
NumPy arrays. Tolerances: rtol 1e-12 for single expressions, 1e-10 where
a Cholesky and solves sit in between (LAPACK in both, called through
different wrappers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepstructuredmixtures_tpu as dsm
from deepstructuredmixtures_tpu import fit as jfit
from deepstructuredmixtures_tpu import hyper as jhyper
from deepstructuredmixtures_tpu import kernels as jkern
from deepstructuredmixtures_tpu import leafgp as jleaf
from deepstructuredmixtures_tpu.ops import cholesky as jchol

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch import hyper as thyper
from deepstructuredmixtures_tpu_torch import kernels as tkern
from deepstructuredmixtures_tpu_torch import leafgp as tleaf
from deepstructuredmixtures_tpu_torch.ops import cholesky as tchol

KINDS = ("iso_se", "ard_se", "iso_linear", "ard_linear")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _hypers(kind, d, rng):
    nl = d if kind.startswith("ard") else 1
    return rng.uniform(-0.5, 0.5, nl), float(rng.uniform(-0.3, 0.3))


@pytest.mark.parametrize("kind", KINDS)
def test_gram_and_diag_match_jax(kind):
    rng = np.random.default_rng(1)
    d = 3
    x1 = rng.uniform(-1, 1, (30, d))
    x2 = rng.uniform(-1, 1, (20, d))
    logl, logsigma = _hypers(kind, d, rng)
    ref = np.asarray(jkern.gram(kind, jnp.asarray(logl), jnp.asarray(logsigma),
                                jnp.asarray(x1), jnp.asarray(x2)))
    got = tkern.gram(kind, _t(logl), _t(logsigma), _t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    dref = np.asarray(jkern.gram_diag(kind, jnp.asarray(logl),
                                      jnp.asarray(logsigma), jnp.asarray(x1)))
    dgot = tkern.gram_diag(kind, _t(logl), _t(logsigma), _t(x1)).numpy()
    np.testing.assert_allclose(dgot, dref, rtol=1e-12, atol=1e-14)


def _mixture_batch(rng, L=4, N=16, d=2):
    """A hand-made padded batch of a two-kernel mixture."""
    n = np.array([16, 9, 12, 5], np.int32)[:L]
    mask = np.arange(N)[None, :] < n[:, None]
    x = np.where(mask[..., None], rng.uniform(0, 1, (L, N, d)), 0.0)
    y = np.where(mask, rng.normal(size=(L, N)), 0.0)
    arrays = dict(x=x, y=y, mask=mask, n=n, mean=rng.normal(size=L),
                  kernelid=np.array([0, 1, 0, 1], np.int32)[:L])
    jb = jleaf.LeafBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = tleaf.LeafBatch(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in arrays.items()})
    return jb, tb


@pytest.mark.parametrize("per_leaf", [False, True])
def test_leaf_gram_noise_and_mll_match_jax(per_leaf):
    rng = np.random.default_rng(2)
    jb, tb = _mixture_batch(rng)
    specs_j = [dsm.ArdSE([0.1, -0.2], 0.3), dsm.IsoLinear(0.2)]
    specs_t = [tdsm.ArdSE([0.1, -0.2], 0.3), tdsm.IsoLinear(0.2)]
    lj, lt = jhyper.make_layout(specs_j), thyper.make_layout(specs_t)
    assert lj == lt
    theta = jhyper.initial_vector(specs_j, -1.0)
    if per_leaf:
        theta = theta[None] + rng.uniform(-0.2, 0.2, (jb.num_leaves, theta.size))
    thj, tht = jnp.asarray(theta), _t(theta)
    xt = rng.uniform(0, 1, (7, 2))

    K = np.asarray(jleaf.leaf_gram(lj, thj, jb))
    np.testing.assert_allclose(tleaf.leaf_gram(lt, tht, tb).numpy(), K,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tleaf.leaf_gram(lt, tht, tb, _t(xt)).numpy(),
        np.asarray(jleaf.leaf_gram(lj, thj, jb, jnp.asarray(xt))),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tleaf.leaf_gram_diag(lt, tht, tb, _t(xt)).numpy(),
        np.asarray(jleaf.leaf_gram_diag(lj, thj, jb, jnp.asarray(xt))),
        rtol=1e-12)
    noise_j = jleaf.leaf_noise(lj, thj, jb)
    noise_t = tleaf.leaf_noise(lt, tht, tb)
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j), rtol=1e-12)

    Kn_j = jchol.masked_gram_noise(jnp.asarray(K), jb.mask, noise_j, 1e-8)
    Kn_t = tchol.masked_gram_noise(_t(K), tb.mask, noise_t, 1e-8)
    np.testing.assert_allclose(Kn_t.numpy(), np.asarray(Kn_j), rtol=1e-12)

    Lf_j = jchol.cholesky_nosym(Kn_j)
    yc = jleaf.centered_y(jb)
    np.testing.assert_allclose(tleaf.centered_y(tb).numpy(), np.asarray(yc),
                               rtol=1e-12)
    z_j = jchol.solve_lower(Lf_j, yc[..., None])[..., 0]
    mll_j = np.asarray(jleaf.leaf_mll_forward(Lf_j, z_j, jb))
    Lf_t = tchol.cholesky_nosym(Kn_t)
    np.testing.assert_allclose(Lf_t.numpy(), np.asarray(Lf_j), rtol=1e-10,
                               atol=1e-13)
    z_t = tchol.solve_lower(Lf_t, tleaf.centered_y(tb)[..., None])[..., 0]
    np.testing.assert_allclose(tleaf.leaf_mll_forward(Lf_t, z_t, tb).numpy(),
                               mll_j, rtol=1e-10)


@pytest.fixture(scope="module")
def bucket_models():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 1.0, 2000)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, 2000)
    common = dict(V=3, K=4, M=30, log_noise=-1.0, seed=0, do_fit=False)
    jm = dsm.build_dsmgp(x, y, kernel=dsm.IsoSE(0.0, 0.0), overlap=False, **common)
    tm = tdsm.build_dsmgp(x, y, kernel=tdsm.IsoSE(0.0, 0.0), device="cpu", **common)
    return jm, tm


@pytest.mark.parametrize("per_leaf", [False, True])
def test_streamed_leaf_predict_one_bucket_matches_jax(bucket_models, per_leaf):
    jm, tm = bucket_models
    k = 1  # a middle bucket; chunk 3 leaves a short last chunk
    jb, tb = jm.bucket_batches[k], tm.bucket_batches[k]
    theta = np.asarray(jm.theta)
    if per_leaf:
        theta = theta[None] + np.linspace(-0.2, 0.2, jb.num_leaves)[:, None]
    xt = np.linspace(-0.05, 1.05, 300).reshape(-1, 1)
    tidx, tmask = jm._route(xt)
    ids = jm.bucket_spec.leaf_ids[k]
    mu_j, var_j, mll_j = jfit.streamed_leaf_predict(
        jm.layout, jnp.asarray(theta), jb, jnp.asarray(xt),
        jnp.asarray(tidx[ids]), jnp.asarray(tmask[ids]), chunk=3)
    mu_t, var_t, mll_t = tfit.streamed_leaf_predict(
        tm.layout, _t(theta), tb, _t(xt),
        torch.as_tensor(tidx[ids], dtype=torch.long), chunk=3)
    m = tmask[ids]
    np.testing.assert_allclose(mll_t.numpy(), np.asarray(mll_j), rtol=1e-10)
    np.testing.assert_allclose(mu_t.numpy()[m], np.asarray(mu_j)[m], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(var_t.numpy()[m], np.asarray(var_j)[m], rtol=1e-10)
    light = tfit.fit_light(tm.layout, _t(theta), tb, chunk=3)
    np.testing.assert_allclose(light.numpy(), np.asarray(mll_j), rtol=1e-10)
