"""The CUDA kernels (fused gram+Cholesky, blocked Cholesky) against their
plain PyTorch versions and float64, on the card. Skips without a CUDA
device (a kernel has no CPU mode).

This file imports no JAX, so it also runs where JAX is not installed, as
on the GPU machine:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

TOL = 5e-4  # max abs factor error, the bound of tests/test_pallas_chol.py
POTRF_TOL = 5e-4  # the bound of tests/test_pallas_potrf.py


def kernel_inputs(L, N, tied, seed):
    """A leaf batch ``(x, n, logl, logsigma, noise)`` of NumPy arrays in
    float32: sorted 1-D inputs in [0, 1], leaf 0 full, the rest padded."""
    rng = np.random.default_rng(seed)
    n = rng.integers(N // 2, N + 1, L).astype(np.int32)
    n[0] = N
    x = np.zeros((L, N, 1), np.float32)
    for l in range(L):
        x[l, : n[l], 0] = np.sort(rng.uniform(0.0, 1.0, n[l]))
    if tied:
        logl = np.full(L, -0.5, np.float32)
        logsigma = np.full(L, 0.2, np.float32)
        noise = np.full(L, 0.05, np.float32)
    else:
        logl = np.linspace(-0.8, 0.1, L).astype(np.float32)
        logsigma = np.linspace(-0.2, 0.4, L).astype(np.float32)
        noise = np.linspace(0.03, 0.2, L).astype(np.float32)
    return x, n, logl, logsigma, noise


def check_contract(out, n):
    """Identity on the padded block, zero padded rows, zero upper triangle."""
    N = out.shape[-1]
    for l, k in enumerate(n):
        np.testing.assert_array_equal(out[l, k:, k:], np.eye(N - k))
        assert not out[l, k:, :k].any()
    assert not np.triu(out, 1).any()


def spd_batch(g, n, seed=0, noise=0.3):
    """``(A [g, n, n] float32, valid)``: IsoSE grams of sorted uniform
    points (lengthscale² 0.02, noise 0.3, as ``tests/test_pallas_potrf.py``
    makes them); for ``g > 1`` the last matrix is identity-padded beyond
    ``valid = n - n // 4`` rows."""
    rng = np.random.default_rng(seed)
    out = np.zeros((g, n, n), np.float32)
    valid = n - (n // 4 if g > 1 else 0)
    for l in range(g):
        nv = n if l < g - 1 else valid
        x = np.sort(rng.uniform(0, 1, nv))
        d2 = (x[:, None] - x[None, :]) ** 2
        out[l, :nv, :nv] = np.exp(-0.5 * d2 / 0.02) + noise * np.eye(nv)
        out[l, range(nv, n), range(nv, n)] = 1.0
    return out, valid


def check_potrf_contract(out, valid):
    """Zero strict upper triangle; the last matrix's identity padding kept
    exactly."""
    n = out.shape[-1]
    assert not np.triu(out, 1).any()
    np.testing.assert_array_equal(out[-1, valid:, valid:], np.eye(n - valid))
    assert not out[-1, valid:, :valid].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "per-leaf"])
@pytest.mark.parametrize("L,N", [(4, 256), (3, 640)])
def test_cuda_kernel_matches_plain(cuda_device, L, N, tied):
    arrays = kernel_inputs(L, N, tied, seed=N)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    before = fused_chol.LAUNCHES
    out = fused_chol.fused_gram_cholesky(*args)
    torch.cuda.synchronize()
    assert fused_chol.LAUNCHES == before + 1
    ref64 = fused_chol.fused_gram_cholesky_reference(
        *(a.double() if a.is_floating_point() else a for a in args))
    n = arrays[1]
    out_np, ref_np = out.cpu().numpy(), ref64.cpu().numpy()
    check_contract(out_np, n)
    for l in range(L):
        k = n[l]
        assert np.abs(out_np[l, :k, :k] - ref_np[l, :k, :k]).max() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "per-leaf"])
@pytest.mark.parametrize("L,N", [(300, 128), (64, 512), (16, 1024), (5, 640),
                                 (133, 256), (67, 384)])
def test_cuda_kernel_launch_plans(cuda_device, L, N, tied):
    """The kernel in each regime of its launch plan (one block per leaf
    when the leaves fill the card, clusters of 2-8 otherwise; L = 5 and
    67 fill no whole number of waves) against the plain version and
    float64, with ragged valid sizes down to one row and one tile."""
    arrays = kernel_inputs(L, N, tied, seed=L + N)
    x, n = arrays[0], arrays[1]
    n[1:4] = [1, 64, 65]
    x[1:4] = 0.0
    rng = np.random.default_rng(N)
    for l in range(1, 4):
        x[l, : n[l], 0] = np.sort(rng.uniform(0.0, 1.0, n[l]))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    plan = fused_chol.launch_plan(L, N, fused_chol.device_info(cuda_device)[0])
    assert plan.grid == L * plan.blocks_per_leaf
    out = fused_chol.fused_gram_cholesky(*args)
    torch.cuda.synchronize()
    plain = fused_chol.fused_gram_cholesky_reference(*args).cpu().numpy()
    ref64 = fused_chol.fused_gram_cholesky_reference(
        *(a.double() if a.is_floating_point() else a for a in args)).cpu().numpy()
    out = out.cpu().numpy()
    check_contract(out, n)
    err = max(np.abs(out[l, :k, :k] - ref64[l, :k, :k]).max() for l, k in enumerate(n))
    plain_err = max(np.abs(plain[l, :k, :k] - ref64[l, :k, :k]).max()
                    for l, k in enumerate(n))
    # the bounds of chip_smoke.py's phase 2
    assert err < TOL and err <= 4 * plain_err, (err, plain_err)


@pytest.mark.cuda
def test_cuda_kernel_not_positive_definite(cuda_device):
    """A leaf whose gram is not positive definite (negative noise: the
    first pivot is negative) comes back non-finite without raising, as
    from the plain version; the other leaves match the plain version."""
    x, n, logl, logsigma, noise = kernel_inputs(3, 256, False, 9)
    noise[1] = -2.0 * np.exp(2 * logsigma[1])
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (x, n, logl, logsigma, noise)]
    out = fused_chol.fused_gram_cholesky(*args)
    torch.cuda.synchronize()
    plain = fused_chol.fused_gram_cholesky_reference(*args)
    assert not torch.isfinite(out[1]).all()
    assert not torch.isfinite(plain[1]).all()
    for l in (0, 2):
        assert (out[l] - plain[l]).abs().max().item() < TOL


@pytest.mark.cuda
def test_cuda_kernel_info(cuda_device):
    """The shared memory the launch plan assumes is the compiled kernel's,
    and two of its blocks fit on an SM."""
    sms, per_sm, smem = fused_chol.device_info(cuda_device)
    assert smem == fused_chol.SMEM_BYTES <= fused_chol.SMEM_LIMIT
    assert sms > 0 and per_sm >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(3, 200), (2, 1040), (1, 2048), (1, 257),
                                 (2, 300), (1, 520), (3, 256), (1, 37),
                                 (2, 1030), (1, 1290)])
def test_cuda_blocked_cholesky_matches_plain(cuda_device, g, n):
    A, valid = spd_batch(g, n, seed=n)
    a = torch.from_numpy(A).to(cuda_device)
    plain = potrf.blocked_cholesky_reference(a).cpu().numpy()
    before = potrf.LAUNCHES
    out = potrf.blocked_cholesky(a.clone())
    torch.cuda.synchronize()
    assert potrf.LAUNCHES == before + 1
    out = out.cpu().numpy()
    check_potrf_contract(out, valid)
    for l in range(g):
        ref = np.linalg.cholesky(A[l].astype(np.float64))
        assert np.abs(out[l] - ref).max() < POTRF_TOL
    assert np.abs(out - plain).max() < POTRF_TOL
    with pytest.raises(TypeError):
        potrf.blocked_cholesky(a.double())


@pytest.mark.cuda
def test_cuda_blocked_cholesky_not_positive_definite(cuda_device):
    """A negative pivot in the second outer panel poisons that matrix, and
    only that matrix, without raising."""
    A, valid = spd_batch(3, 600, seed=5)
    A[1, 300, 300] = -1.0
    out = potrf.blocked_cholesky(torch.from_numpy(A).to(cuda_device))
    torch.cuda.synchronize()
    assert not torch.isfinite(out[1]).all()
    assert not torch.isfinite(out[1, -1, -1])  # it reached the last pivot
    for g in (0, 2):
        ref = np.linalg.cholesky(A[g].astype(np.float64))
        assert np.abs(out[g].cpu().numpy() - ref).max() < POTRF_TOL
    check_potrf_contract(out[[0, 2]].cpu().numpy(), valid)


@pytest.mark.cuda
def test_cuda_refined_predict_matches_cpu_float64(cuda_device):
    """``predict(refine_steps=1)`` of a float32 model on the card (its
    buckets factored by the fused kernel) against the float64 model on the
    CPU, under the same sum weights: the bounds of ``tests/test_refine.py``
    (mean 5e-6 absolute, variance 1e-5 relative), where the unrefined
    float32 prediction misses them."""
    import deepstructuredmixtures_tpu_torch as tdsm

    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 1.0, 1200)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 5 * np.pi) + rng.normal(0.0, 0.3, 1200)
    xt = np.linspace(0.02, 0.98, 31).reshape(-1, 1)
    kw = dict(V=2, K=2, M=60, kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-3.0,
              seed=3)
    ref = tdsm.build_dsmgp(x, y, device="cpu", **kw)
    ref.update()
    m = tdsm.build_dsmgp(x, y, device=cuda_device, **kw)
    m.logweights = ref.logweights.to(cuda_device)
    mean64, var64 = (a.numpy() for a in ref.predict(xt, refine_steps=1))
    before = fused_chol.LAUNCHES
    mean, var = (a.cpu().numpy() for a in m.predict(xt, refine_steps=1))
    assert fused_chol.LAUNCHES > before
    assert mean.dtype == var.dtype == np.float64
    assert np.abs(mean - mean64).max() < 5e-6
    assert (np.abs(var - var64) / var64).max() < 1e-5
    mean0 = m.predict(xt)[0].cpu().numpy()
    assert np.abs(mean0 - mean64).max() > np.abs(mean - mean64).max()


@pytest.mark.cuda
def test_cuda_training_gradient_launches_no_fused_kernel(cuda_device):
    """The training gradient of a float32 model on the card, whose buckets
    are in the fused kernel's domain, launches no fused kernel (it has no
    backward; the objective factors with ``torch.linalg``) and matches the
    float64 gradient on the card: value within 1e-3, gradient within 1e-2
    relative in norm (the bounds of ``chip_smoke.py``'s training phase)."""
    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.train import _train_vg

    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 1.0, 1200)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 5 * np.pi) + rng.normal(0.0, 0.3, 1200)
    out = {}
    for dtype in (torch.float32, torch.float64):
        m = tdsm.build_dsmgp(x, y, V=2, K=2, M=60, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=3, device=cuda_device,
                             dtype=dtype, do_fit=False, overlap=False)
        before = fused_chol.LAUNCHES
        val, g = _train_vg(m)(m.theta)
        torch.cuda.synchronize()
        assert fused_chol.LAUNCHES == before
        out[dtype] = (float(val), g.double().cpu().numpy())
    assert any(fused_chol.supported(b.nmax, torch.float32, m.layout.kinds,
                                    cuda_device) for b in m.bucket_batches)
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert abs(v32 - v64) <= 1e-3 * abs(v64)
    assert np.linalg.norm(g32 - g64) <= 1e-2 * np.linalg.norm(g64)


@pytest.mark.cuda
def test_cuda_mesh_world_of_one_nccl(cuda_device, tmp_path):
    """``fit(mesh=...)`` in a world of one rank under NCCL (the backend of a
    multi-card host, ``all_gather_into_tensor``): the largest bucket's
    leaves on the distributed Cholesky, the others through the fused
    kernel in float32; float64 within 1e-8 of the unsharded fit, float32
    within the float32 bounds of ``chip_smoke.py`` of it."""
    import torch.distributed as dist

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch import parallel

    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 1.0, 3000)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, 3000)
    xt = np.linspace(-0.05, 1.05, 200)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        out = {}
        for dtype in (torch.float64, torch.float32):
            m = tdsm.build_dsmgp(x, y, V=3, K=4, M=30,
                                 kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0,
                                 seed=0, device=cuda_device, dtype=dtype,
                                 do_fit=False, overlap=False)
            nmaxs = sorted(m.bucket_spec.nmaxs)
            before = fused_chol.LAUNCHES, potrf.LAUNCHES
            m.fit(mesh=mesh, block=128,
                  giant_leaf_bytes=nmaxs[-2] ** 2 * dtype.itemsize)
            z = m.update()
            mean, var = m.predict(xt)
            torch.cuda.synchronize()
            assert m.last_fit_diagnostics["distributed_leaves"] >= 1
            launched = (fused_chol.LAUNCHES - before[0],
                        potrf.LAUNCHES - before[1])
            m.fit(store="light")
            out[dtype] = dict(z=z, mean=mean.double().cpu().numpy(),
                              var=var.double().cpu().numpy(),
                              z1=m.update(), launched=launched)
            if dtype == torch.float64:
                mean1, var1 = (a.cpu().numpy() for a in m.predict(xt))
        r64, r32 = out[torch.float64], out[torch.float32]
        assert abs(r64["z"] - r64["z1"]) <= 1e-8 * abs(r64["z1"])
        assert np.abs(r64["mean"] - mean1).max() <= 1e-8
        assert np.abs(r64["var"] - var1).max() <= 1e-8
        assert abs(r32["z"] - r64["z1"]) <= 1e-3 * abs(r64["z1"])
        assert np.abs(r32["mean"] - mean1).max() <= 5e-3
        assert (np.abs(r32["var"] - var1) / var1).max() <= 1e-3
        assert r32["launched"][0] > 0 and r32["launched"][1] == 0
    finally:
        dist.destroy_process_group()
