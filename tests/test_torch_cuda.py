"""The fused gram+Cholesky CUDA kernel against its plain PyTorch version,
on the card. Skips without a CUDA device (the kernel has no CPU mode).

This file imports no JAX, so it also runs where JAX is not installed, as
on the GPU machine:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from deepstructuredmixtures_tpu_torch.ops import fused_chol

TOL = 5e-4  # max abs factor error, the bound of tests/test_pallas_chol.py


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
