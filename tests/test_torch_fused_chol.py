"""The fused gram+Cholesky op of the port against the JAX package's Pallas
kernel (run in the Pallas interpreter, as ``tests/test_pallas_chol.py``
runs it) and a float64 oracle, in float32.

On the CPU the port's wrapper runs its plain PyTorch version, so these
tests hold that version to the Pallas kernel; the CUDA kernel itself is
held to the same plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepstructuredmixtures_tpu.ops import pallas_chol

import deepstructuredmixtures_tpu_torch  # noqa: F401  (sets the TF32 flags)
from deepstructuredmixtures_tpu_torch.kernels import gram
from deepstructuredmixtures_tpu_torch.ops import fused_chol

from .test_torch_cuda import TOL, check_contract, kernel_inputs


def _oracle(xl, logl, logsigma, noise, eps=1e-8):
    xl = torch.from_numpy(xl.astype(np.float64))
    K = gram("iso_se", torch.tensor([float(logl)], dtype=torch.float64),
             torch.tensor(float(logsigma), dtype=torch.float64), xl, xl)
    K = K + (float(noise) + eps) * torch.eye(len(xl), dtype=torch.float64)
    return np.linalg.cholesky(K.numpy())


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "per-leaf"])
@pytest.mark.parametrize("N", [128, 384])
def test_plain_matches_pallas_and_oracle(N, tied):
    L = 3
    x, n, logl, logsigma, noise = kernel_inputs(L, N, tied, seed=N)
    pallas = np.asarray(pallas_chol.fused_gram_cholesky(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(logl),
        jnp.asarray(logsigma), jnp.asarray(noise), interpret=True))
    before = fused_chol.LAUNCHES
    out = fused_chol.fused_gram_cholesky(*(torch.from_numpy(a) for a in
                                           (x, n, logl, logsigma, noise)))
    assert fused_chol.LAUNCHES == before == 0  # the CPU never launches
    assert out.dtype == torch.float32 and out.shape == (L, N, N)
    out = out.numpy()
    check_contract(out, n)
    for l in range(L):
        k = n[l]
        ref = _oracle(x[l, :k], logl[l], logsigma[l], noise[l])
        assert np.abs(out[l, :k, :k] - ref).max() < TOL
        assert np.abs(pallas[l, :k, :k] - ref).max() < TOL
        assert np.abs(out[l, :k, :k] - pallas[l, :k, :k]).max() < TOL


def test_supported_gates():
    kinds = ("iso_se",)
    assert fused_chol.supported(256, torch.float32, kinds, "cuda")
    assert fused_chol.supported(1024, torch.float32, kinds, torch.device("cuda", 0))
    assert not fused_chol.supported(256, torch.float32, kinds, "cpu")  # CPU
    assert not fused_chol.supported(100, torch.float32, kinds, "cuda")  # not /128
    assert not fused_chol.supported(1152, torch.float32, kinds, "cuda")  # > 1024
    assert not fused_chol.supported(256, torch.float64, kinds, "cuda")  # dtype
    assert not fused_chol.supported(256, torch.float32, ("ard_se",), "cuda")
    assert not fused_chol.supported(256, torch.float32, ("iso_se", "iso_se"),
                                    "cuda")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
