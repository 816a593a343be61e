"""The port's blocked Cholesky op against the JAX package's Pallas kernel
``hbm_blocked_cholesky`` (in the Pallas interpreter, as
``tests/test_pallas_potrf.py`` runs it) and float64 NumPy oracles.

On the CPU the wrapper runs its plain PyTorch version, which uses the CUDA
kernel's own two-level blocking (256-wide outer panels, 64-wide inner
steps, a product with the inverse of the diagonal block), so these tests
hold that blocking (ragged last panel included) to the oracles; the CUDA
kernel itself is held to the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepstructuredmixtures_tpu.ops import pallas_potrf

import deepstructuredmixtures_tpu_torch  # noqa: F401  (sets the TF32 flags)
from deepstructuredmixtures_tpu_torch.ops import potrf

from .test_torch_cuda import POTRF_TOL, check_potrf_contract, spd_batch
from .torch_threads import one_torch_thread  # noqa: F401


def _oracle_err(out, A):
    return max(np.abs(out[g] - np.linalg.cholesky(A[g].astype(np.float64))).max()
               for g in range(A.shape[0]))


def test_plain_matches_pallas_interpreter_and_oracle():
    A, _ = spd_batch(2, 512, seed=1)
    pallas = np.asarray(pallas_potrf.hbm_blocked_cholesky(
        jnp.asarray(A), interpret=True, tril=True))
    plain = potrf.blocked_cholesky_reference(torch.from_numpy(A))
    assert plain.dtype == torch.float32
    plain = plain.numpy()
    assert np.abs(plain - pallas).max() < 1e-5
    assert _oracle_err(plain, A) < POTRF_TOL
    assert _oracle_err(pallas, A) < POTRF_TOL


@pytest.mark.parametrize("g,n", [(3, 200), (1, 1040), (2, 64), (1, 37),
                                 (1, 257), (2, 300), (1, 520), (3, 256),
                                 (2, 255), (1, 321)])
def test_ragged_sizes_match_oracle(g, n):
    A, valid = spd_batch(g, n, seed=n)
    before = potrf.LAUNCHES
    out = potrf.blocked_cholesky(torch.from_numpy(A.copy()))
    assert potrf.LAUNCHES == before == 0  # the CPU never launches
    out = out.numpy()
    check_potrf_contract(out, valid)
    assert _oracle_err(out, A) < POTRF_TOL
    ld = 2.0 * np.log(np.diagonal(out, axis1=1, axis2=2)).sum(-1)
    ld_ref = np.array([np.linalg.slogdet(A[i].astype(np.float64))[1]
                       for i in range(g)])
    assert np.abs(ld - ld_ref).max() / np.abs(ld_ref).max() < 1e-5


def test_in_place_and_float64():
    A, valid = spd_batch(2, 130, seed=3)
    a = torch.from_numpy(A.astype(np.float64))
    out = potrf.blocked_cholesky(a)
    assert out is a
    ref = np.linalg.cholesky(A.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    check_potrf_contract(out.numpy(), valid)


def test_not_positive_definite_is_nonfinite_and_does_not_raise():
    a = torch.eye(100, dtype=torch.float32)[None].repeat(2, 1, 1)
    a[1, 70, 70] = -1.0
    out = potrf.blocked_cholesky(a)
    assert torch.isfinite(out[0]).all()
    assert not torch.isfinite(out[1]).all()


def test_wrapper_validation():
    with pytest.raises(ValueError):
        potrf.blocked_cholesky(torch.zeros(4, 4))  # not batched
    with pytest.raises(ValueError):
        potrf.blocked_cholesky(torch.zeros(1, 4, 5))  # not square
    with pytest.raises(ValueError):
        potrf.blocked_cholesky(torch.zeros(1, 4, 4, device="meta"))
    assert potrf.blocked_cholesky(torch.zeros(0, 3, 3)).shape == (0, 3, 3)


def test_supported_gates():
    assert potrf.supported(1040, torch.float32, "cuda")
    assert potrf.supported(16232, torch.float32, torch.device("cuda", 0))
    assert not potrf.supported(1024, torch.float32, "cuda")  # fused domain
    assert not potrf.supported(2048, torch.float64, "cuda")  # dtype
    assert not potrf.supported(2048, torch.float32, "cpu")  # device
