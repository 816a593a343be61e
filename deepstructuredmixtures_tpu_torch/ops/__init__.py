"""Linear-algebra ops of the port: ``cholesky`` (torch.linalg), and the
hand-written CUDA kernels ``fused_chol`` (gram + Cholesky) and ``potrf``
(blocked Cholesky). The package exports the JAX package's six ``ops``
names."""
from .cholesky import (
    cho_solve_lower,
    chol_continue,
    givens_delete_rows,
    masked_cholesky,
    masked_gram_noise,
    masked_logdet,
)

__all__ = [
    "masked_gram_noise",
    "masked_cholesky",
    "cho_solve_lower",
    "masked_logdet",
    "givens_delete_rows",
    "chol_continue",
]
