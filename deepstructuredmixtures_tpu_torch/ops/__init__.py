"""Linear-algebra ops of the port: ``cholesky`` (torch.linalg) and
``fused_chol`` (the hand-written CUDA gram+Cholesky kernel)."""
