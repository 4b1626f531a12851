"""Hand-written CUDA kernels for the hot paths (NVIDIA Hopper), each with
its plain PyTorch version: the fixed-count ADMM iterations, the stagewise
tick and the batched Cholesky."""

from .admm_kernel import (admm_box_plain, fused_admm_box,
                          fused_admm_box_shared, fused_admm_general,
                          fused_admm_general_shared)
from .cholesky_kernel import chol_batched

__all__ = ["fused_admm_box", "fused_admm_box_shared", "fused_admm_general",
           "fused_admm_general_shared", "admm_box_plain", "chol_batched"]
