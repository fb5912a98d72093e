"""Public entry point for the fan-in-sparse masked matmul (port of
``repro.kernels.masked_matmul.ops``).

``masked_matmul(x, conn, w, bias)`` launches the CUDA kernel for CUDA
tensors and runs the plain gather for CPU ones (``masked_matmul.py``).
The reference's ``block_b``/``block_n`` tile sizes and interpret flag are
TPU settings and have no counterpart.
"""
from repro_torch.kernels.masked_matmul.masked_matmul import masked_matmul

__all__ = ["masked_matmul"]
