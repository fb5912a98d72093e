"""Public entry point for the WKV6 kernel (port of
``repro.kernels.wkv6.ops``).

``wkv6(r, k, v, logw, u, s0)`` launches the CUDA kernel for CUDA
tensors and runs the plain chunked form for CPU ones (``wkv6.py``);
``wkv6_reference`` is the plain chunked form on any device.
"""
from repro_torch.kernels.wkv6 import ref
from repro_torch.kernels.wkv6.wkv6 import wkv6

wkv6_reference = ref.wkv_chunked

__all__ = ["wkv6", "wkv6_reference"]
