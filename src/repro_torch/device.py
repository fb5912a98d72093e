"""Device selection shared by the port's entry points (and the port's
counterpart of ``repro.xla_env``).

Entry points run on the CUDA card unless the caller names another
device.  There is no silent fallback: asking for the default device on
a machine without a card raises, so a run that meant to use the GPU
never measures the CPU instead.

``ensure_host_devices(n)`` lets the CPU stand as ``n`` entries of a
device mesh (``parallel.sharding.Mesh``), as XLA's
``--xla_force_host_platform_device_count=n`` gives the reference ``n``
virtual CPU devices: ``host_devices()`` then returns the CPU ``n``
times.  The count lives in the environment (``REPRO_TORCH_HOST_DEVICES``),
as the reference's lives in ``XLA_FLAGS``, so a launcher may set it
before starting a run.
"""
from __future__ import annotations

import os
from typing import List, Union

import torch

HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises when there is none);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ensure_host_devices(n: int = 4) -> None:
    """Let the CPU stand as ``n`` mesh entries (``host_devices``) unless
    a count is already set: an explicit choice is never overridden.  It
    affects CPU meshes only; CUDA meshes take the visible cards."""
    if HOST_DEVICES_ENV not in os.environ:
        os.environ[HOST_DEVICES_ENV] = str(int(n))


def host_devices() -> List[torch.device]:
    """The CPU as many times as ``ensure_host_devices`` set (once when
    nothing set it): the entries a CPU mesh may take."""
    n = int(os.environ.get(HOST_DEVICES_ENV, "1"))
    if n < 1:
        raise ValueError(f"{HOST_DEVICES_ENV}={n}: want at least 1")
    return [torch.device("cpu")] * n
