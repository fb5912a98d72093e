"""Production mesh construction (port of ``repro.launch.mesh``).

Mesh layout, with the reference's axis names:

* single-pod: (16, 16), axes ("data", "model") = 256 devices;
* multi-pod: (2, 16, 16), axes ("pod", "data", "model") = 512 devices.

``pod`` x ``data`` form the data-parallel domain; ``model`` carries
tensor and expert parallelism.  A mesh is built over the visible
devices (the CUDA cards, or ``device.host_devices()`` on the CPU), or
over the ``devices`` a caller passes, in order, the trailing axis
innermost; asking for more devices than there are raises, as
``jax.make_mesh`` does.  The dry-run passes ``placeholder_devices(n)``:
``n`` meta entries that stand for chips that are not there, as the
reference's dry-run asks XLA for 512 placeholder CPU devices.  Nothing
here runs when the module is imported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import Mesh, visible_devices


def placeholder_devices(n: int) -> List[torch.device]:
    """``n`` meta entries: a mesh of chips that are not there."""
    return [torch.device("meta")] * int(n)


def _make(shape: Tuple[int, ...], axes: Sequence[str],
          devices: Optional[Sequence] = None) -> Mesh:
    n = int(np.prod(shape))
    devs = list(devices) if devices is not None else visible_devices()
    if n > len(devs):
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{len(devs)} " + ("given" if devices is not None
                                            else "visible"))
    return Mesh(np.array(devs[:n], dtype=object).reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, devices)


def make_mesh(spec: str = "single",
              devices: Optional[Sequence] = None) -> Mesh:
    """CLI helper: 'single' | 'multi' | 'NxM' | 'PxNxM', over the
    visible devices or ``devices``."""
    if spec == "single":
        return make_production_mesh(multi_pod=False, devices=devices)
    if spec == "multi":
        return make_production_mesh(multi_pod=True, devices=devices)
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        return _make(dims, ("data", "model"), devices)
    if len(dims) == 3:
        return _make(dims, ("pod", "data", "model"), devices)
    raise ValueError(f"bad mesh spec {spec!r}")


def mesh_chip_count(mesh: Mesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


def host_device_count_needed(spec: str = "single") -> int:
    if spec == "single":
        return 256
    if spec == "multi":
        return 512
    n = 1
    for x in spec.split("x"):
        n *= int(x)
    return n
