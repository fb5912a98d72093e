"""Production mesh construction (port of ``repro.launch.mesh``).

Mesh layout, with the reference's axis names:

* single-pod: (16, 16), axes ("data", "model") = 256 devices;
* multi-pod: (2, 16, 16), axes ("pod", "data", "model") = 512 devices.

``pod`` x ``data`` form the data-parallel domain; ``model`` carries
tensor and expert parallelism.  A mesh is built over the visible
devices (the CUDA cards, or ``device.host_devices()`` on the CPU) in
order, the trailing axis innermost; asking for more devices than are
visible raises, as ``jax.make_mesh`` does.  Nothing here runs when the
module is imported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.parallel.sharding import Mesh, visible_devices


def _make(shape: Tuple[int, ...], axes: Sequence[str]) -> Mesh:
    n = int(np.prod(shape))
    devs = visible_devices()
    if n > len(devs):
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{len(devs)} visible")
    return Mesh(np.array(devs[:n], dtype=object).reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes)


def make_mesh(spec: str = "single") -> Mesh:
    """CLI helper: 'single' | 'multi' | 'NxM' | 'PxNxM'."""
    if spec == "single":
        return make_production_mesh(multi_pod=False)
    if spec == "multi":
        return make_production_mesh(multi_pod=True)
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        return _make(dims, ("data", "model"))
    if len(dims) == 3:
        return _make(dims, ("pod", "data", "model"))
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
