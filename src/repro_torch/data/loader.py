"""Batch iteration and host -> device feeding (port of
``repro.data.loader``).

``train_test_split`` and ``batch_iterator`` draw their permutations from
numpy exactly as the reference does, so the two packages see identical
splits and batches.  With a ``sharding`` (``data_sharding``), each
batch comes split over a device mesh as the reference's
``jax.device_put`` splits it: a ``parallel.sharding.ShardedTensor`` a
key, whose ``addressable_shards`` hold each entry's rows on its device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           device_put)


def train_test_split(data: Dict[str, np.ndarray], test_frac: float = 0.2,
                     seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic shuffle-split: {"train": {...}, "test": {...}}."""
    n = data["x"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    take = lambda idx: {k: v[idx] for k, v in data.items()}
    return {"train": take(tr), "test": take(te)}


def to_device(data: Dict[str, np.ndarray],
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors on ``device`` (the CUDA card unless one
    is named), dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in data.items()}


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0, device: DeviceLike = None,
                   sharding: Optional[NamedSharding] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite shuffled epochs of tensors on ``device`` (the CUDA card
    unless one is named).  With ``sharding`` each batch's leading dim is
    split over its mesh instead (``ShardedTensor``s, each shard on its
    entry's device; ``device`` must then be None)."""
    if sharding is not None and device is not None:
        raise ValueError("a sharded batch lands on its mesh's devices; "
                         "pass device=None")
    dev = None if sharding is not None else resolve_device(device)
    n = data["x"].shape[0]
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            batch = {k: v[idx] for k, v in data.items()}
            if sharding is None:
                yield to_device(batch, dev)
            else:
                yield {k: device_put(torch.from_numpy(
                    np.ascontiguousarray(v)), sharding)
                    for k, v in batch.items()}


def data_sharding(mesh: Mesh, *, batch_axes: Tuple[str, ...] = ("data",)
                  ) -> NamedSharding:
    """The leading (batch) dim over those of ``batch_axes`` the mesh
    has."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    return NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0]))
