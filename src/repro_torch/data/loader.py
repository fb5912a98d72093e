"""Batch iteration and host -> device feeding (port of
``repro.data.loader``: ``train_test_split`` and ``batch_iterator``).

Both draw their permutations from numpy exactly as the reference does,
so the two packages see identical splits and batches.  The sharded
feeding (``data_sharding``) waits on the port's sharded engine.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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
                   seed: int = 0, device: DeviceLike = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite shuffled epochs of tensors on ``device`` (the CUDA card
    unless one is named)."""
    dev = resolve_device(device)
    n = data["x"].shape[0]
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield to_device({k: v[idx] for k, v in data.items()}, dev)
