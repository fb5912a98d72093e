"""Procedural offline datasets (a copy of ``repro.data.synthetic``,
numpy only, so both packages see the same arrays).

No network access in this container, so we generate structured
analogues of the paper's three benchmarks.  They are built to exercise
the same *relative* phenomena the paper measures:

* ``mnist_like`` — 28x28 rasters whose informative pixels live under a
  centre Gaussian window (handwritten digits are centred), so an
  effective connectivity learner must concentrate first-layer fan-in in
  the centre (paper Fig. 8).
* ``jsc_like`` — 16 features / 5 classes Gaussian-mixture jets with a
  few uninformative features; small dense-minus-sparse accuracy gap
  delta, like the paper's JSC discussion.
* ``cifar10_like`` — 3072-feature hard task with heavy class overlap
  (low absolute accuracy, big delta — matches the paper's CIFAR-10
  observations qualitatively).

Everything is deterministic given the seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _softmax(z, axis=-1):
    z = z - z.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def prototype_dataset(seed: int, n_samples: int, n_features: int,
                      n_classes: int, noise: float,
                      informative: np.ndarray | None = None,
                      within_class_var: float = 0.3) -> Dict[str, np.ndarray]:
    """x = informative ⊙ (prototype[c] * s) + noise, s ~ per-sample scale."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, n_features)).astype(np.float32)
    if informative is not None:
        protos = protos * informative[None, :]
    y = rng.integers(0, n_classes, size=(n_samples,))
    scale = 1.0 + within_class_var * rng.normal(size=(n_samples, 1))
    x = protos[y] * scale + noise * rng.normal(size=(n_samples, n_features))
    x = np.tanh(x.astype(np.float32))          # bounded to [-1, 1]
    return {"x": x, "y": y.astype(np.int32)}


def _center_window(h: int = 28, w: int = 28, sigma: float = 0.22) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    d2 = ((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2
    return np.exp(-d2 / (2 * sigma ** 2)).astype(np.float32).reshape(-1)


def mnist_like(n_samples: int = 12000, seed: int = 0) -> Dict[str, np.ndarray]:
    """784-dim, 10 classes, centre-informative."""
    return prototype_dataset(seed + 101, n_samples, 784, 10, noise=0.55,
                             informative=_center_window())


def jsc_like(n_samples: int = 20000, seed: int = 0) -> Dict[str, np.ndarray]:
    """16-dim, 5 classes; last 3 features carry no class signal."""
    informative = np.ones((16,), np.float32)
    informative[13:] = 0.05
    return prototype_dataset(seed + 202, n_samples, 16, 5, noise=0.9,
                             informative=informative,
                             within_class_var=0.45)


def cifar10_like(n_samples: int = 12000, seed: int = 0) -> Dict[str, np.ndarray]:
    """3072-dim, 10 classes, strong overlap (hard)."""
    return prototype_dataset(seed + 303, n_samples, 3072, 10, noise=1.6,
                             within_class_var=0.6)


_REGISTRY = {
    "mnist": mnist_like,
    "jsc": jsc_like,
    "cifar10": cifar10_like,
}


def make_dataset(name: str, n_samples: int = 12000, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](n_samples=n_samples, seed=seed)


def dataset_dims(name: str) -> Tuple[int, int]:
    return {"mnist": (784, 10), "jsc": (16, 5), "cifar10": (3072, 10)}[name]
