"""Monomial feature expansion for PolyLUT neurons (port of
``repro.core.poly``).

PolyLUT replaces each neuron's linear form with a multivariate
polynomial of its F fan-in inputs: all monomials of total degree <= D
(the constant term is the bias).  The exponent table is built once per
(F, D) with itertools and numpy; ``expand`` raises the inputs to it and
takes the product over F.
"""
from __future__ import annotations

import functools
import itertools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def monomial_exponents(fan_in: int, degree: int) -> np.ndarray:
    """Exponent matrix E of shape (n_mono, fan_in).

    Row m gives the per-input exponents of monomial m; total degree in
    [1, degree].  Degree-1 terms come first (so D=1 is the identity
    expansion), then higher degrees lexicographically.
    """
    if fan_in <= 0:
        raise ValueError("fan_in must be positive")
    if degree < 1:
        raise ValueError("degree must be >= 1")
    rows = []
    for total in range(1, degree + 1):
        # compositions of `total` into fan_in non-negative parts
        for combo in itertools.combinations_with_replacement(range(fan_in), total):
            e = np.zeros((fan_in,), dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows, axis=0)


def num_monomials(fan_in: int, degree: int) -> int:
    return monomial_exponents(fan_in, degree).shape[0]


def expand(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Monomial-expand the trailing axis: (..., F) -> (..., n_mono),
    n_mono = C(F + D, D) - 1.  For degree 1 this is ``x`` itself.

    The gradient is finite at inputs of exactly 0: a zero exponent
    contributes a zero derivative (``torch.pow``'s rule, and JAX's for
    integer exponents), never ``0 * 0**-1``."""
    fan_in = x.shape[-1]
    if degree == 1:
        return x
    E = torch.from_numpy(monomial_exponents(fan_in, degree)).to(
        device=x.device, dtype=x.dtype)                      # (M, F)
    # x: (..., 1, F) ** (M, F) -> prod over F -> (..., M)
    return torch.prod(x[..., None, :] ** E, dim=-1)


def expand_shape(in_shape: Tuple[int, ...], degree: int) -> Tuple[int, ...]:
    return tuple(in_shape[:-1]) + (num_monomials(in_shape[-1], degree),)
