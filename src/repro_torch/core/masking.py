"""Algorithm 1 — weight-mapping for SparseLUT connectivity search (port
of ``repro.core.masking``).

Every connection k is represented by a trainable magnitude-and-status
parameter ``theta_k`` (active iff theta_k > 0) and a frozen random sign
``s_k``.  The effective weight is

    w_k = theta_k * s_k * 1(theta_k > 0)

Weight matrices are stored as (n_in, n_out); the per-neuron fan-in
constraint applies along the ``n_in`` axis (each *output* neuron draws
from at most F input connections).  A population of searches stacks its
members on a leading axis, (P, n_in, n_out), and every function here
works along axis -2, so one member and a stack take the same code.

Every sort is stable (``stable=True``), as ``jnp.argsort`` is by
default: ties go to the lower input index, on every device.  Ranks come
from one argsort and a scatter of ``arange`` (the same integers as the
reference's second argsort).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ThetaLayer:
    """The Alg.-1 representation of one weight matrix (a tree node for
    ``optim.adamw.tree_map``, fields in this order)."""

    theta: torch.Tensor  # (..., n_in, n_out) float32; active iff > 0
    sign: torch.Tensor   # (..., n_in, n_out) float32 in {-1, +1}; frozen
    bias: torch.Tensor   # (..., n_out) float32

    def effective_weight(self) -> torch.Tensor:
        return effective_weight(self.theta, self.sign)

    def mask(self) -> torch.Tensor:
        return (self.theta > 0).to(torch.float32)

    def fan_in(self) -> torch.Tensor:
        """Active-connection count per output neuron: (..., n_out)
        int32."""
        return torch.sum(self.theta > 0, dim=-2).to(torch.int32)


def effective_weight(theta: torch.Tensor, sign: torch.Tensor
                     ) -> torch.Tensor:
    """w = theta * sign * 1(theta > 0).

    The indicator gates the gradient too: d w / d theta = sign for
    active connections and 0 for inactive ones (Alg. 2 line 5)."""
    active = (theta > 0).to(theta.dtype)
    return theta * sign * active


def ranks_desc(score: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Dense ranks along ``dim``: 0 = largest score, ties to the lower
    index (a stable argsort of ``-score``, then the inverse permutation
    by a scatter)."""
    # sorted along a contiguous last axis (the same stable order, and
    # 2-3x faster on the CPU than a strided axis)
    s = score.movedim(dim, -1).contiguous()
    order = torch.argsort(-s, dim=-1, stable=True)
    ar = torch.arange(s.shape[-1], device=score.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar).movedim(-1, dim)


def init_theta_layer(gen: torch.Generator, n_in: int, n_out: int,
                     initial_fan_in: Optional[int] = None,
                     device: DeviceLike = None) -> ThetaLayer:
    """Alg. 1: theta = |W0| ⊙ is_con with F_i random connections a
    neuron, drawn from ``gen`` on its device and placed on ``device``
    (the CUDA card unless one is named).

    ``initial_fan_in=None`` (or >= n_in) starts dense — the paper's
    recommended dense-to-sparse configuration (F_i = N)."""
    dev = resolve_device(device)
    g = gen.device
    theta = torch.abs(torch.randn((n_in, n_out), generator=gen, device=g))
    if initial_fan_in is not None and initial_fan_in < n_in:
        # per output neuron, keep F_i random connections active
        scores = torch.rand((n_in, n_out), generator=gen, device=g)
        is_con = (ranks_desc(scores) < initial_fan_in).to(torch.float32)
        theta = theta * is_con
    sign = torch.where(torch.rand((n_in, n_out), generator=gen, device=g)
                       < 0.5, 1.0, -1.0).to(torch.float32)
    return ThetaLayer(theta=theta.to(dev), sign=sign.to(dev),
                      bias=torch.zeros((n_out,), dtype=torch.float32,
                                       device=dev))


def random_mask(gen: torch.Generator, n_in: int, n_out: int, fan_in: int
                ) -> torch.Tensor:
    """The baseline the paper compares against: fixed random sparsity
    with exactly ``fan_in`` connections per output neuron, on ``gen``'s
    device."""
    scores = torch.rand((n_in, n_out), generator=gen, device=gen.device)
    return (ranks_desc(scores) < min(fan_in, n_in)).to(torch.float32)


def mask_to_indices(mask: torch.Tensor, fan_in: int) -> torch.Tensor:
    """A {0,1} mask (n_in, n_out) with <= fan_in actives per column ->
    a dense connection-index table (n_out, fan_in) int32.

    Columns with fewer than ``fan_in`` actives repeat their first active
    index (gather duplicates; weights on duplicates are zero)."""
    order = torch.argsort(-mask, dim=0, stable=True)     # (n_in, n_out)
    idx = order[:fan_in, :].T                           # (n_out, fan_in)
    picked_active = torch.take_along_dim(mask.T, idx, dim=1) > 0
    first = idx[:, :1]
    return torch.where(picked_active, idx, first).to(torch.int32)


def final_mask(theta: torch.Tensor, target_fan_in: int) -> torch.Tensor:
    """Alg. 2 line 21 with a hard guarantee: EXACTLY min(F_o, n_in)
    actives per output neuron — the top-F_o thetas, ties broken toward
    the LOWER input index (rank space, not value space)."""
    f = min(target_fan_in, theta.shape[-2])
    return (ranks_desc(theta) < f).to(torch.float32)
