"""Algorithm 2 — SparseLUT non-greedy connectivity training (port of
``repro.core.sparse_train``; its module docstring explains the ramped
schedule, the swap turnover and the scored regrowth).

The control functions take their random draws as tensors: ``normal``
(the random walk's standard normals) and ``u`` (uniforms that split
regrowth ties), each shaped like ``theta``.  ``lutdnn.search_draws``
makes a search step's from its members' ``torch.Generator``s; a test
may pass the reference's own ``jax.random`` draws instead, and then the
control step is the reference's bit for bit.

Every function works on one (n_in, n_out) matrix or on a stack of
population members (P, n_in, n_out): ranks and fan-in counts run along
axis -2.  ``step`` may be a device tensor: the phases are ``torch.where``
masks, with no host read and no Python branch on a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.masking import ThetaLayer, final_mask, ranks_desc


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Hyper-parameters of Alg. 2 (paper Section IV-C defaults) plus
    the non-greedy ramp schedule."""

    target_fan_in: int          # F_o
    phase_boundary: int         # T, in steps; t < T => progressive phase
    eps1: float = 1e-12         # regrow initialisation
    eps2: float = 5e-5          # progressive-phase penalty
    noise_std: float = 1e-5     # G, random-walk scale
    l1: float = 1e-5            # alpha, shrinkage
    ramp_power: float = 3.0     # f(t) decay exponent (1.0 = linear)
    cooldown_frac: float = 0.25  # tail of the progressive phase at F_o
    grow_mode: str = "grad"     # "grad" | "theta" | "random"
    swap_frac: float = 0.3      # initial swap-turnover fraction of f(t)
    swap_every: int = 5         # swap cadence (regrowth grace period)


def _ramp_end(cfg: SparsityConfig) -> float:
    return max(cfg.phase_boundary * (1.0 - cfg.cooldown_frac), 1.0)


def scheduled_target(cfg: SparsityConfig, step, n_in: int
                     ) -> torch.Tensor:
    """The ramped per-step fan-in target f(t) as an int32 scalar tensor:
    decays from n_in (dense) to min(F_o, n_in) with exponent
    ``ramp_power``, reaching it at ``ramp_end = phase_boundary * (1 -
    cooldown_frac)`` and holding it thereafter.  float32 arithmetic, as
    the reference's."""
    f_final = min(cfg.target_fan_in, n_in)
    p = torch.clamp(torch.as_tensor(step).to(torch.float32)
                    / _ramp_end(cfg), 0.0, 1.0)
    f = f_final + (n_in - f_final) * (1.0 - p) ** cfg.ramp_power
    return torch.clamp(torch.floor(f), min=f_final).to(torch.int32)


def _grow_score(theta: torch.Tensor, active: torch.Tensor,
                u: torch.Tensor, cfg: SparsityConfig,
                grad: Optional[torch.Tensor],
                sign: Optional[torch.Tensor]) -> torch.Tensor:
    """Regrowth preference over INACTIVE connections (higher = regrown
    first): ``|dL/dW|`` in "grad" mode (falling back to "theta" without
    a gradient), the least-negative theta in "theta" mode, ``u`` in
    "random" mode; ``u`` splits exact ties in the first two."""
    mode = cfg.grow_mode
    if mode == "grad" and (grad is None or sign is None):
        mode = "theta"                      # documented fallback chain
    if mode == "grad":
        score = torch.abs(grad) + u * 1e-20
    elif mode == "theta":
        score = theta + u * 1e-6
    elif mode == "random":
        score = u
    else:
        raise ValueError(f"unknown grow_mode {cfg.grow_mode!r}")
    return torch.where(active, float("-inf"), score)


def _cols(v: torch.Tensor) -> torch.Tensor:
    """A per-column count (..., n_out) broadcast against (..., n_in,
    n_out)."""
    return v.unsqueeze(-2)


def sparse_control(theta: torch.Tensor, normal: torch.Tensor,
                   u: torch.Tensor, step, cfg: SparsityConfig, lr: float,
                   grad: Optional[torch.Tensor] = None,
                   sign: Optional[torch.Tensor] = None,
                   return_regrown: bool = False):
    """One Alg.-2 control step on theta (n_in, n_out), or a stack of
    them, with the draws given.

    Post-step invariants: fan-in never exceeds f(step); fan-in ==
    min(F_o, n_in) exactly once the ramp has landed, regrowth included;
    regrown connections never exceed the inactive slots."""
    n_in = theta.shape[-2]
    f_final = min(cfg.target_fan_in, n_in)
    step = torch.as_tensor(step, device=theta.device)
    f_sched = scheduled_target(cfg, step, n_in)              # scalar
    progressive = step < cfg.phase_boundary
    n_pre = torch.sum(theta > 0, dim=-2)                     # (.., n_out)

    # line 6 (regularizer + random walk) on active connections
    active = theta > 0
    noise = normal * cfg.noise_std
    theta = torch.where(active, theta - lr * cfg.l1 + lr * noise, theta)

    # line 7: theta < 0 is now implicitly non-active
    active = theta > 0
    n_active = torch.sum(active, dim=-2)

    # ramped hard schedule: truncate to f(t) every step.  The ranks of
    # the active thetas (0 = smallest, ties to the lower index) are
    # sorted once: the hard and swap prunes each zero a column's
    # smallest actives, so the survivors keep their order and their
    # ranks drop by the count pruned (the reference sorts anew each
    # time, to the same ranks)
    prune_rank = ranks_desc(torch.where(active, -theta, float("-inf")))
    excess_hard = torch.clamp(n_active - f_sched, min=0)
    hard_sel = (prune_rank < _cols(excess_hard)) & active
    theta = torch.where(hard_sel, 0.0, theta)
    active = active & ~hard_sel
    n_active = torch.minimum(n_active, f_sched)
    prune_rank = prune_rank - _cols(excess_hard)

    # ramped swap turnover on every swap_every-th progressive step
    rho = cfg.swap_frac * torch.clamp(
        1.0 - step.to(torch.float32) / _ramp_end(cfg), min=0.0)
    k_swap = torch.floor(rho * f_sched).to(torch.int32)      # scalar
    swap_now = progressive & (step % max(cfg.swap_every, 1) == 0)
    swap_sel = (prune_rank < k_swap) & active & swap_now
    theta = torch.where(swap_sel, 0.0, theta)
    active = active & ~swap_sel
    n_active = n_active - torch.sum(swap_sel, dim=-2)
    prune_rank = prune_rank - k_swap * swap_now

    # lines 13-16: soft -eps2 pressure toward the FINAL target
    excess_soft = torch.clamp(n_active - f_final, min=0)
    soft_sel = (prune_rank < _cols(excess_soft)) & active & progressive
    theta = torch.where(soft_sel, theta - cfg.eps2, theta)
    active = theta > 0
    n_active = torch.sum(active, dim=-2)

    # lines 9-11 generalised: scored regrowth back to the budget
    grow_target = torch.minimum(torch.clamp(n_pre, min=f_final), f_sched)
    grow_needed = torch.clamp(grow_target - n_active, min=0)
    grow_rank = ranks_desc(_grow_score(theta, active, u, cfg, grad, sign))
    grow_sel = (grow_rank < _cols(grow_needed)) & ~active
    theta = torch.where(grow_sel, cfg.eps1, theta)
    if return_regrown:
        return theta, grow_sel
    return theta


def deepr_control(theta: torch.Tensor, normal: torch.Tensor,
                  u: torch.Tensor, cfg: SparsityConfig, lr: float
                  ) -> torch.Tensor:
    """DeepR* — the paper's fixed-fan-in adaptation of DeepR, the
    comparison baseline: connections die only by sign flip and each
    step regrows exactly enough random ones to restore the target."""
    n_in = theta.shape[-2]
    active = theta > 0
    noise = normal * cfg.noise_std
    theta = torch.where(active, theta - lr * cfg.l1 + lr * noise, theta)
    active = theta > 0
    target = min(cfg.target_fan_in, n_in)
    grow_needed = torch.clamp(target - torch.sum(active, dim=-2), min=0)
    grow_rank = ranks_desc(torch.where(active, float("-inf"), u))
    grow_sel = (grow_rank < _cols(grow_needed)) & ~active
    return torch.where(grow_sel, cfg.eps1, theta)


def sparse_control_layer(layer: ThetaLayer, normal: torch.Tensor,
                         u: torch.Tensor, step, cfg: SparsityConfig,
                         lr: float, grad: Optional[torch.Tensor] = None
                         ) -> ThetaLayer:
    theta, regrown = sparse_control(layer.theta, normal, u, step, cfg, lr,
                                    grad=grad, sign=layer.sign,
                                    return_regrown=True)
    sign = layer.sign
    if grad is not None:
        # sign re-initialisation at regrowth: a revived connection gets
        # -sign(dL/dW); grad == 0 keeps the old sign
        sign = torch.where(regrown & (grad != 0),
                           -torch.sign(grad).to(sign.dtype), sign)
    return ThetaLayer(theta=theta, sign=sign, bias=layer.bias)


def sparse_control_tree(layers: Sequence[ThetaLayer],
                        draws: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                        step, cfgs: Sequence[SparsityConfig], lr: float,
                        grads: Optional[Sequence[torch.Tensor]] = None
                        ) -> List[ThetaLayer]:
    """``sparse_control_layer`` over every layer; ``draws[i]`` is layer
    i's ``(normal, u)``."""
    grads = [None] * len(layers) if grads is None else list(grads)
    return [sparse_control_layer(l, d[0], d[1], step, c, lr, grad=g)
            for l, d, c, g in zip(layers, draws, cfgs, grads)]


def extract_masks(layers: Sequence[ThetaLayer],
                  cfgs: Sequence[SparsityConfig]) -> list:
    """Alg. 2 line 21 — final feature masks M, hard-truncated to exactly
    F_o actives per neuron (ranked by theta)."""
    return [final_mask(l.theta, c.target_fan_in)
            for l, c in zip(layers, cfgs)]


def fan_in_ledger(layers: Sequence[ThetaLayer],
                  cfgs: Sequence[SparsityConfig]) -> list:
    """Per-layer fan-in accounting for search provenance: the target and
    the min/mean/max ACTIVE counts the search converged on (over every
    neuron, and every member of a stack)."""
    out = []
    for l, c in zip(layers, cfgs):
        fan = l.fan_in()
        out.append({
            "target_fan_in": int(min(c.target_fan_in, l.theta.shape[-2])),
            "fan_in_min": int(torch.min(fan)),
            "fan_in_max": int(torch.max(fan)),
            "fan_in_mean": round(float(torch.mean(fan.to(torch.float32))),
                                 3),
        })
    return out


def fan_in_violation(layers: Sequence[ThetaLayer],
                     cfgs: Sequence[SparsityConfig]) -> torch.Tensor:
    """Max over neurons of (active_count - F_o); <= 0 means the fan-in
    constraint holds everywhere."""
    worst = torch.tensor(-(10 ** 9), dtype=torch.int32,
                         device=layers[0].theta.device)
    for l, c in zip(layers, cfgs):
        worst = torch.maximum(worst,
                              torch.max(l.fan_in() - c.target_fan_in))
    return worst
