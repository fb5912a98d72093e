"""Minimal optax-style optimizers over nested trees of tensors (port
of ``repro.optim.adamw``): dicts, lists, tuples, named tuples and
dataclasses such as ``core.masking.ThetaLayer``.

An optimizer is a pair ``(init_fn, update_fn)``:
    state  = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)

These are plain functions, not ``torch.optim``: they keep the
reference's order of float32 operations (bias corrections included,
computed as float32 tensors, ``b1 ** step``), so the same gradients give
the same parameters in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``.  Dicts, lists, tuples, named tuples and dataclass
    instances (their fields in order) are walked and rebuilt as their
    own type, as JAX's registered pytrees are; ``None`` stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          mask: Optional[Callable[[Any], Any]] = None):
    """AdamW.  ``mask(params)`` may return a {0,1} tree selecting which
    leaves receive weight decay (biases/norms usually excluded)."""
    sched = _as_schedule(lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def update(grads, state: OptState, params=None) -> Tuple[Any, OptState]:
        step = state.step + 1
        lr_t = sched(step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                      grads)
        step_f = step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=step.device)
        mu_hat_scale = 1.0 / (1 - (one * b1) ** step_f)
        nu_hat_scale = 1.0 / (1 - (one * b2) ** step_f)

        def upd(m, v, p, wd_on):
            u = -lr_t * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale)
                                              + eps)
            if params is not None and weight_decay:
                u = u - lr_t * weight_decay * wd_on * p
            return u

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, 0.0, 0.0), mu, nu)
        else:
            wd_mask = (mask(params) if mask is not None
                       else tree_map(lambda _: 1.0, params))
            updates = tree_map(upd, mu, nu, params, wd_mask)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return init, update


def sgd(lr, momentum: float = 0.0):
    sched = _as_schedule(lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(torch.zeros_like, params), nu=None)

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        lr_t = sched(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
        else:
            mu = grads
        updates = tree_map(lambda g: -lr_t * g, mu)
        return updates, OptState(step=step, mu=mu if momentum else state.mu,
                                 nu=None)

    return init, update


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn
