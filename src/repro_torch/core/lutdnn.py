"""LUT-DNN networks and their QAT trainer (port of the
configuration and QAT half of ``repro.core.lutdnn``).

A model is the reference's tree, ``{"layers": [params, ...], "conn":
[conn, ...]}``, with torch tensors for leaves.  ``make_train_step``
returns plain functions on such trees: the gradient comes from
``torch.autograd`` over the layer parameters and the update from
``optim.adamw``, both in the reference's order.  ``model_from_numpy``
and ``model_to_numpy`` carry a model across packages (numpy leaves).

The connectivity search (``init_search_model``, ``make_search_step``,
``search_connectivity``, ...) is not ported yet (``ROADMAP.md``,
Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import adamw, apply_updates, tree_leaves, \
    tree_map


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A full LUT-DNN configuration (one row of paper Table III / V)."""

    name: str
    in_features: int
    widths: Tuple[int, ...]
    bits: int                   # beta
    fan_in: int                 # F
    degree: int = 1             # D
    adder_width: int = 1        # A
    input_bits: Optional[int] = None   # beta_i
    input_fan_in: Optional[int] = None  # F_i
    hidden: Tuple[int, ...] = ()        # NeuraLUT sub-net widths

    def layer_specs(self) -> list:
        return L.make_layer_specs(
            self.in_features, self.widths, self.bits, self.fan_in,
            self.degree, self.adder_width, self.input_bits,
            self.input_fan_in, self.hidden)

    @property
    def table_entries(self) -> int:
        return sum(s.layer_table_entries for s in self.layer_specs())


# --------------------------------------------------------------------------
# QAT model over fixed connectivity
# --------------------------------------------------------------------------

def init_model(gen: torch.Generator, spec: ModelSpec,
               conn: Optional[Sequence[torch.Tensor]] = None,
               device: DeviceLike = None) -> dict:
    """Parameters (and random connectivity unless ``conn`` is given)
    drawn from ``gen`` on its device, then placed on ``device`` (the
    CUDA card unless one is named)."""
    dev = resolve_device(device)
    specs = spec.layer_specs()
    params, drawn = [], []
    for s in specs:
        params.append(L.init_layer(gen, s))
        drawn.append(L.random_conn(gen, s))
    conn = drawn if conn is None else list(conn)
    return {"layers": tree_map(lambda t: t.to(dev), params),
            "conn": [torch.as_tensor(c, dtype=torch.int32).to(dev)
                     for c in conn]}


def model_from_numpy(tree, spec: ModelSpec,
                     device: DeviceLike = None) -> dict:
    """The reference's ``{"layers", "conn"}`` tree with array leaves
    (anything ``np.asarray`` takes) -> the port's model on ``device``
    (the CUDA card unless one is named): float32 parameters, int32
    connectivity."""
    dev = resolve_device(device)
    n = len(spec.layer_specs())
    if len(tree["layers"]) != n or len(tree["conn"]) != n:
        raise ValueError(f"{spec.name} has {n} layers; the tree has "
                         f"{len(tree['layers'])} and {len(tree['conn'])}")

    def leaf(a, dtype):
        return torch.from_numpy(np.array(np.asarray(a), dtype)).to(dev)

    return {"layers": tree_map(lambda a: leaf(a, np.float32),
                               list(tree["layers"])),
            "conn": [leaf(c, np.int32) for c in tree["conn"]]}


def model_to_numpy(model: dict) -> dict:
    """Inverse of ``model_from_numpy``: every leaf as a numpy array."""
    return {"layers": tree_map(lambda t: t.detach().cpu().numpy(),
                               model["layers"]),
            "conn": [c.detach().cpu().numpy() for c in model["conn"]]}


def forward(model: dict, spec: ModelSpec, x: torch.Tensor,
            train: bool = False) -> Tuple[torch.Tensor, dict]:
    specs = spec.layer_specs()
    new_layers = []
    h = x
    for p, c, s in zip(model["layers"], model["conn"], specs):
        h, p2 = L.layer_forward(p, c, s, h, train=train)
        new_layers.append(p2)
    return h, {"layers": new_layers, "conn": model["conn"]}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(
        logp, labels.long()[..., None], dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels.long())
                      .to(torch.float32))


def make_train_step(spec: ModelSpec, lr=1e-3, weight_decay: float = 0.0):
    """Returns (init_state, step) for QAT training of a LUT-DNN:
    ``init_state(gen, device=None)`` and ``step(state, batch) ->
    (new_state, {"loss", "acc"})`` on tensors."""
    opt_init, opt_update = adamw(lr, weight_decay=weight_decay)

    def init_state(gen: torch.Generator, device: DeviceLike = None):
        model = init_model(gen, spec, device=device)
        return {"model": model, "opt": opt_init(model["layers"])}

    def step(state, batch):
        x, y = batch["x"], batch["y"]
        layers = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["model"]["layers"])
        leaves = tree_leaves(layers)
        with torch.enable_grad():
            m = {"layers": layers, "conn": state["model"]["conn"]}
            logits, new_m = forward(m, spec, x, train=True)
            loss = cross_entropy(logits, y)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (the BN running stats) has a
        # zero gradient, as under jax.grad
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)])
        grads = tree_map(lambda _: next(it), layers)
        with torch.no_grad():
            acc = accuracy(logits, y)
            params = tree_map(torch.Tensor.detach, state["model"]["layers"])
            updates, new_opt = opt_update(grads, state["opt"], params)
            new_layers = apply_updates(
                tree_map(torch.Tensor.detach, new_m["layers"]), updates)
            # BN stats are not optimizer-updated; keep the fresh running
            # stats.  As in the reference (repro/core/lutdnn.py:113-115)
            # this copies back the whole pre-update bn dict, so the
            # optimizer's update of gamma and beta is dropped too: both
            # stay at their initial values.
            for i, p in enumerate(new_m["layers"]):
                new_layers[i]["bn"] = tree_map(torch.Tensor.detach,
                                               p["bn"])
        new_state = {"model": {"layers": new_layers,
                               "conn": state["model"]["conn"]},
                     "opt": new_opt}
        return new_state, {"loss": loss.detach(), "acc": acc}

    return init_state, step


def make_eval_step(spec: ModelSpec) -> Callable:
    def eval_step(model, batch):
        with torch.no_grad():
            logits, _ = forward(model, spec, batch["x"], train=False)
            return (accuracy(logits, batch["y"]),
                    cross_entropy(logits, batch["y"]))
    return eval_step
