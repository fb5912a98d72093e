"""LUT-DNN networks, their trainers and the SparseLUT toolflow (port
of ``repro.core.lutdnn``), in the paper's two steps (Fig. 6):

1. **Connectivity search** (``init_search_model`` / ``make_search_step``
   / ``search_connectivity``): a full-precision theta/sign MLP trained
   by SGD with the Alg.-2 controller (``core.sparse_train``).  Output:
   per-layer feature masks with exactly F_o actives per neuron.
2. **LUT-DNN QAT** (``init_model`` / ``make_train_step``) over a fixed
   connectivity: random, or the searched masks through
   ``masks_to_conn``.

A QAT model is the reference's tree, ``{"layers": [params, ...],
"conn": [conn, ...]}``, with torch tensors for leaves.  The step
functions are plain functions on such trees: gradients from
``torch.autograd``, updates from ``optim.adamw``, both in the
reference's order.  ``model_from_numpy`` / ``model_to_numpy`` and
``search_state_from_numpy`` / ``search_state_to_numpy`` carry a model
or a search state across packages (numpy leaves).

A search population is one state whose leaves carry a leading member
axis, ``theta`` (P, n_in, n_out), as the reference's ``vmap`` stacks
them; the product is batched (``torch.bmm``), ranks run along each
member's ``n_in`` axis, and each member draws from its own generator.
``search_connectivity`` is the population of one, so a member of a
population searches exactly as it would alone.  The products stay in
float32: nothing here enables TF32, which would move the theta ranking.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core import masking, sparse_train
from repro_torch.core.masking import ThetaLayer
from repro_torch.core.sparse_train import SparsityConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import OptState, adamw, apply_updates, sgd, \
    tree_leaves, tree_map


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


# --------------------------------------------------------------------------
# Connectivity search (full precision, Alg. 1 + Alg. 2)
# --------------------------------------------------------------------------

def init_search_model(gen: torch.Generator, spec: ModelSpec,
                      initial_fan_in: Optional[int] = None,
                      device: DeviceLike = None) -> List[ThetaLayer]:
    """Full-precision theta/sign MLP with the LUT-DNN's topology widths,
    drawn from ``gen`` layer by layer and placed on ``device`` (the
    CUDA card unless one is named)."""
    dims = [spec.in_features] + list(spec.widths)
    return [masking.init_theta_layer(gen, dims[i], dims[i + 1],
                                     initial_fan_in, device=device)
            for i in range(len(spec.widths))]


class _Standardize(torch.autograd.Function):
    """``y + bias`` with ``y`` the per-neuron standardisation of ``z``
    over the batch axis (-2), population variance, eps 1e-5 (BN without
    running stats).  Every sum over the batch, forward (mean, variance)
    and backward (``dL/dz = s (g - mean(g) - y mean(g y))``, ``dL/dbias
    = sum(g)``), runs along the contiguous axis of a (.., n, B) copy: on
    the card, a sum along axis -2 of a (P, B, n) stack is laid out by
    PyTorch from P * n, so a population split over a mesh would round
    those sums otherwise than the whole population on one device (a
    10-wide layer's do), and the chaotic search would part from it."""

    @staticmethod
    def forward(ctx, z, bias):
        zt = z.transpose(-1, -2).contiguous()
        var, mean = torch.var_mean(zt, dim=-1, keepdim=True, correction=0)
        inv = torch.rsqrt(var + 1e-5)
        y = (zt - mean) * inv
        ctx.save_for_backward(y, inv)
        ctx.bias_shape = bias.shape
        return (y + bias.unsqueeze(-1)).transpose(-1, -2).contiguous()

    @staticmethod
    def backward(ctx, g):
        y, inv = ctx.saved_tensors
        gt = g.transpose(-1, -2).contiguous()
        gz = inv * (gt - gt.mean(-1, keepdim=True)
                    - y * (gt * y).mean(-1, keepdim=True))
        return (gz.transpose(-1, -2).contiguous(),
                gt.sum(-1).sum_to_size(ctx.bias_shape))


def _standardize(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-neuron batch standardisation over the batch axis (-2) plus
    ``bias`` (``_Standardize``)."""
    return _Standardize.apply(z, bias)


def _matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, n_in) or (P, B, n_in) times (n_in, n_out) or (P, n_in,
    n_out): a stack multiplies member by member (``bmm``), sharing a 2-D
    ``h`` across members."""
    if w.dim() == 3:
        if h.dim() == 2:
            h = h.expand(w.shape[0], *h.shape)
        return torch.bmm(h, w)
    return h @ w


def _proxy_forward(tlayers: Sequence[ThetaLayer], x: torch.Tensor,
                   spec: ModelSpec,
                   probes: Optional[Sequence[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """The quantized search proxy: the QAT model's input grid,
    batch-standardised pre-activations and STE activation quantizers;
    ``probes`` are added to the effective weights (the dense-gradient
    probe of ``make_search_step``)."""
    lspecs = spec.layer_specs()
    h = lspecs[0].in_quant.quantize(x)
    n = len(tlayers)
    for i, tl in enumerate(tlayers):
        w = tl.effective_weight()
        if probes is not None:
            w = w + probes[i]
        z = _standardize(_matmul(h, w), tl.bias)
        h = lspecs[i].out_quant.quantize(torch.relu(z)) if i < n - 1 \
            else z
    return h


def search_forward(tlayers: Sequence[ThetaLayer], x: torch.Tensor,
                   spec: Optional[ModelSpec] = None) -> torch.Tensor:
    """Forward through the theta/sign MLP (one member or a stack).

    With ``spec`` the proxy mirrors the downstream QAT model's
    information bottlenecks: input fake-quantized onto the same grid,
    batch-standardised pre-activations and STE activation quantization
    between layers.  Without ``spec``, the float relu MLP."""
    if spec is not None:
        return _proxy_forward(tlayers, x, spec)
    n = len(tlayers)
    h = x
    for i, tl in enumerate(tlayers):
        h = _matmul(h, tl.effective_weight()) + tl.bias.unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
    return h


def _member_loss(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Cross-entropy of each member: logits (..., B, C) -> (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long()[:, None].expand(*logits.shape[:-1], 1)
    return -torch.mean(torch.take_along_dim(logp, idx, dim=-1)[..., 0],
                       dim=-1)


def _member_acc(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels.long())
                      .to(torch.float32), dim=-1)


def search_sparsity_configs(spec: ModelSpec, phase_boundary: int,
                            **kw) -> List[SparsityConfig]:
    """Per-layer Alg.-2 configs.  Target fan-in per OUTPUT neuron is the
    total budget A*F (F_i-specific first layer respected)."""
    return [SparsityConfig(target_fan_in=s.total_fan_in,
                           phase_boundary=phase_boundary, **kw)
            for s in spec.layer_specs()]


def search_draws(gens: Sequence[torch.Generator],
                 tlayers: Sequence[ThetaLayer]) -> list:
    """One search step's control draws, ``[(normal, u)]`` a layer, each
    shaped like that layer's theta.  Member p's come from ``gens[p]``
    (all its normals, then all its uniforms, layer by layer), so a
    member draws the same numbers in a population as alone."""
    shapes = [tl.theta.shape[-2:] for tl in tlayers]
    total = sum(a * b for a, b in shapes)
    stacked = tlayers[0].theta.dim() == 3
    normal = [torch.randn(total, generator=g, device=g.device)
              for g in gens]
    u = [torch.rand(total, generator=g, device=g.device) for g in gens]
    if stacked:
        normal, u = torch.stack(normal), torch.stack(u)
    else:
        normal, u = normal[0], u[0]
    out, off = [], 0
    for a, b in shapes:
        out.append((normal[..., off:off + a * b].unflatten(-1, (a, b)),
                    u[..., off:off + a * b].unflatten(-1, (a, b))))
        off += a * b
    return out


def _control_gen(gen: torch.Generator, dev: torch.device
                 ) -> torch.Generator:
    """A controller generator on ``dev``, seeded by a draw of ``gen``
    (the reference splits its init key the same way)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=dev).manual_seed(seed)


def make_search_step(spec: ModelSpec, cfgs: Sequence[SparsityConfig],
                     lr: float = 0.15, mode: str = "sparselut"):
    """One step: SGD on (theta, bias), then connectivity control.
    Returns ``(init_state, step)``: ``init_state(gen, device=None)``
    and ``step(state, batch, draws=None) -> (new_state, {"loss",
    "acc"})``, on one member's state or a stacked population's (loss
    and accuracy then one a member).  ``draws`` (``search_draws``'s
    layout) replaces the state's generators for this step.

    mode = "sparselut" (Alg. 2, non-greedy, dense-to-sparse) |
           "deepr"     (DeepR* baseline: starts sparse at
                        ``cfgs[0].target_fan_in``, greedy).

    The reference's pinned behaviours: plain SGD with momentum 0.9 (an
    adaptive optimizer erases the gradient magnitudes the theta ranking
    needs); sign gradients zeroed before the update (signs are frozen);
    the dense dL/dW for regrowth from the gradient of a zero probe added
    to each effective weight; the momentum of theta cleared where the
    controller deactivated a connection (a stale buffer would revive it
    outside the controller).  The step stays on the device: ``step`` is
    a device tensor and the phases are masks."""
    if mode not in ("sparselut", "deepr"):
        raise ValueError(f"unknown search mode {mode!r}")
    opt_init, opt_update = sgd(lr, momentum=0.9)
    want_grad = (mode == "sparselut"
                 and any(c.grow_mode == "grad" for c in cfgs))

    def init_state(gen: torch.Generator, device: DeviceLike = None):
        dev = resolve_device(device)
        fi = None if mode == "sparselut" else cfgs[0].target_fan_in
        tlayers = init_search_model(gen, spec, initial_fan_in=fi,
                                    device=dev)
        return {"tlayers": tlayers, "opt": opt_init(tlayers),
                "gens": [_control_gen(gen, dev)],
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(state, batch, draws=None):
        tl = state["tlayers"]
        if draws is None:
            draws = search_draws(state["gens"], tl)
        n = len(tl)
        theta = [t.theta.detach().requires_grad_(True) for t in tl]
        bias = [t.bias.detach().requires_grad_(True) for t in tl]
        probes = ([torch.zeros_like(t.theta, requires_grad=True)
                   for t in tl] if want_grad else [])
        with torch.enable_grad():
            live = [ThetaLayer(theta=a, sign=t.sign, bias=b)
                    for a, t, b in zip(theta, tl, bias)]
            logits = _proxy_forward(live, batch["x"], spec,
                                    probes if want_grad else None)
            loss = _member_loss(logits, batch["y"])
            got = torch.autograd.grad(loss.sum(), theta + bias + probes)
        with torch.no_grad():
            acc = _member_acc(logits, batch["y"])
            grads = [ThetaLayer(theta=got[i],
                                sign=torch.zeros_like(tl[i].sign),
                                bias=got[n + i]) for i in range(n)]
            dense = list(got[2 * n:]) if want_grad else None
            updates, new_opt = opt_update(grads, state["opt"], tl)
            tlayers = apply_updates(tl, updates)
            if mode == "sparselut":
                tlayers = sparse_train.sparse_control_tree(
                    tlayers, draws, state["step"], cfgs, lr, grads=dense)
            else:
                tlayers = [ThetaLayer(
                    theta=sparse_train.deepr_control(t.theta, d[0], d[1],
                                                     c, lr),
                    sign=t.sign, bias=t.bias)
                    for t, d, c in zip(tlayers, draws, cfgs)]
            new_opt = OptState(
                step=new_opt.step,
                mu=[ThetaLayer(theta=torch.where(t.theta > 0, m.theta, 0.0),
                               sign=m.sign, bias=m.bias)
                    for t, m in zip(tlayers, new_opt.mu)],
                nu=None)
        new_state = {"tlayers": tlayers, "opt": new_opt,
                     "gens": state["gens"], "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "acc": acc}

    return init_state, step


def masks_to_conn(masks: Sequence[torch.Tensor], spec: ModelSpec) -> list:
    """Feature masks M -> per-layer gather tables (n_out, A, F) int32."""
    conn = []
    for m, s in zip(masks, spec.layer_specs()):
        idx = masking.mask_to_indices(m, s.total_fan_in)   # (n_out, A*F)
        conn.append(idx.reshape(s.n_out, s.adder_width, s.fan_in))
    return conn


def history_cadence(n_steps: int) -> int:
    """Integer recording cadence for search histories: ~10 snapshots,
    never 0."""
    return max(n_steps // 10, 1)


def population_search_init(gens: Sequence[torch.Generator],
                           spec: ModelSpec, cfgs: Sequence[SparsityConfig],
                           mode: str = "sparselut",
                           device: DeviceLike = None) -> dict:
    """A population's start: member p is ``make_search_step``'s
    ``init_state(gens[p], device)``, its leaves stacked on a leading
    member axis (the shared ``step`` and the optimizer's step stay
    scalars)."""
    init_state, _ = make_search_step(spec, cfgs, mode=mode)
    members = [init_state(g, device) for g in gens]

    def stack(trees):
        return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])

    return {"tlayers": stack([m["tlayers"] for m in members]),
            "opt": OptState(step=members[0]["opt"].step,
                            mu=stack([m["opt"].mu for m in members]),
                            nu=None),
            "gens": [m["gens"][0] for m in members],
            "step": members[0]["step"]}


def population_member(states: dict, p: int) -> dict:
    """Member ``p`` of a stacked search state, as a lone state."""
    pick = lambda t: t[p]   # noqa: E731
    return {"tlayers": tree_map(pick, states["tlayers"]),
            "opt": OptState(step=states["opt"].step,
                            mu=tree_map(pick, states["opt"].mu), nu=None),
            "gens": [states["gens"][p]], "step": states["step"]}


def search_connectivity(gen: torch.Generator, spec: ModelSpec, batches,
                        n_steps: int, phase_frac: float = 0.8,
                        lr: float = 0.15, mode: str = "sparselut",
                        device: DeviceLike = None, **sparse_kw):
    """End-to-end step 1 of the toolflow: returns (masks, history,
    state).  The population of one member started from ``gen``.
    History entries are recorded on the integer ``history_cadence`` and
    always include the final step."""
    masks, _, hist, states = search_connectivity_population(
        [gen], spec, batches, n_steps, phase_frac=phase_frac, lr=lr,
        mode=mode, device=device, **sparse_kw)
    member_hist = [{"loss": h["loss_mean"], "acc": h["acc_mean"],
                    "step": h["step"]} for h in hist]
    return ([m[0] for m in masks], member_hist,
            population_member(states, 0))


def _population_shards(n_members: int, mesh) -> List[tuple]:
    """``[(device, member indices)]``: the members split over ``mesh``
    as ``lutdnn_population_rules`` lays out the member axis: over the
    data axes when the count divides, else replicated (then the whole
    population steps once, on the first entry's device)."""
    from repro_torch.parallel import sharding as SH
    if not isinstance(mesh, SH.Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__}")
    spec = SH.choose_spec("tlayers/0/theta", (n_members,), mesh,
                          SH.lutdnn_population_rules(mesh))
    entries = mesh.shard_entries(spec[0] if spec else None)
    per = n_members // len(entries)
    return [(mesh.device_list[e], list(range(k * per, (k + 1) * per)))
            for k, e in enumerate(entries)]


def _on(dev: torch.device):
    """Make ``dev`` current for the block when it is a CUDA device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _batch_to(batch: dict, dev: torch.device) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def _join_states(parts: Sequence[dict], dev: torch.device) -> dict:
    """Shards' stacked states -> one stacked state on ``dev`` (members
    in shard order; the shared steps from the first shard)."""
    if len(parts) == 1:
        return parts[0]
    cat = lambda *xs: torch.cat([x.to(dev) for x in xs])   # noqa: E731
    first = parts[0]
    return {"tlayers": tree_map(cat, *[p["tlayers"] for p in parts]),
            "opt": OptState(step=first["opt"].step,
                            mu=tree_map(cat, *[p["opt"].mu for p in parts]),
                            nu=None),
            "gens": [g for p in parts for g in p["gens"]],
            "step": first["step"]}


def search_connectivity_population(gens: Sequence[torch.Generator],
                                   spec: ModelSpec, batches, n_steps: int,
                                   mesh=None, phase_frac: float = 0.8,
                                   lr: float = 0.15,
                                   mode: str = "sparselut",
                                   eval_batch=None,
                                   device: DeviceLike = None,
                                   **sparse_kw):
    """A multi-seed Alg.-2 search as one stacked program: one member a
    generator in ``gens`` (its start and its controller's draws), every
    member fed the same batches.

    ``mesh`` (``parallel.sharding.Mesh``) splits the members over its
    data axes by ``lutdnn_population_rules`` (replicated when the count
    does not divide): each shard's sub-stack starts and steps on its
    entry's device, drawing from its members' own generators, and sees
    every batch.  Members never exchange data, so the split run ends
    where the run on one device ends, bit for bit on the CPU
    (tests/test_torch_sharded.py) and on one card (``_Standardize``;
    chip_smoke.py ``[search]``).  With a mesh, ``device`` must be None.

    Returns ``(masks, scores, hist, states)``: per-layer masks (P, n_in,
    n_out); each member's accuracy with its masks applied on
    ``eval_batch`` (else the last training batch); population
    mean/min/max metrics on the integer ``history_cadence`` (final step
    always included); the stacked end states.  With a mesh, masks,
    scores and states are joined on the first entry's device."""
    if mesh is not None and device is not None:
        raise ValueError("a mesh places the members itself; pass "
                         "device=None")
    shards = (_population_shards(len(gens), mesh) if mesh is not None
              else [(resolve_device(device), list(range(len(gens))))])
    dev0 = shards[0][0]
    cfgs = search_sparsity_configs(
        spec, phase_boundary=int(n_steps * phase_frac), **sparse_kw)
    _, step = make_search_step(spec, cfgs, lr, mode=mode)
    parts = []
    for dev, members in shards:
        with _on(dev):
            parts.append(population_search_init(
                [gens[p] for p in members], spec, cfgs, mode=mode,
                device=dev))
    hist = []
    cadence = history_cadence(n_steps)
    last_batch = None
    for i in range(n_steps):
        last_batch = next(batches)
        metrics = []
        for k, (dev, _) in enumerate(shards):
            with _on(dev):
                parts[k], m = step(parts[k], _batch_to(last_batch, dev))
            metrics.append(m)
        if i % cadence == 0 or i == n_steps - 1:
            entry = {"step": i}
            for key in metrics[0]:
                v = torch.cat([m[key].cpu().reshape(-1) for m in metrics])
                entry[f"{key}_mean"] = float(torch.mean(v))
                entry[f"{key}_min"] = float(torch.min(v))
                entry[f"{key}_max"] = float(torch.max(v))
            hist.append(entry)
    # select by the accuracy of the truncated (mask-applied) network:
    # the quantity the extracted mask is selected to maximise
    score_batch = eval_batch if eval_batch is not None else last_batch
    masks, scores = [], []
    for (dev, _), st in zip(shards, parts):
        with _on(dev):
            mk = sparse_train.extract_masks(st["tlayers"], cfgs)
            masked = [ThetaLayer(theta=tl.theta * m, sign=tl.sign,
                                 bias=tl.bias)
                      for tl, m in zip(st["tlayers"], mk)]
            with torch.no_grad():
                b = _batch_to(score_batch, dev)
                logits = search_forward(masked, b["x"], spec)
                scores.append(_member_acc(logits, b["y"]).to(dev0))
        masks.append([m.to(dev0) for m in mk])
    masks = [torch.cat(ms) for ms in zip(*masks)]
    return (masks, torch.cat(scores), hist, _join_states(parts, dev0))


def select_best_masks(masks, scores):
    """The best population member: per-layer masks of the member with
    the highest score (ties -> the lowest index), and its index."""
    best = int(torch.argmax(torch.as_tensor(scores).cpu()))
    return [m[best] for m in masks], best


def search_provenance(spec: ModelSpec, cfgs: Sequence[SparsityConfig],
                      state: dict, *, n_steps: int, lr: float,
                      mode: str = "sparselut", seeds=None,
                      history=None) -> dict:
    """Manifest-ready provenance of a connectivity search (the schedule
    knobs, the generator seeds, the per-layer fan-in ledger) for
    ``artifact.save_artifact(search=...)``."""
    c0 = cfgs[0]
    out = {
        "algorithm": "sparselut-alg2" if mode == "sparselut" else "deepr",
        "n_steps": int(n_steps),
        "lr": float(lr),
        "schedule": {
            "phase_boundary": int(c0.phase_boundary),
            "ramp_power": float(c0.ramp_power),
            "cooldown_frac": float(c0.cooldown_frac),
            "eps1": float(c0.eps1),
            "eps2": float(c0.eps2),
            "noise_std": float(c0.noise_std),
            "l1": float(c0.l1),
            "grow_mode": str(c0.grow_mode),
        },
        "fan_in_ledger": sparse_train.fan_in_ledger(state["tlayers"], cfgs),
    }
    if seeds is not None:
        out["seeds"] = [int(s) for s in (
            seeds if hasattr(seeds, "__iter__") else [seeds])]
    if history:
        out["final_metrics"] = {k: v for k, v in history[-1].items()}
    return out


def search_state_from_numpy(tree: dict, device: DeviceLike = None) -> dict:
    """The reference's search state (``tlayers`` of ThetaLayer nodes,
    the SGD ``OptState`` and ``step``; array leaves, one member or
    stacked) -> the port's on ``device`` (the CUDA card unless one is
    named).  A key does not carry across: member p gets a controller
    generator seeded p."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(np.asarray(a), np.float32)).to(dev)

    def layer(t):
        return ThetaLayer(theta=leaf(t.theta), sign=leaf(t.sign),
                          bias=leaf(t.bias))

    def scalar(a):
        v = np.asarray(a).reshape(-1)
        if not (v == v[0]).all():
            raise ValueError(f"members at different steps: {v}")
        return torch.tensor(int(v[0]), dtype=torch.int32, device=dev)

    tl = [layer(t) for t in tree["tlayers"]]
    n_members = 1 if tl[0].theta.dim() == 2 else tl[0].theta.shape[0]
    return {"tlayers": tl,
            "opt": OptState(step=scalar(tree["opt"].step),
                            mu=[layer(m) for m in tree["opt"].mu], nu=None),
            "gens": [torch.Generator(device=dev).manual_seed(p)
                     for p in range(n_members)],
            "step": scalar(tree["step"])}


def search_state_to_numpy(state: dict) -> dict:
    """Inverse of ``search_state_from_numpy`` (the generators do not
    carry): ``{"tlayers", "opt", "step"}`` with numpy leaves."""
    arr = lambda t: t.detach().cpu().numpy()   # noqa: E731
    return {"tlayers": tree_map(arr, state["tlayers"]),
            "opt": OptState(step=arr(state["opt"].step),
                            mu=tree_map(arr, state["opt"].mu), nu=None),
            "step": arr(state["step"])}


# --------------------------------------------------------------------------
# Population training (N members at once, leaves on a member axis)
# --------------------------------------------------------------------------

def population_init(gen: torch.Generator, spec: ModelSpec, n: int,
                    device: DeviceLike = None) -> dict:
    """``n`` QAT train states drawn one after another from ``gen``, every
    leaf stacked on a leading member axis."""
    init_state, _ = make_train_step(spec)
    states = [init_state(gen, device) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def make_population_step(spec: ModelSpec, lr=1e-3) -> Callable:
    """Every member takes one QAT step on the same batch; members share
    nothing but the batch."""
    _, step = make_train_step(spec, lr)

    def pop_step(states, batch):
        n = len(states["model"]["conn"][0])
        outs = [step(tree_map(lambda t: t[p], states), batch)
                for p in range(n)]
        return tree_map(lambda *xs: torch.stack(xs),
                        outs[0], *outs[1:])

    return pop_step
