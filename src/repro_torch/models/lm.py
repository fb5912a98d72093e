"""Decoder-only LM (port of ``repro.models.lm``): global (``attn``) and
sliding-window (``local``) attention and the RG-LRU (``rglru``) mixers,
each paired with the dense FFN (``dense``) or the mixture of experts
(``moe``), and RWKV6 time mix paired with RWKV channel mix
(``("rwkv", "rwkv_cm")``).  Sharding waits (``ROADMAP.md``, Queue 1
item 6): ``moe_ep``, ``moe_ep_fsdp`` and ``seq_parallel`` raise
``NotImplementedError``.  The encoder-decoder is ``models/encdec.py``.

Parameters are plain dictionaries of tensors with one entry per layer
(``params["blocks"]``), run by a plain loop: the reference stacks layers
by period for ``jax.lax.scan``, which PyTorch's eager execution does not
need.  ``params_from_numpy`` (and ``train_state_from_numpy`` for a whole
AdamW train state) unstacks the reference's tree into this layout, so
both packages can run, and train, the same weights.  An LM checkpoint
holds the reference's layout (``checkpoint_layout``: the
``train_state_to_stacked`` and ``train_state_from_stacked`` pair), so
either package restores the other's.

Modes, as in the reference: ``forward`` (no cache; carries gradients),
``prefill`` (runs the prompt and returns the decode cache) and
``decode_step`` (one token at position ``pos`` against that cache).
Global attention keeps a (B, max_len) KV cache; ``local`` layers keep a
ring of ``window`` slots (slot = pos % window); an RG-LRU layer keeps
its float32 state h and its conv's last inputs.  ``kv_cache_dtype="int8"``
stores K and V as int8 codes with a float16 scale per token and head.
Both blocks run ``layers.attn_apply``, which writes into the cache it is
given and returns it, where the reference returns a new cache.

On CUDA tensors each RWKV time mix sends its WKV through the CUDA
kernel (``kernels/wkv6``) unless ``use_wkv_kernel`` is off.  Attention,
the FFN, the experts, the RG-LRU and the unembedding are plain matmuls,
softmax and elementwise ops, as they are plain einsums in the reference
(``layers.py`` says how the scores keep float32 precision).  An MoE
block drops assignments over capacity in forward and prefill and keeps
every one at decode (``no_drop``), as the reference does; its
load-balancing term is the third value of ``block_apply`` and the second
of ``forward``, which ``lm_loss`` adds.

Training (``lm_loss``, ``make_train_step``) differentiates every leaf of
``params``, as the reference does; with ``sparse_ffn`` that includes the
sparse FFN's signs, which the reference calls frozen but trains
(``ROADMAP.md``, Queue 3).  ``apply_sparse_control`` runs Alg. 2 on each
``*_theta`` leaf with draws the caller may pass; otherwise they come
from a ``torch.Generator`` seeded from a CRC-32 of the leaf's place in
the reference's tree, the layer and the step, so two processes draw
alike (the reference's salted ``hash()`` does not).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as NN
from repro_torch.models import recurrent as RC
from repro_torch.models.layers import AttnSpec

MIXERS = ("attn", "local", "rglru", "rwkv")
CHANNELS = ("dense", "moe", "rwkv_cm")
_UNPORTED = "see ROADMAP.md Queue 1 item 6, the LM's multi-rank half"

# LMConfig fields of the multi-card work, which is not ported, with the
# only value the port takes
_UNPORTED_FIELDS = dict(moe_ep=False, moe_ep_fsdp=False, seq_parallel=False)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # block pattern, cycled over post-prefix layers: (mixer, channel)
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    prefix: Tuple[Tuple[str, str], ...] = ()
    ffn_kind: str = "swiglu"            # dense-FFN nonlinearity
    norm: str = "rms"                   # rms | ln
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None        # sliding window for "local"
    tie_embeddings: bool = False
    # MoE (where channel == "moe"); the expert-parallel dispatch is not
    # ported (only its defaults)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_ep: bool = False
    moe_ep_fsdp: bool = False
    d_rnn: int = 0                      # RG-LRU width (0 -> d_model)
    # "none": token ids; "stub": precomputed (B, S, D) embeddings
    frontend: str = "none"
    dtype: Any = torch.bfloat16
    # SparseLUT fan-in-sparse FFN (Alg. 2 on the dense channel's up and
    # gate projections); sparse_fan_in = F_o (0 -> d_model // 8)
    sparse_ffn: bool = False
    sparse_fan_in: int = 0
    sparse_phase_T: int = 1000
    kv_cache_dtype: str = "bf16"        # "bf16" (the model's dtype) | "int8"
    seq_parallel: bool = False
    # WKV of CUDA tensors through the CUDA kernel (False: the plain
    # chunked form, the kernel's yardstick on the card)
    use_wkv_kernel: bool = True

    def __post_init__(self):
        for field, default in _UNPORTED_FIELDS.items():
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"LMConfig.{field}={getattr(self, field)!r}: the "
                    f"expert-parallel dispatch and sequence parallelism "
                    f"are not ported yet ({_UNPORTED})")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}")

    @property
    def kinds(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, channel) kinds, all n_layers of them."""
        out = list(self.prefix)
        i = 0
        while len(out) < self.n_layers:
            out.append(self.pattern[i % len(self.pattern)])
            i += 1
        return out[: self.n_layers]

    @property
    def n_scan_groups(self) -> int:
        """Whole periods after the prefix (the reference's scan length)."""
        return (self.n_layers - len(self.prefix)) // len(self.pattern)

    @property
    def tail_kinds(self) -> List[Tuple[str, str]]:
        used = len(self.prefix) + self.n_scan_groups * len(self.pattern)
        return self.kinds[used:]

    def attn_spec(self, mixer: str) -> AttnSpec:
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            causal=True,
            window=self.window if mixer == "local" else None)

    def moe_spec(self) -> NN.MoESpec:
        return NN.MoESpec(n_experts=self.n_experts, top_k=self.top_k,
                          d_model=self.d_model, d_ff=self.moe_d_ff,
                          capacity_factor=self.moe_capacity_factor,
                          shared_expert=self.shared_expert)


def _check_kind(kind: Tuple[str, str]) -> None:
    mixer, channel = kind
    if mixer not in MIXERS or channel not in CHANNELS \
            or (channel == "rwkv_cm") != (mixer == "rwkv"):
        raise ValueError(
            f"block kind {tuple(kind)}: the mixers {MIXERS[:3]} pair with "
            f"'dense' or 'moe', and 'rwkv' with 'rwkv_cm'")


def param_count(cfg: LMConfig) -> Tuple[int, int]:
    """(total, active) parameter counts, as the reference counts them."""
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    total = active = cfg.vocab * D                       # embed
    if not cfg.tie_embeddings:
        total += D * cfg.vocab
        active += D * cfg.vocab
    for kind in cfg.kinds:
        _check_kind(kind)
        mixer, channel = kind
        if mixer in ("attn", "local"):
            n = D * H * hd + 2 * D * KH * hd + H * hd * D
        elif mixer == "rglru":
            R = cfg.d_rnn or D
            n = 2 * D * R + 2 * R * R + R * D
        else:
            n = 5 * D * D + 2 * D * 64                   # proj + decay lora
        if channel == "dense":
            n += (3 if cfg.ffn_kind == "swiglu" else 2) * D * cfg.d_ff
        elif channel == "rwkv_cm":
            n += 2 * D * cfg.d_ff + D * D
        total += n
        active += n
        if channel == "moe":
            per = 3 * D * cfg.moe_d_ff
            total += cfg.n_experts * per + D * cfg.n_experts
            active += cfg.top_k * per + D * cfg.n_experts
            if cfg.shared_expert:
                total += per
                active += per
    return total, active


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _norm_init(cfg: LMConfig, d: int, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    if cfg.norm == "rms":
        return {"scale": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def _norm_apply(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        return NN.rms_norm(x, p["scale"])
    return NN.layer_norm(x, p["scale"], p["bias"])


def block_init(generator: torch.Generator, cfg: LMConfig,
               kind: Tuple[str, str], device: DeviceLike = None) -> dict:
    """One block's weights on ``device`` (the card unless named)."""
    _check_kind(kind)
    device = resolve_device(device)
    mixer, channel = kind
    p = {"norm1": _norm_init(cfg, cfg.d_model, device),
         "norm2": _norm_init(cfg, cfg.d_model, device)}
    if mixer in ("attn", "local"):
        p["attn"] = NN.attn_init(generator, cfg.attn_spec(mixer), cfg.dtype,
                                 device)
    elif mixer == "rglru":
        p["rglru"] = RC.rglru_init(generator, cfg.d_model,
                                   cfg.d_rnn or cfg.d_model,
                                   dtype=cfg.dtype, device=device)
    else:
        p["rwkv"] = RC.rwkv_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.d_ff, dtype=cfg.dtype, device=device)
    if channel == "dense":
        p["ffn"] = NN.ffn_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.ffn_kind, cfg.dtype,
                               sparse=cfg.sparse_ffn, device=device)
    elif channel == "moe":
        p["moe"] = NN.moe_init(generator, cfg.moe_spec(), cfg.dtype, device)
    return p


def block_cache_init(cfg: LMConfig, kind: Tuple[str, str], batch: int,
                     max_len: int, device: DeviceLike = None) -> dict:
    """Decode-time state of one block on ``device`` (the card unless
    named): a (batch, max_len) KV cache for ``attn``, a ring of
    ``window`` slots for ``local``, the O(1) recurrent state for RG-LRU
    and RWKV."""
    _check_kind(kind)
    device = resolve_device(device)
    mixer, _ = kind
    if mixer in ("attn", "local"):
        return NN.attn_cache_init(cfg.attn_spec(mixer), batch, max_len,
                                  cfg.dtype, device,
                                  int8=cfg.kv_cache_dtype == "int8")
    if mixer == "rglru":
        return RC.rglru_state_init(batch, cfg.d_rnn or cfg.d_model,
                                   dtype=cfg.dtype, device=device)
    return RC.rwkv_state_init(batch, cfg.d_model, cfg.n_heads, cfg.dtype,
                              device=device)


def block_apply(cfg: LMConfig, kind: Tuple[str, str], p: dict,
                x: torch.Tensor, positions: Optional[torch.Tensor],
                cache: Optional[dict]):
    """One block.  Modes:

    * ``cache`` None             -> forward, new cache None;
    * ``cache`` given, S > 1     -> prefill: the cache is filled;
    * ``cache`` given, S == 1    -> decode at ``positions`` (1,) against
      the cache.

    ``positions`` (S,) are the tokens' positions (the attention blocks
    need them; the recurrent ones do not).  An attention cache is
    written in place and returned; a recurrent state is returned new.
    Returns (x, new cache, aux): ``aux`` is an MoE block's float32
    load-balancing term, 0.0 for any other block, as in the reference."""
    _check_kind(kind)
    mixer, channel = kind
    h = _norm_apply(cfg, p["norm1"], x)
    if mixer in ("attn", "local"):
        a, new_mix = NN.attn_apply(p["attn"], cfg.attn_spec(mixer), h,
                                   positions, cache)
    elif mixer == "rglru":
        a, new_mix = RC.rglru_apply(p["rglru"], h, cache)
    else:
        a, new_mix = RC.rwkv_time_mix(p["rwkv"], cfg.n_heads, h, cache,
                                      use_kernel=cfg.use_wkv_kernel)
    x = x + a
    h2 = _norm_apply(cfg, p["norm2"], x)
    aux = 0.0
    if channel == "dense":
        f = NN.ffn_apply(p["ffn"], cfg.ffn_kind, h2)
    elif channel == "moe":
        # decode keeps every assignment: capacity eviction is a training
        # throughput trade, never wanted at serve time
        decode = cache is not None and x.shape[1] == 1
        f, aux = NN.moe_apply(p["moe"], cfg.moe_spec(), h2, no_drop=decode)
    else:
        f, cm_new = RC.rwkv_channel_mix(p["rwkv"], h2, cache)
        if cache is not None:
            new_mix = {**new_mix, **cm_new}
    return x + f, (new_mix if cache is not None else None), aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Fresh weights drawn from ``generator`` (on ``device``, the card
    unless named; the generator must live there): the reference's
    shapes, scales and dtypes (not its random numbers)."""
    device = resolve_device(device)
    D = cfg.d_model
    scale = 1.0 / math.sqrt(D)

    def normal(shape):
        return NN._normal(generator, shape, scale, cfg.dtype, device)

    p: dict = {"embed": {"table": normal((cfg.vocab, D))},
               "final_norm": _norm_init(cfg, D, device)}
    if not cfg.tie_embeddings:
        p["head"] = {"w": normal((D, cfg.vocab))}
    p["blocks"] = [block_init(generator, cfg, kind, device)
                   for kind in cfg.kinds]
    return p


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> dict:
    """Zero decode state on ``device`` (the card unless named)."""
    device = resolve_device(device)
    return {"blocks": [block_cache_init(cfg, kind, batch, max_len, device)
                       for kind in cfg.kinds]}


def layers_from_stacked(tree: Dict[str, Any], cfg: LMConfig) -> List[Any]:
    """Per-layer entries of a reference parameter or cache tree, in layer
    order: ``prefix``, then each scan group's period from ``stacks``
    (whose leaves carry the group on their leading axis), then ``tail``."""
    def index(node, g):
        if isinstance(node, dict):
            return {k: index(v, g) for k, v in node.items()}
        return node[g]

    out = list(tree["prefix"])
    for g in range(cfg.n_scan_groups):
        out.extend(index(stack, g) for stack in tree["stacks"])
    out.extend(tree["tail"])
    return out


def layers_to_stacked(layers: List[Any], cfg: LMConfig, stack) -> dict:
    """The inverse of ``layers_from_stacked``: per-layer entries as the
    reference's ``{"prefix", "stacks", "tail"}``, the entries of each
    position in the period combined leaf by leaf with ``stack`` (a list
    of leaves, one a group, -> one leaf)."""
    n_pre, P, G = len(cfg.prefix), len(cfg.pattern), cfg.n_scan_groups

    def combine(nodes):
        if isinstance(nodes[0], dict):
            return {k: combine([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    stacks = [combine([layers[n_pre + g * P + j] for g in range(G)])
              for j in range(P)] if G > 0 else []
    return {"prefix": list(layers[:n_pre]), "stacks": stacks,
            "tail": list(layers[n_pre + G * P:])}


def reference_site(cfg: LMConfig, layer: int) -> Tuple[str, Optional[int]]:
    """Where layer ``layer`` lives in the reference's parameter tree: its
    path as the reference prints one (``['stacks']/[j]``), and its scan
    group (None outside the stacks)."""
    n_pre, P, G = len(cfg.prefix), len(cfg.pattern), cfg.n_scan_groups
    if layer < n_pre:
        return f"['prefix']/[{layer}]", None
    j = layer - n_pre
    if j < G * P:
        return f"['stacks']/[{j % P}]", j // P
    return f"['tail']/[{j - G * P}]", None


def params_from_stacked(tree: Dict[str, Any], cfg: LMConfig) -> dict:
    """The reference's parameter tree (or one of its shape, such as
    AdamW's moments) with tensor leaves, as the port's parameters: each
    layer's entry indexes the scan stacks (views, no copy)."""
    blocks = layers_from_stacked(tree, cfg)
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree holds {len(blocks)} layers, config "
                         f"{cfg.n_layers}")
    p = {k: tree[k] for k in ("embed", "final_norm", "head") if k in tree}
    p["blocks"] = blocks
    return p


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig,
                      device: DeviceLike = None) -> dict:
    """``params_from_stacked`` of the reference's tree with numpy leaves,
    every leaf (``*_theta`` / ``*_sign`` included) in its own dtype on
    ``device`` (the card unless named)."""
    return params_from_stacked(
        NN.tree_from_numpy(tree, resolve_device(device)), cfg)


def train_state_from_numpy(state: Dict[str, Any], cfg: LMConfig,
                           device: DeviceLike = None) -> dict:
    """The reference's LM train state ``{"params", "opt"}`` (AdamW's
    ``OptState(step, mu, nu)``), leaves converted to numpy, as the
    port's: params and both moments through ``params_from_numpy``."""
    from repro_torch.optim.adamw import OptState

    device = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], cfg, device),
            "opt": OptState(
                step=torch.as_tensor(np.array(opt.step),
                                     dtype=torch.int32).to(device),
                mu=params_from_numpy(opt.mu, cfg, device),
                nu=params_from_numpy(opt.nu, cfg, device))}


def params_to_stacked(params: dict, cfg: LMConfig) -> dict:
    """The inverse of ``params_from_stacked``: the port's parameters (or a
    tree of their shape) in the reference's layout, each period
    position's layers stacked on a leading group axis (``torch.stack``,
    so on the parameters' device)."""
    tree = {k: params[k] for k in ("embed", "final_norm", "head")
            if k in params}
    tree.update(layers_to_stacked(params["blocks"], cfg, torch.stack))
    return tree


def train_state_to_stacked(state: dict, cfg: LMConfig) -> dict:
    """The port's LM train state in the reference's layout (params and
    both AdamW moments through ``params_to_stacked``): what an LM
    checkpoint holds, so that the reference's ``restore_checkpoint``
    reads it leaf for leaf."""
    opt = state["opt"]
    return {"params": params_to_stacked(state["params"], cfg),
            "opt": opt._replace(mu=params_to_stacked(opt.mu, cfg),
                                nu=params_to_stacked(opt.nu, cfg))}


def train_state_from_stacked(tree: dict, cfg: LMConfig) -> dict:
    """The inverse of ``train_state_to_stacked``: a restored checkpoint
    as the port's train state (params and moments through
    ``params_from_stacked``)."""
    opt = tree["opt"]
    return {"params": params_from_stacked(tree["params"], cfg),
            "opt": opt._replace(mu=params_from_stacked(opt.mu, cfg),
                                nu=params_from_stacked(opt.nu, cfg))}


def checkpoint_layout(cfg: LMConfig):
    """``runtime.Trainer``'s ``layout`` for an LM train state: its
    checkpoints hold the reference's stacked layout."""
    return (lambda state: train_state_to_stacked(state, cfg),
            lambda tree: train_state_from_stacked(tree, cfg))


def _embed(cfg: LMConfig, params: dict,
           inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> embeddings; a stub frontend's precomputed
    (B, S, D) embeddings go straight through."""
    if inputs.dim() == 3:
        return inputs.to(cfg.dtype)
    return params["embed"]["table"][inputs.long()]


def _unembed(cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (x @ params["embed"]["table"].T).float()
    return (x @ params["head"]["w"]).float()


def _run_blocks(params: dict, cfg: LMConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict],
                remat: bool = False):
    """Every block in layer order -> (x, new cache, the MoE blocks'
    load-balancing terms summed in layer order from 0.0; a Python 0.0
    when no block is MoE).  With ``remat`` (and gradients on) each whole
    period after the prefix runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its period body): its activations
    are recomputed in the backward pass instead of kept."""
    kinds, blocks = cfg.kinds, params["blocks"]
    if cache is None and remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        def run(x, lo, hi):
            total = 0.0
            for i in range(lo, hi):
                x, _, aux = block_apply(cfg, kinds[i], blocks[i], x,
                                        positions, None)
                total = total + aux
            return x, total

        n_pre, P = len(cfg.prefix), len(cfg.pattern)
        end = n_pre + cfg.n_scan_groups * P
        x, total = run(x, 0, n_pre)
        for lo in range(n_pre, end, P):
            x, aux = checkpoint(run, x, lo, lo + P, use_reentrant=False)
            total = total + aux
        x, aux = run(x, end, cfg.n_layers)
        return x, None, total + aux
    new_blocks, total = [], 0.0
    for i, (kind, bp) in enumerate(zip(kinds, blocks)):
        bc = cache["blocks"][i] if cache is not None else None
        x, nc, aux = block_apply(cfg, kind, bp, x, positions, bc)
        new_blocks.append(nc)
        total = total + aux
    return x, ({"blocks": new_blocks} if cache is not None else None), total


def forward(params: dict, cfg: LMConfig, inputs: torch.Tensor,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S) or stub embeddings (B, S, D)
    -> (logits float32 (B, S, V), the MoE blocks' summed load-balancing
    term, a float32 0-d tensor, 0 without MoE), as the reference
    returns.  Carries gradients."""
    x = _embed(cfg, params, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_blocks(params, cfg, x, positions, None, remat)
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = _unembed(cfg, params, x)
    if not isinstance(aux, torch.Tensor):
        aux = logits.new_zeros(())
    return logits, aux


@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, inputs: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, dict]:
    """Run the prompt (B, S) and build the decode state.  Returns
    (last-token logits (B, V), cache)."""
    x = _embed(cfg, params, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    x, new_cache, _ = _run_blocks(params, cfg, x, positions, cache)
    xl = _norm_apply(cfg, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, xl)[:, 0], new_cache


@torch.no_grad()
def decode_step(params: dict, cfg: LMConfig, cache: dict,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode: token (B, 1) (or stub (B, 1, D)) at position
    ``pos`` (an int, or a 0-d tensor).  Returns (logits (B, V), cache)."""
    x = _embed(cfg, params, token)
    positions = NN.slot_index(pos, x.device)
    x, new_cache, _ = _run_blocks(params, cfg, x, positions, cache)
    x = _norm_apply(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], new_cache


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Per-token NLL in float32: logsumexp minus the label's logit (a
    gather; the reference selects it with an iota mask, the same
    number)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def lm_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, remat: bool = True,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token NLL plus ``aux_weight`` times the MoE
    load-balancing term; metrics ``loss`` (the NLL) and ``aux``."""
    logits, aux = forward(params, cfg, tokens, remat=remat)
    loss = torch.mean(softmax_xent(logits, labels))
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def sparsity_config(cfg: LMConfig):
    from repro_torch.core.sparse_train import SparsityConfig

    return SparsityConfig(
        target_fan_in=cfg.sparse_fan_in or max(cfg.d_model // 8, 1),
        phase_boundary=cfg.sparse_phase_T)


def theta_leaves(params: dict) -> List[Tuple[int, str]]:
    """(layer, name) of every ``*_theta`` leaf of the sparse FFN."""
    return [(i, name) for i, bp in enumerate(params["blocks"])
            for name in sorted(bp.get("ffn", {})) if name.endswith("_theta")]


def control_seed(cfg: LMConfig, layer: int, name: str, step: int) -> int:
    """A seed that is the same in every process: CRC-32 of the leaf's
    path in the reference's tree, the layer and the step."""
    site, _ = reference_site(cfg, layer)
    key = f"{site}/['ffn']/['{name}']|layer {layer}|step {int(step)}"
    return zlib.crc32(key.encode())


def control_draws(cfg: LMConfig, params: dict, step
                  ) -> Dict[Tuple[int, str], Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Each theta leaf's (normal, uniform) draws for control step
    ``step``, from a generator on the leaf's device seeded by
    ``control_seed`` (reads ``step`` on the host)."""
    step = int(step)
    out = {}
    for i, name in theta_leaves(params):
        theta = params["blocks"][i]["ffn"][name]
        gen = torch.Generator(device=theta.device).manual_seed(
            control_seed(cfg, i, name, step))
        normal = torch.randn(theta.shape, generator=gen,
                             device=theta.device, dtype=torch.float32)
        u = torch.rand(theta.shape, generator=gen, device=theta.device,
                       dtype=torch.float32)
        out[(i, name)] = (normal, u)
    return out


def apply_sparse_control(params: dict, cfg: LMConfig, step, lr: float,
                         draws: Optional[Dict] = None) -> dict:
    """SparseLUT on the LM: the paper's Alg.-2 controller on every
    ``*_theta`` FFN leaf (prune by sign flip and penalty, regrow, hold
    each hidden unit's fan-in to F_o), with theta-recency regrowth as in
    the reference (no gradient is passed).  ``draws[(layer, name)] =
    (normal, u)`` are the leaf's draws (``control_draws`` makes them
    when not given).  Returns new params; the given ones are left as
    they were."""
    from repro_torch.core.sparse_train import sparse_control

    leaves = theta_leaves(params)
    if not leaves:
        return params
    scfg = sparsity_config(cfg)
    if draws is None:
        draws = control_draws(cfg, params, step)
    blocks = list(params["blocks"])
    for i, name in leaves:
        normal, u = draws[(i, name)]
        ffn = dict(blocks[i]["ffn"])
        ffn[name] = sparse_control(ffn[name], normal, u, step, scfg, lr)
        blocks[i] = {**blocks[i], "ffn": ffn}
    return {**params, "blocks": blocks}


def _tree_rebuild(tree, leaves):
    from repro_torch.optim.adamw import tree_map

    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(loss_fn, params) -> Tuple[Dict, Any]:
    """``loss_fn(params) -> (total, metrics)`` differentiated with respect
    to every leaf of ``params`` -> (metrics detached, gradients as a tree
    of ``params``' shape; zeros for a leaf the loss does not reach)."""
    from repro_torch.optim.adamw import tree_leaves

    req = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(_tree_rebuild(params, req))
        grads = torch.autograd.grad(total, req, allow_unused=True)
    grads = [torch.zeros_like(r) if g is None else g
             for r, g in zip(req, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            _tree_rebuild(params, grads))


def make_train_step(cfg: LMConfig, optimizer, remat: bool = True,
                    grad_clip: float = 1.0, lr_for_sparse: float = 1e-3,
                    accum: int = 1):
    """-> (init_state, step).  ``init_state(generator, device=None)``
    draws ``{params, opt}`` on ``device`` (the card unless named);
    ``step(state, batch, draws=None)`` -> (new state, metrics).

    The step returns new tensors and leaves the state it is given as it
    was (the reference's ``Trainer`` rolls back by keeping it).  It
    differentiates every leaf of ``params``, clips the global norm,
    applies the optimizer and, with ``sparse_ffn``, the sparse control
    at the optimizer's new step (``draws`` as ``apply_sparse_control``
    takes them).  ``accum > 1`` splits the batch into that many
    micro-batches and averages their gradients, summed in float32;
    ``remat`` recomputes each period's activations in the backward pass.
    Metrics are device tensors: ``loss``, ``aux``, ``grad_norm``.

    The WKV kernel has no backward, so RWKV blocks train through the
    plain chunked WKV: the step runs ``cfg`` with ``use_wkv_kernel``
    off."""
    from repro_torch.optim.adamw import (apply_updates, clip_by_global_norm,
                                         tree_map)

    opt_init, opt_update = optimizer
    cfg = dataclasses.replace(cfg, use_wkv_kernel=False)

    def init_state(generator: torch.Generator, device: DeviceLike = None):
        params = init_params(cfg, generator, device)
        return {"params": params, "opt": opt_init(params)}

    def grads_of(params, batch):
        return value_and_grad(
            lambda p: lm_loss(p, cfg, batch["tokens"], batch["labels"],
                              remat=remat), params)

    def step(state, batch, draws=None):
        params = state["params"]
        if accum <= 1:
            metrics, grads = grads_of(params, batch)
        else:
            B = batch["tokens"].shape[0]
            grads = tree_map(lambda p: (p * 0).to(torch.float32), params)
            ms = []
            for a in range(accum):
                mb = {k: v[a * (B // accum):(a + 1) * (B // accum)]
                      for k, v in batch.items()}
                m, g = grads_of(params, mb)
                grads = tree_map(torch.add, grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / accum, grads)
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        updates, new_opt = opt_update(grads, state["opt"], params)
        new_params = apply_updates(params, updates)
        if cfg.sparse_ffn:
            new_params = apply_sparse_control(new_params, cfg, new_opt.step,
                                              lr_for_sparse, draws)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return {"params": new_params, "opt": new_opt}, metrics

    return init_state, step
