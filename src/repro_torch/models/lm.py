"""Decoder-only LM (port of ``repro.models.lm``), for the blocks ported
so far: RWKV6 time mix paired with RWKV channel mix (``("rwkv",
"rwkv_cm")``, the rwkv6 family).  Attention, RG-LRU, dense-FFN and MoE
blocks, LM training and the int8 KV cache wait (``ROADMAP.md``, Queue 1
item 8); asking for them raises ``NotImplementedError``.

Parameters are plain dictionaries of tensors with one entry per layer
(``params["blocks"]``), run by a plain loop: the reference stacks layers
by period for ``jax.lax.scan``, which PyTorch's eager execution does not
need.  ``params_from_numpy`` unstacks the reference's parameter tree
into this layout, so both packages can run the same weights.

Modes, as in the reference: ``forward`` (no state), ``prefill`` (runs
the prompt and returns the decode state) and ``decode_step`` (one token
against that state).  On CUDA tensors each time mix sends its WKV
through the CUDA kernel (``kernels/wkv6``) unless ``use_wkv_kernel`` is
off, which sends it through the plain chunked form, as CPU tensors
always go.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as NN
from repro_torch.models import recurrent as RC

PORTED_KINDS = (("rwkv", "rwkv_cm"),)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                        # head size is d_model // n_heads
    d_ff: int
    vocab: int
    # block pattern, cycled over post-prefix layers: (mixer, channel)
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    prefix: Tuple[Tuple[str, str], ...] = ()
    norm: str = "rms"                   # rms | ln
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # WKV of CUDA tensors through the CUDA kernel (False: the plain
    # chunked form, the kernel's yardstick on the card)
    use_wkv_kernel: bool = True

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


def _check_kind(kind: Tuple[str, str]) -> None:
    if tuple(kind) not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind} is not ported yet (ported: "
            f"{PORTED_KINDS}); see ROADMAP.md Queue 1 item 8")


def param_count(cfg: LMConfig) -> Tuple[int, int]:
    """(total, active) parameter counts, as the reference counts them."""
    D = cfg.d_model
    total = cfg.vocab * D                                # embed
    if not cfg.tie_embeddings:
        total += D * cfg.vocab
    for kind in cfg.kinds:
        _check_kind(kind)
        total += 5 * D * D + 2 * D * 64                  # proj + decay lora
        total += 2 * D * cfg.d_ff + D * D                # channel mix
    return total, total


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
    return {"norm1": _norm_init(cfg, cfg.d_model, device),
            "norm2": _norm_init(cfg, cfg.d_model, device),
            "rwkv": RC.rwkv_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.d_ff, dtype=cfg.dtype, device=device)}


def block_cache_init(cfg: LMConfig, kind: Tuple[str, str], batch: int,
                     max_len: int, device: DeviceLike = None) -> dict:
    """Decode-time state of one block (O(1) in ``max_len`` for RWKV), on
    ``device`` (the card unless named)."""
    _check_kind(kind)
    device = resolve_device(device)
    return RC.rwkv_state_init(batch, cfg.d_model, cfg.n_heads, cfg.dtype,
                              device=device)


def block_apply(cfg: LMConfig, kind: Tuple[str, str], p: dict,
                x: torch.Tensor, cache: Optional[dict]
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One block.  ``cache`` None: forward, new cache None; given: the
    prompt (S > 1) or one decode token (S == 1) continues from it."""
    _check_kind(kind)
    h = _norm_apply(cfg, p["norm1"], x)
    a, new_mix = RC.rwkv_time_mix(p["rwkv"], cfg.n_heads, h, cache,
                                  use_kernel=cfg.use_wkv_kernel)
    x = x + a
    h2 = _norm_apply(cfg, p["norm2"], x)
    f, cm_new = RC.rwkv_channel_mix(p["rwkv"], h2, cache)
    new_cache = {**new_mix, **cm_new} if cache is not None else None
    return x + f, new_cache


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
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(cfg.dtype)

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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes; exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    return _tensor(node, device)


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig,
                      device: DeviceLike = None) -> dict:
    """The reference's ``init_params`` tree, its leaves converted to
    numpy, as the port's parameters: the scan stacks unstacked into one
    entry per layer, every leaf in its own dtype on ``device`` (the card
    unless named)."""
    device = resolve_device(device)
    blocks = layers_from_stacked(tree, cfg)
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree holds {len(blocks)} layers, config "
                         f"{cfg.n_layers}")
    p = {k: _to_torch(tree[k], device) for k in ("embed", "final_norm",
                                                   "head") if k in tree}
    p["blocks"] = [_to_torch(b, device) for b in blocks]
    return p


def _embed(cfg: LMConfig, params: dict,
           inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, D)."""
    return params["embed"]["table"][inputs.long()]


def _unembed(cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (x @ params["embed"]["table"].T).float()
    return (x @ params["head"]["w"]).float()


def _run_blocks(params: dict, cfg: LMConfig, x: torch.Tensor,
                cache: Optional[dict]
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    new_blocks = []
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        bc = cache["blocks"][i] if cache is not None else None
        x, nc = block_apply(cfg, kind, bp, x, bc)
        new_blocks.append(nc)
    return x, ({"blocks": new_blocks} if cache is not None else None)


@torch.no_grad()
def forward(params: dict, cfg: LMConfig,
            inputs: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits float32
    (B, S, V)."""
    x, _ = _run_blocks(params, cfg, _embed(cfg, params, inputs), None)
    x = _norm_apply(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)


@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, inputs: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, dict]:
    """Run the prompt (B, S) and build the decode state.  Returns
    (last-token logits (B, V), cache)."""
    x = _embed(cfg, params, inputs)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    x, new_cache = _run_blocks(params, cfg, x, cache)
    xl = _norm_apply(cfg, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, xl)[:, 0], new_cache


@torch.no_grad()
def decode_step(params: dict, cfg: LMConfig, cache: dict,
                token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: token (B, 1) at position ``pos`` (which the
    recurrent state does not need; kept for the attention blocks to
    come).  Returns (logits (B, V), new cache)."""
    x = _embed(cfg, params, token)
    x, new_cache = _run_blocks(params, cfg, x, cache)
    x = _norm_apply(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], new_cache
