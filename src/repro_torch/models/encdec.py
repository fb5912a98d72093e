"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv audio frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, S_audio, D).  Positions are
learned tables (``pos_enc`` of ``max_source`` rows, ``pos_dec`` of
``max_target``, which decoder positions wrap modulo).

The decoder runs teacher-forced (``decode_train``) or one token at a
time (``decode_step``) against ``init_dec_cache``: a self-attention KV
cache per layer, written in place, and the cross-attention K and V
computed once from the encoder's output.  All attention is
``layers.attn_apply`` / ``layers.attention``: plain matmuls, no kernel.

Parameters are the reference's tree (``enc`` and ``dec`` are lists of
layers); ``params_from_numpy`` carries the reference's parameters, or a
tree of their shape, across leaf for leaf.

``encode`` raises ``ValueError`` for more frames than ``max_source``;
the reference fails there on a broadcast (``ROADMAP.md``, Queue 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as NN
from repro_torch.models import lm as LM
from repro_torch.models.layers import AttnSpec


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    max_source: int = 1500          # whisper: 30 s of 20 ms frames
    max_target: int = 448
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_spec(self, causal: bool) -> AttnSpec:
        return AttnSpec(d_model=self.d_model, n_heads=self.n_heads,
                        n_kv_heads=self.n_heads, head_dim=self.head_dim,
                        qkv_bias=True, causal=causal, use_rope=False)


def param_count(cfg: EncDecConfig) -> Tuple[int, int]:
    D = cfg.d_model
    attn = 4 * D * D
    ffn = 2 * D * cfg.d_ff
    enc = cfg.n_enc_layers * (attn + ffn)
    dec = cfg.n_dec_layers * (2 * attn + ffn)
    total = enc + dec + cfg.vocab * D + (cfg.max_source + cfg.max_target) * D
    return total, total


def _ln_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return NN.layer_norm(x, p["scale"], p["bias"])


def init_params(cfg: EncDecConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Fresh weights drawn from ``generator`` on ``device`` (the card
    unless named): the reference's tree, shapes, scales and dtypes."""
    device = resolve_device(device)
    D = cfg.d_model

    def normal(shape, scale):
        return NN._normal(generator, shape, scale, cfg.dtype, device)

    def attn(causal):
        return NN.attn_init(generator, cfg.attn_spec(causal), cfg.dtype,
                            device)

    def ffn():
        return NN.ffn_init(generator, D, cfg.d_ff, "gelu", cfg.dtype,
                           device=device)

    return {
        "embed": {"table": normal((cfg.vocab, D), 1.0 / math.sqrt(D))},
        "pos_enc": normal((cfg.max_source, D), 0.01),
        "pos_dec": normal((cfg.max_target, D), 0.01),
        "enc": [{"ln1": _ln_init(D, device), "attn": attn(False),
                 "ln2": _ln_init(D, device), "ffn": ffn()}
                for _ in range(cfg.n_enc_layers)],
        "dec": [{"ln1": _ln_init(D, device), "self_attn": attn(True),
                 "ln_x": _ln_init(D, device), "cross_attn": attn(False),
                 "ln2": _ln_init(D, device), "ffn": ffn()}
                for _ in range(cfg.n_dec_layers)],
        "ln_enc": _ln_init(D, device),
        "ln_dec": _ln_init(D, device),
    }


def params_from_numpy(tree: Dict[str, Any], cfg: EncDecConfig,
                      device: DeviceLike = None) -> dict:
    """The reference's ``init_params`` tree (or one of its shape, such as
    AdamW's moments), leaves converted to numpy, as the port's: the
    same tree, each leaf in its own dtype on ``device`` (the card unless
    named)."""
    if len(tree["enc"]) != cfg.n_enc_layers or \
            len(tree["dec"]) != cfg.n_dec_layers:
        raise ValueError(f"tree holds {len(tree['enc'])} + "
                         f"{len(tree['dec'])} layers, config "
                         f"{cfg.n_enc_layers} + {cfg.n_dec_layers}")
    return NN.tree_from_numpy(tree, resolve_device(device))


def encode(params: dict, cfg: EncDecConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_audio, D), precomputed frame embeddings (the stub
    frontend) -> the encoder's output (B, S_audio, D)."""
    S = frames.shape[1]
    if S > cfg.max_source:
        raise ValueError(f"{S} frames, but the learned positional table "
                         f"holds max_source = {cfg.max_source}")
    x = frames.to(cfg.dtype) + params["pos_enc"][:S]
    positions = torch.arange(S, device=x.device)
    spec = cfg.attn_spec(False)
    for lp in params["enc"]:
        h, _ = NN.attn_apply(lp["attn"], spec, _ln(lp["ln1"], x), positions)
        x = x + h
        x = x + NN.ffn_apply(lp["ffn"], "gelu", _ln(lp["ln2"], x))
    return _ln(params["ln_enc"], x)


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["embed"]["table"].T).float()


def decode_train(params: dict, cfg: EncDecConfig, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens (B, S_t) -> logits float32
    (B, S_t, V)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = params["embed"]["table"][tokens.long()] \
        + params["pos_dec"][torch.remainder(positions, cfg.max_target)]
    self_spec, cross_spec = cfg.attn_spec(True), cfg.attn_spec(False)
    for lp in params["dec"]:
        h, _ = NN.attn_apply(lp["self_attn"], self_spec, _ln(lp["ln1"], x),
                             positions)
        x = x + h
        h, _ = NN.attn_apply(lp["cross_attn"], cross_spec,
                             _ln(lp["ln_x"], x), positions, kv_x=enc_out)
        x = x + h
        x = x + NN.ffn_apply(lp["ffn"], "gelu", _ln(lp["ln2"], x))
    return _logits(params, _ln(params["ln_dec"], x))


@torch.no_grad()
def init_dec_cache(params: dict, cfg: EncDecConfig, enc_out: torch.Tensor,
                   batch: int, max_len: int) -> dict:
    """A zero self-attention KV cache of ``max_len`` slots and the
    cross-attention K/V of ``enc_out`` for each decoder layer, on
    ``enc_out``'s device."""
    spec = cfg.attn_spec(False)
    layers = []
    for lp in params["dec"]:
        ca = lp["cross_attn"]
        layers.append({
            "self": NN.attn_cache_init(spec, batch, max_len, cfg.dtype,
                                       enc_out.device),
            "cross_k": NN.proj(enc_out, ca["wk"]) + ca["bk"],
            "cross_v": NN.proj(enc_out, ca["wv"]) + ca["bv"],
        })
    return {"layers": layers}


@torch.no_grad()
def decode_step(params: dict, cfg: EncDecConfig, cache: dict,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode: token (B, 1) at position ``pos`` (an int or a
    0-d tensor).  Returns (logits (B, V), cache); the self-attention
    caches are written in place."""
    positions = NN.slot_index(pos, token.device)
    x = params["embed"]["table"][token.long()] \
        + params["pos_dec"][torch.remainder(positions, cfg.max_target)][None]
    self_spec = cfg.attn_spec(True)
    new_layers = []
    for lp, lc in zip(params["dec"], cache["layers"]):
        h, nc = NN.attn_apply(lp["self_attn"], self_spec, _ln(lp["ln1"], x),
                              positions, cache=lc["self"])
        x = x + h
        # cross-attention against the precomputed encoder K/V
        ca = lp["cross_attn"]
        q = NN.proj(_ln(lp["ln_x"], x), ca["wq"]) + ca["bq"]
        kv_pos = torch.arange(lc["cross_k"].shape[1], device=x.device)
        o = NN.attention(q, lc["cross_k"], lc["cross_v"], positions, kv_pos,
                         causal=False)
        x = x + NN.attn_out(o, ca["wo"])
        x = x + NN.ffn_apply(lp["ffn"], "gelu", _ln(lp["ln2"], x))
        new_layers.append({"self": nc, "cross_k": lc["cross_k"],
                           "cross_v": lc["cross_v"]})
    logits = _logits(params, _ln(params["ln_dec"], x))
    return logits[:, 0], {"layers": new_layers}


def encdec_loss(params: dict, cfg: EncDecConfig, frames: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token NLL of the teacher-forced decoder; metric
    ``loss``."""
    logits = decode_train(params, cfg, encode(params, cfg, frames), tokens)
    loss = torch.mean(LM.softmax_xent(logits, labels))
    return loss, {"loss": loss}
