"""Architecture registry (port of ``repro.models.registry``): arch id ->
config, and the train, prefill and serve step functions of every
architecture the reference registers (decoder-only LMs and the
encoder-decoder).  The dry-run's input specs, ``ShapeSpec`` and
``model_flops`` wait with the dry-run (``ROADMAP.md``, Queue 1 item 6).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM

ARCHS: Dict[str, str] = {
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma3-12b": "gemma3_12b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-tiny": "whisper_tiny",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-3b": "rwkv6_3b",
}


def arch_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, smoke: bool = False):
    mod = arch_module(arch)
    return mod.smoke_config() if smoke else mod.config()


def is_encdec(cfg) -> bool:
    return isinstance(cfg, ED.EncDecConfig)


def param_count(cfg) -> Tuple[int, int]:
    if is_encdec(cfg):
        return ED.param_count(cfg)
    return LM.param_count(cfg)


def _optimizer(cfg, lr: float = 3e-4):
    from repro_torch.optim.adamw import adamw

    return adamw(lr, weight_decay=0.1)


def make_lm_train_step(cfg, remat: bool = True):
    return LM.make_train_step(cfg, _optimizer(cfg), remat=remat)


def make_encdec_train_step(cfg: ED.EncDecConfig):
    """-> (init_state, step), as ``lm.make_train_step``'s: AdamW (lr
    3e-4, weight decay 0.1) after clipping the global norm to 1.0;
    metrics ``loss``, ``grad_norm``."""
    from repro_torch.optim.adamw import apply_updates, clip_by_global_norm

    opt_init, opt_update = _optimizer(cfg)

    def init_state(generator: torch.Generator, device: DeviceLike = None):
        params = ED.init_params(cfg, generator, device)
        return {"params": params, "opt": opt_init(params)}

    def step(state, batch):
        params = state["params"]
        metrics, grads = LM.value_and_grad(
            lambda p: ED.encdec_loss(p, cfg, batch["frames"],
                                     batch["tokens"], batch["labels"]),
            params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, new_opt = opt_update(grads, state["opt"], params)
        metrics["grad_norm"] = gnorm
        return ({"params": apply_updates(params, updates), "opt": new_opt},
                metrics)

    return init_state, step


def make_train_step(cfg, remat: bool = True):
    if is_encdec(cfg):
        return make_encdec_train_step(cfg)
    return make_lm_train_step(cfg, remat=remat)


def make_prefill_step(cfg, max_len: int):
    if is_encdec(cfg):
        @torch.no_grad()
        def prefill(params, frames):
            """Encoder pass and the decoder's cache (``max_target``
            slots): the serving set-up."""
            enc_out = ED.encode(params, cfg, frames)
            return ED.init_dec_cache(params, cfg, enc_out, frames.shape[0],
                                     cfg.max_target)
        return prefill

    def prefill(params, tokens):
        return LM.prefill(params, cfg, tokens, max_len)
    return prefill


def make_serve_step(cfg):
    """One-token decode against an existing cache."""
    if is_encdec(cfg):
        def serve(params, cache, token, pos):
            return ED.decode_step(params, cfg, cache, token, pos)
        return serve

    def serve(params, cache, token, pos):
        return LM.decode_step(params, cfg, cache, token, pos)
    return serve
