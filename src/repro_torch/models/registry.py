"""Architecture registry (port of ``repro.models.registry``): arch id ->
config, and the train, prefill and serve step functions.  The
decoder-only attention and RWKV architectures are ported; the MoE,
RG-LRU and encoder-decoder ones raise, as do dry-run input specs and
sharding (``ROADMAP.md``, Queue 1 item 6)."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models import lm as LM

ARCHS: Dict[str, str] = {
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma3-12b": "gemma3_12b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-3b": "rwkv6_3b",
}

# the reference's other architectures, and what each waits for
UNPORTED: Dict[str, str] = {
    "kimi-k2-1t-a32b": "MoE",
    "granite-moe-1b-a400m": "MoE",
    "recurrentgemma-9b": "RG-LRU",
    "whisper-tiny": "the encoder-decoder",
}


def arch_module(arch: str):
    if arch in UNPORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: it needs "
                       f"{UNPORTED[arch]} (see ROADMAP.md Queue 1 item 6)")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, smoke: bool = False):
    mod = arch_module(arch)
    return mod.smoke_config() if smoke else mod.config()


def is_encdec(cfg) -> bool:
    """Encoder-decoder configs (whisper) are not ported: every config the
    port builds is a decoder-only ``LMConfig``."""
    return not isinstance(cfg, LM.LMConfig)


def param_count(cfg) -> Tuple[int, int]:
    return LM.param_count(cfg)


def _optimizer(cfg, lr: float = 3e-4):
    from repro_torch.optim.adamw import adamw

    return adamw(lr, weight_decay=0.1)


def make_lm_train_step(cfg, remat: bool = True):
    return LM.make_train_step(cfg, _optimizer(cfg), remat=remat)


def make_train_step(cfg, remat: bool = True):
    if is_encdec(cfg):
        raise NotImplementedError("encoder-decoder training is not ported "
                                  "yet (see ROADMAP.md Queue 1 item 6)")
    return make_lm_train_step(cfg, remat=remat)


def make_prefill_step(cfg, max_len: int):
    def prefill(params, tokens):
        return LM.prefill(params, cfg, tokens, max_len)
    return prefill


def make_serve_step(cfg):
    """One-token decode against an existing cache."""
    def serve(params, cache, token, pos):
        return LM.decode_step(params, cfg, cache, token, pos)
    return serve
