"""Architecture registry (port of ``repro.models.registry``): arch id ->
config and the prefill and serve step functions, for the architectures
ported so far.  Any other arch id raises; dry-run input specs, sharding
and the optimizer wait (``ROADMAP.md``, Queue 1 item 8)."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models import lm as LM

ARCHS: Dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
}


def arch_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)} (see ROADMAP.md Queue 1 item 8)")
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


def make_prefill_step(cfg, max_len: int):
    def prefill(params, tokens):
        return LM.prefill(params, cfg, tokens, max_len)
    return prefill


def make_serve_step(cfg):
    """One-token decode against an existing cache."""
    def serve(params, cache, token, pos):
        return LM.decode_step(params, cfg, cache, token, pos)
    return serve
