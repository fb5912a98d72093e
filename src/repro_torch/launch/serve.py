"""Batched LM serving: one prefill, then one decode step per token
(port of the LM mode of ``repro.launch.serve``).

One prefill builds the recurrent state for the whole batch, then
``serve_step`` decodes token by token, greedily or by sampling at
``--temperature``.  Weights are drawn from a fixed seed (no published
weights are in the repository); inference does the same work whatever
their values.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --full --batch 4 --prompt-len 512 --gen 32          # on the card

The reference's ``--lut`` serving stack is ``repro_torch.launch.
registry``; its command-line mode, ``--kv-int8`` and the fleet flags
are not ported yet (``ROADMAP.md``, Queue 1 item 7).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm as LM
from repro_torch.models import registry as R


def init_lm(arch: str, smoke: bool = True, device: DeviceLike = None,
            seed: int = 0):
    """-> (cfg, params): the arch's config and weights drawn on
    ``device`` from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = R.get_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, LM.init_params(cfg, gen, dev)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int = 0,
                device: DeviceLike = None) -> torch.Tensor:
    """Random token ids (batch, prompt_len) from a numpy seed."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.from_numpy(ids).to(resolve_device(device))


@dataclasses.dataclass
class LMServeResult:
    tokens: torch.Tensor          # (B, gen): the tokens fed to decode
    prefill_s: float              # host clock, prefill to its logits
    decode_s: float               # host clock, all decode steps
    # the prefill's logits then each decode step's, (B, V) float32
    # (kept only when asked for)
    logits: List[torch.Tensor]

    @property
    def tokens_per_s(self) -> float:
        B, gen = self.tokens.shape
        return B * gen / max(self.decode_s, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(params: dict, cfg, prompt: torch.Tensor, gen: int,
             temperature: float = 0.0, seed: int = 1,
             keep_logits: bool = False) -> LMServeResult:
    """Prefill ``prompt`` (B, P), then ``gen`` decode steps, each fed the
    token chosen from the previous logits (argmax, or a sample at
    ``temperature`` from a generator seeded with ``seed``)."""
    dev = prompt.device
    P = prompt.shape[1]
    prefill = R.make_prefill_step(cfg, max_len=P + gen)
    serve = R.make_serve_step(cfg)
    sampler = torch.Generator(device=dev).manual_seed(seed)

    def choose(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return torch.argmax(logits, dim=-1, keepdim=True)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    kept = [logits] if keep_logits else []

    tokens = []
    tok = choose(logits)
    t0 = time.perf_counter()
    for i in range(gen):
        tokens.append(tok)
        logits, cache = serve(params, cache, tok, P + i)
        if keep_logits:
            kept.append(logits)
        tok = choose(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    out = (torch.cat(tokens, dim=1) if tokens
           else torch.zeros((prompt.shape[0], 0), dtype=torch.long,
                            device=dev))
    return LMServeResult(tokens=out, prefill_s=prefill_s,
                         decode_s=decode_s, logits=kept)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b",
                    help=f"architecture id (ported: {sorted(R.ARCHS)})")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg, params = init_lm(args.arch, smoke=args.smoke, device=args.device)
    dev = resolve_device(args.device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, device=dev)
    res = serve_lm(params, cfg, prompt, args.gen,
                   temperature=args.temperature)
    print(f"arch={cfg.name} batch={args.batch} "
          f"prefill={res.prefill_s * 1e3:.1f}ms "
          f"decode={res.decode_s * 1e3:.1f}ms "
          f"({res.tokens_per_s:.1f} tok/s) "
          f"first tokens={res.tokens[0, :8].tolist()}")


if __name__ == "__main__":
    main()
