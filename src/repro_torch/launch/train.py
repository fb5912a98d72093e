"""End-to-end training launcher (port of ``repro.launch.train``).

Runs a ported architecture (``--arch``; its reduced ``--smoke`` config
by default, ``--full`` for the published widths) through the
fault-tolerant runtime: synthetic Markov-token batches, AdamW, the
optional SparseLUT fan-in-sparse FFN (the paper's Alg.-2 controller),
periodic async checkpoints, crash recovery and the straggler monitor.
It runs on the CUDA card unless ``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 200 --sparse-ffn --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 20

Every registered architecture trains, the encoder-decoder (whisper) on
random frames and tokens drawn as the reference draws them; an MoE
model's load-balancing term is printed as ``aux``.  Checkpoints are in
the reference's layout: its ``restore_checkpoint`` reads them.  The
reference's docstring names a ``--mesh`` flag that its parser does not
have, so this launcher has none either.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.data.tokens import lm_batch_iterator, synthetic_token_stream
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.models import registry as R
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def batches_for(cfg, batch_size: int, seq_len: int, seed: int = 0,
                device=None):
    if R.is_encdec(cfg):
        def gen():
            # the reference's numpy draws, in its order
            rng = np.random.default_rng(seed)
            while True:
                frames = rng.normal(size=(batch_size, seq_len, cfg.d_model)
                                    ).astype(np.float32)
                toks = rng.integers(0, cfg.vocab,
                                    (batch_size, min(cfg.max_target, 32)))
                toks = torch.from_numpy(toks).to(device=device,
                                                 dtype=torch.int32)
                yield {"frames": torch.from_numpy(frames).to(
                           device=device, dtype=torch.bfloat16),
                       "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        return gen()
    stream = synthetic_token_stream(cfg.vocab, 200_000, seed=seed)
    return lm_batch_iterator(stream, batch_size, seq_len, seed=seed,
                             device=device)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sparse-ffn", action="store_true",
                    help="enable the SparseLUT fan-in-sparse FFN")
    ap.add_argument("--sparse-fan-in", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = R.get_config(args.arch, smoke=args.smoke)
    if args.sparse_ffn and not R.is_encdec(cfg):
        cfg = dataclasses.replace(
            cfg, sparse_ffn=True, sparse_fan_in=args.sparse_fan_in,
            sparse_phase_T=int(args.steps * 0.8))

    init_state, step = R.make_train_step(cfg, remat=False)
    state = init_state(torch.Generator(device=dev).manual_seed(0), dev)

    # an LM's checkpoints hold the reference's stacked layout, which its
    # restore_checkpoint reads; the encoder-decoder's trees already match
    layout = None if R.is_encdec(cfg) else LM.checkpoint_layout(cfg)
    trainer = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        step, state, layout=layout)
    trainer.try_resume()

    data = batches_for(cfg, args.batch, args.seq, device=dev)
    t0 = time.time()
    trainer.run(data, args.steps, log_every=args.log_every)
    dt = time.time() - t0
    last = trainer.history[-1] if trainer.history else {}
    aux = f" aux={last['aux']:.4f}" if last.get("aux") else ""
    print(f"arch={cfg.name} device={dev} steps={trainer.step} "
          f"time={dt:.1f}s loss={last.get('loss', float('nan')):.4f}{aux} "
          f"recoveries={trainer.recoveries}")
    return trainer


if __name__ == "__main__":
    main()
