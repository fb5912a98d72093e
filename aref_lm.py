#!/usr/bin/env python3
"""Reference loss of the ``[lm_train]`` phase of ``chip_smoke.py``.

Trains the model of ``examples/lm_sparse_train.py`` (12 layers x 512 d,
8 heads with kv 4, d_ff 2048, vocab 8192, float32, SparseLUT FFN with
F_o = 64) with the JAX package exactly as that phase trains it with the
port: 100 steps at B=8 x 128 of the example's Markov token batches
(``synthetic_token_stream(8192, 500_000, seed=0)``, batch order 0),
AdamW with ``warmup_cosine(3e-4, 20, 100)`` and weight decay 0.1,
``sparse_phase_T`` 80, through the reference's ``Trainer`` with a
checkpoint every 25 steps and one injected failure at step 40 (so the
rollback to step 25 replays on the same later batches as the port's
run).  One run per seed of ``jax.random.key``, which draws the initial
weights (the port's run starts from its own draws, so only the loss
level compares, not the trajectory).

It prints each seed's mean loss over the last 10 steps, their mean
(``L_REF``) and their spread, as a JSON line; ``chip_smoke.py`` holds
the port to L_REF within the larger of 0.05 nats and 3x that spread.
The reference seeds its sparse-control draws from Python's salted
``hash()``; run it with ``PYTHONHASHSEED=0`` to repeat a run exactly.

    PYTHONHASHSEED=0 PYTHONPATH=src:examples JAX_PLATFORMS=cpu \\
        python aref_lm.py --seeds 0 1 --jobs 2

A step of the JAX package takes about a minute on the CPU (most of it
XLA's sorts in the controller), so two seeds take about two hours with
``--jobs 2`` on six cores.
"""
import argparse
import json
import multiprocessing
import tempfile
import time

import jax
import numpy as np

import lm_sparse_train as EX
from repro.data.tokens import lm_batch_iterator, synthetic_token_stream
from repro.models import lm as LM
from repro.optim.adamw import adamw
from repro.optim.schedules import warmup_cosine
from repro.runtime.trainer import Trainer, TrainerConfig

STEPS, BATCH, SEQ = 100, 8, 128
CKPT_EVERY, FAIL_AT = 25, 40


def run(seed: int) -> dict:
    cfg = EX.lm_100m(sparse=True, steps=STEPS)
    opt = adamw(warmup_cosine(3e-4, 20, STEPS), weight_decay=0.1)
    init_state, step = LM.make_train_step(cfg, opt, remat=False)
    state = init_state(jax.random.key(seed))
    failed = {"done": False}

    def hook(s):
        if s == FAIL_AT and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("injected failure")

    stream = synthetic_token_stream(cfg.vocab, 500_000, seed=0)
    batches = lm_batch_iterator(stream, BATCH, SEQ, seed=0)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(TrainerConfig(ckpt_dir=d, ckpt_every=CKPT_EVERY,
                                   keep=2), jax.jit(step), state,
                     failure_hook=hook)
        tr.run(batches, STEPS, log_every=1)
    losses = [h["loss"] for h in tr.history]
    # history holds one entry a completed step, replays included: the
    # last 10 entries are steps 91-100
    return {"seed": seed, "last10": float(np.mean(losses[-10:])),
            "first": losses[0], "recoveries": tr.recoveries,
            "seconds": time.time() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--jobs", type=int, default=1,
                    help="seeds run at once, each in its own process")
    args = ap.parse_args()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs) as pool:
            runs = pool.map(run, args.seeds)
        for r in runs:
            print(json.dumps(r), flush=True)
    else:
        runs = []
        for seed in args.seeds:
            r = run(seed)
            print(json.dumps(r), flush=True)
            runs.append(r)
    last = [r["last10"] for r in runs]
    print(json.dumps({"L_REF": float(np.mean(last)),
                      "spread": float(max(last) - min(last)),
                      "seeds": args.seeds}))


if __name__ == "__main__":
    main()
