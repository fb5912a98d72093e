"""End-to-end LM training with the PyTorch + CUDA port (port of
``examples/lm_sparse_train.py``): a decoder-only model of about 50M
parameters (12 layers x 512 d) trained through the fault-tolerant
runtime, with the paper's SparseLUT controller running live on the FFN
(fan-in-constrained up and gate projections, Alg. 2 prune and regrow).

Markov token stream, AdamW with a warm-up cosine schedule, async
checkpoints with crash recovery, the straggler monitor; on the CUDA card
unless ``--device`` names another device.

    PYTHONPATH=src python examples/torch_lm_sparse_train.py \\
        --steps 300 --ckpt-dir /tmp/lm_run
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.data.tokens import lm_batch_iterator, synthetic_token_stream
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.models.lm import LMConfig
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def lm_100m(sparse: bool, steps: int) -> LMConfig:
    """12L x 512d x 8H (kv 4), d_ff 2048, vocab 8k, float32."""
    return LMConfig(
        name="lm-100m-sparse" if sparse else "lm-100m",
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=8192, ffn_kind="swiglu", norm="rms",
        tie_embeddings=True, dtype=torch.float32,
        sparse_ffn=sparse, sparse_fan_in=64,
        sparse_phase_T=int(steps * 0.8))


def optimizer(steps: int):
    return adamw(warmup_cosine(3e-4, 20, steps), weight_decay=0.1)


def batches(cfg: LMConfig, batch: int, seq: int, device):
    stream = synthetic_token_stream(cfg.vocab, 500_000, seed=0)
    return lm_batch_iterator(stream, batch, seq, seed=0, device=device)


def fan_in_lines(cfg: LMConfig, params: dict):
    """(layer, name, min, max) fan-in of every theta leaf."""
    out = []
    for i, name in LM.theta_leaves(params):
        fan = (params["blocks"][i]["ffn"][name] > 0).sum(dim=0)
        out.append((i, name, int(fan.min()), int(fan.max())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dense", action="store_true",
                    help="disable the SparseLUT FFN controller")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "lm_sparse_train_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_100m(sparse=not args.dense, steps=args.steps)
    total, _ = LM.param_count(cfg)
    print(f"{cfg.name}: {total/1e6:.1f}M params, sparse_ffn={cfg.sparse_ffn} "
          f"(F_o={cfg.sparse_fan_in}/{cfg.d_model} inputs per hidden unit), "
          f"device {dev}")

    init_state, step = LM.make_train_step(cfg, optimizer(args.steps),
                                          remat=False)
    state = init_state(torch.Generator(device=dev).manual_seed(0), dev)

    trainer = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100, keep=2),
        step, state, layout=LM.checkpoint_layout(cfg))
    resumed = trainer.try_resume()
    print(f"resumed={resumed} at step {trainer.step}")

    t0 = time.time()
    trainer.run(batches(cfg, args.batch, args.seq, dev), args.steps,
                log_every=25)
    dt = time.time() - t0

    hist = trainer.history
    print(f"\nsteps/s: {trainer.step / dt:.2f}   recoveries: "
          f"{trainer.recoveries}  straggler events: "
          f"{trainer.straggler_events}")
    print("loss trace:", [round(h["loss"], 3) for h in hist])

    if cfg.sparse_ffn:
        print(f"FFN fan-in after training (target {cfg.sparse_fan_in}, "
              f"Alg. 2 enforced live):")
        for i, name, lo, hi in fan_in_lines(cfg, trainer.state["params"]):
            print(f"  layer {i:2d} {name:12s} min={lo} max={hi}")
    return trainer


if __name__ == "__main__":
    main()
