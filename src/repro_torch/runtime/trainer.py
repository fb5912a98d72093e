"""Fault-tolerant training runner (port of ``repro.runtime.trainer``).

* periodic async checkpointing (atomic, keep-N);
* crash and preemption recovery: an exception in the step function
  rolls the state back to the last checkpoint and replays, with a
  bounded retry budget so a deterministic bug does not loop forever;
* a NaN loss counts as a failure;
* straggler detection (``runtime/straggler.py``): on detection the
  trainer checkpoints eagerly so a reschedule loses no work;
* resume: ``try_resume`` restores the newest checkpoint into the
  current state's structure and devices.

A ``layout`` pair ``(to_saved, from_saved)`` maps the state to the tree
a checkpoint holds and back (``models.lm.checkpoint_layout`` gives an
LM's the reference's stacked layout); without one the state is saved as
it is.

The step function is any ``(state, batch) -> (state, metrics)`` that
returns a new state and leaves the one it was given as it was (as the
port's ``models.lm.make_train_step`` does): a failed step then leaves
``self.state`` untouched.  Reading a metric, and the NaN test, wait for
the device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.runtime")


def _same(tree: Any) -> Any:
    return tree


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    max_retries: int = 3
    straggler_threshold: float = 3.0
    eager_ckpt_on_straggler: bool = True


class Trainer:
    def __init__(self, cfg: TrainerConfig,
                 step_fn: Callable[[Any, Any], Any],
                 state: Any,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 layout: Optional[Tuple[Callable[[Any], Any],
                                        Callable[[Any], Any]]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.manager = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.ckpt = AsyncCheckpointer(self.manager)
        self.monitor = StragglerMonitor(threshold=cfg.straggler_threshold)
        self.failure_hook = failure_hook   # test injection point
        self.to_saved, self.from_saved = layout or (_same, _same)
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.recoveries = 0
        self.straggler_events = 0

    # -- checkpoint/restore -------------------------------------------------
    def save(self) -> None:
        self.ckpt.save(self.step, {"state": self.to_saved(self.state),
                                   "step": self.step})

    def try_resume(self, shardings: Any = None) -> bool:
        """Returns True if a checkpoint was restored."""
        try:
            tree, step = self.manager.restore_latest(
                {"state": self.to_saved(self.state), "step": 0}, shardings)
        except FileNotFoundError:
            return False
        self.state = self.from_saved(tree["state"])
        self.step = int(tree["step"])
        log.info("resumed at step %d", self.step)
        return True

    # -- main loop ------------------------------------------------------------
    def run(self, batches: Iterator[Any], n_steps: int,
            log_every: int = 50) -> Any:
        retries = 0
        while self.step < n_steps:
            batch = next(batches)
            self.monitor.start()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(self.step)
                new_state, metrics = self.step_fn(self.state, batch)
                # surface NaNs as failures rather than silent divergence
                loss = metrics.get("loss")
                if loss is not None and bool(torch.isnan(
                        torch.as_tensor(loss))):
                    raise FloatingPointError(f"NaN loss at step {self.step}")
            except Exception as e:  # noqa: BLE001 — fault tolerance boundary
                retries += 1
                self.recoveries += 1
                log.warning("step %d failed (%s); recovery %d/%d",
                            self.step, e, retries, self.cfg.max_retries)
                if retries > self.cfg.max_retries:
                    raise
                self.ckpt.wait()
                if not self.try_resume():
                    log.warning("no checkpoint yet; restarting from step 0 "
                                "state kept in memory")
                continue
            retries = 0
            self.state = new_state
            self.step += 1
            if self.monitor.stop():
                self.straggler_events += 1
                log.warning("straggler detected at step %d "
                            "(median %.4fs)", self.step, self.monitor.median)
                if self.cfg.eager_ckpt_on_straggler:
                    self.save()
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
            if self.step % log_every == 0:
                self.history.append(
                    {k: float(v) for k, v in metrics.items()})
        self.ckpt.wait()
        return self.state
