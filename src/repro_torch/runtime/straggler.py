"""Straggler detection (port of ``repro.runtime.straggler``; pure Python).

A single controller hides per-host timing inside collectives, so the
observable signal is the *step wall time*: a straggling host slows every
step it participates in.  We keep an EWMA + robust deviation of step
times and flag steps that exceed ``threshold`` times the running
median.  On a real cluster the hook triggers mitigation: the runner
checkpoints, reports the slow host to the scheduler, and restarts on a
healthy slice (see Trainer.on_straggler).  Detection logic is fully
testable on CPU by injecting synthetic delays.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Deque, List, Optional


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 warmup: int = 5):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.flagged: List[int] = []
        self._step = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record one step; returns True if this step looks straggled."""
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append(self._step)
        self.times.append(dt)
        return is_straggler

    def observe(self, dt: float) -> bool:
        """Test/offline path: feed a duration directly."""
        self._t0 = time.perf_counter() - dt
        return self.stop()

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
