"""Open-loop arrival schedules, timed from each request's due time.

The Poisson schedule of the port's ``launch/batching.replay_open_loop``
(exponential gaps at ``rate`` requests a second, drawn from the seed),
with its timing rewritten: a request's latency runs from when it was
due, not from when the generator got round to sending it, so a stall
that delays later sends counts against them; and the generator's own
lateness is reported beside.  No cell of the benchmark serves requests
as they arrive yet; the driver of such a kind of traffic
(``bench/drivers/<kind>.py``) sends on this schedule.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np


def poisson_offsets(rate: float, n: int, seed: int) -> np.ndarray:
    """Due times of ``n`` requests, in seconds after the start."""
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, n)
    return np.cumsum(gaps)


def send_on_schedule(submit: Callable, items: Sequence,
                     offsets: np.ndarray,
                     clock: Callable[[], float] = time.perf_counter,
                     sleep: Callable[[float], None] = time.sleep
                     ) -> Tuple[float, List[float], list]:
    """Call ``submit(item)`` for each item at ``t0 + offsets[i]``;
    return ``(t0, sent, handles)``, ``sent[i]`` the clock when item i
    went.  An item already due goes at once."""
    t0 = clock()
    sent, handles = [], []
    for item, off in zip(items, offsets):
        wait = t0 + off - clock()
        if wait > 0:
            sleep(wait)
        sent.append(clock())
        handles.append(submit(item))
    return t0, sent, handles


def due_latencies(t0: float, offsets: np.ndarray,
                  done: Sequence[float]) -> np.ndarray:
    """Each request's latency from its due time to ``done[i]``."""
    return np.asarray(done, float) - (t0 + np.asarray(offsets, float))


def lateness(t0: float, offsets: np.ndarray,
             sent: Sequence[float]) -> np.ndarray:
    """How late the generator sent each request (>= 0 up to the
    clock's grain)."""
    return np.asarray(sent, float) - (t0 + np.asarray(offsets, float))
