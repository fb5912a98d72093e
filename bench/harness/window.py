"""The timed loop: batches issued ahead through the engine, each one's
output codes copied into pinned host memory.

On a card the copies run on a stream of their own, each after its
forward's end, so that a batch's copy overlaps the next batch's forward
as a pipeline that reads results back would have it; the forwards run on
the current stream, as the engine launches them.

Batch ``k`` is input ``pool[k % len(pool)]``, a tensor already on the
device.  At most ``in_flight`` batches are outstanding: before issuing
batch ``k`` the loop waits on batch ``k - in_flight`` (the oldest), and
that wait's end is the oldest batch's completion: its output codes are
readable on the host.  A batch's latency runs from its issue (just
before the engine is called) to that completion.

A seeded reservoir keeps the output codes of ``keep`` batches drawn
uniformly from all those of the window (their copy lands in a buffer of
the reservoir instead of the ring), for the comparison after the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Callable, List, Optional, Tuple

import torch


class _HostEvent:
    """Stand-in for a CUDA event when the engine runs on the CPU (every
    copy there has ended when it returns)."""

    def record(self, stream=None) -> None:
        pass

    def synchronize(self) -> None:
        pass


@dataclasses.dataclass
class WindowResult:
    rows: int                 # rows a batch
    issued: int               # batches issued in the window
    t_start: float            # first issue (perf_counter seconds)
    t_end: float              # last completion
    latency_s: List[float]    # every batch's issue to completion
    done_s: List[float]       # every batch's completion
    host_call_s: List[float]  # every batch's host time in the engine call
    kept: List[Tuple[int, int, torch.Tensor]]  # (batch, pool index, codes)

    @property
    def span_s(self) -> float:
        return self.t_end - self.t_start

    def rate(self, a: float, b: float) -> float:
        """Samples a second completed between clock readings a and b."""
        n = sum(1 for t in self.done_s if a < t <= b)
        return n * self.rows / (b - a) if b > a else float("nan")


def _annotate(on: bool, name: str):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def run_window(fn: Callable, pool: torch.Tensor, n_out: int,
               in_flight: int, seconds: Optional[float] = None,
               batches: Optional[int] = None, keep: int = 0,
               seed: int = 0, annotate: bool = False) -> WindowResult:
    """Issue batches until ``seconds`` have passed since the first issue
    or ``batches`` are issued, then wait for every one.  ``annotate``
    marks the host's parts (``bench.engine_call``, ``bench.copy_out``,
    ``bench.wait``) for a profiler trace."""
    if (seconds is None) == (batches is None):
        raise ValueError("give seconds or batches")
    cuda = pool.device.type == "cuda"
    P, rows = pool.shape[0], pool.shape[1]

    def host_buffer():
        return torch.empty((rows, n_out), dtype=torch.int32,
                           pin_memory=cuda)

    ring = [host_buffer() for _ in range(in_flight)]
    events = [torch.cuda.Event() if cuda else _HostEvent()
              for _ in range(in_flight)]
    ready = [torch.cuda.Event() if cuda else _HostEvent()
             for _ in range(in_flight)]
    copies = torch.cuda.Stream(pool.device) if cuda else None
    outs: List[Optional[torch.Tensor]] = [None] * in_flight
    reservoir = [host_buffer() for _ in range(keep)]
    held: List[Optional[Tuple[int, int]]] = [None] * keep
    rng = random.Random(seed)
    pending = [-1] * in_flight          # batch in each slot, -1 when none
    issued_at = [0.0] * in_flight
    latency, done, host_call = [], [], []
    t_last = 0.0

    def complete(slot: int) -> None:
        nonlocal t_last
        with _annotate(annotate, "bench.wait"):
            events[slot].synchronize()
        t = time.perf_counter()
        latency.append(t - issued_at[slot])
        done.append(t)
        t_last = max(t_last, t)
        pending[slot] = -1
        outs[slot] = None       # the engine's output, held until copied

    k, t_start, t_stop = 0, None, None
    while True:
        slot = k % in_flight
        if pending[slot] >= 0:
            complete(slot)
        now = time.perf_counter()
        if t_start is None:
            t_start = now
            t_stop = now + seconds if seconds is not None else None
        elif (t_stop is not None and now >= t_stop) or (
                batches is not None and k >= batches):
            break
        # where the output goes: a reservoir buffer or the ring's
        dst = ring[slot]
        j = k if k < keep else rng.randrange(k + 1)
        if j < keep:
            if held[j] is not None:
                prev = held[j][0]
                if pending[prev % in_flight] == prev:
                    complete(prev % in_flight)
            held[j] = (k, k % P)
            dst = reservoir[j]
        t0 = time.perf_counter()
        with _annotate(annotate, "bench.engine_call"):
            out = fn(pool[k % P])
        t1 = time.perf_counter()
        with _annotate(annotate, "bench.copy_out"):
            if cuda:
                ready[slot].record()
                copies.wait_event(ready[slot])
                with torch.cuda.stream(copies):
                    dst.copy_(out, non_blocking=True)
                    events[slot].record(copies)
            else:
                dst.copy_(out)
        outs[slot] = out
        host_call.append(t1 - t0)
        issued_at[slot] = t0
        pending[slot] = k
        k += 1
    for i in range(k - in_flight, k):
        if i >= 0 and pending[i % in_flight] == i:
            complete(i % in_flight)
    kept = [(h[0], h[1], reservoir[j]) for j, h in enumerate(held)
            if h is not None]
    return WindowResult(rows=rows, issued=k, t_start=t_start, t_end=t_last,
                        latency_s=latency, done_s=done, host_call_s=host_call,
                        kept=kept)
