"""Reducing a ``torch.profiler`` trace of the window to device numbers.

The window loop marks the host's parts with ``record_function``
(``bench.window`` around the traced stretch, ``bench.engine_call``,
``bench.copy_out``, ``bench.wait``).  The trace, exported as Chrome
trace JSON, links each device activity (kernel, memcpy, memset) to the
host runtime call that issued it by its ``correlation`` id.  A device
activity issued from a ``bench.copy_out`` is the harness's own copy;
every other one in the stretch is the forward's.

Device time is the length of a union of intervals, so activities that
overlap (a programmatic dependent launch starts before the launch it
waits on ends) count once: the reduction of ``chip_smoke.py``'s
``profile_kernels``.  A reading is complete only when the trace holds
every copy the harness issued and, for every launch call the engine
made, a kernel: a trace that misses some gives no reading, never a
partial sum.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_PREFIX = "cuda_"      # the host's CUDA API calls
WINDOW = "bench.window"
ENGINE = "bench.engine_call"
COPY = "bench.copy_out"
WAIT = "bench.wait"
HOST_OTHER = "bench.loop"      # host between the marked parts

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return total


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(iv: Interval, lo: float, hi: float) -> Optional[Interval]:
    a, b = max(iv[0], lo), min(iv[1], hi)
    return (a, b) if b > a else None


class _Spans:
    """Disjoint sorted host spans of one name, for containment and
    overlap queries."""

    def __init__(self, spans: Sequence[Interval]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]

    def overlap(self, a: float, b: float) -> float:
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        total = 0.0
        while i < len(self.spans) and self.spans[i][0] < b:
            total += max(0.0, min(b, self.spans[i][1])
                         - max(a, self.spans[i][0]))
            i += 1
        return total


@dataclasses.dataclass
class TraceReading:
    window_s: float            # the traced stretch's wall time
    forwards: int              # engine calls in it
    copies: int                # harness copies issued in it
    copies_seen: int           # harness copies the trace holds
    launch_calls: int          # launch calls made inside engine calls
    forward_kernels: int       # kernels the forwards launched, traced
    forward_busy_s: float      # union of the forwards' device activity
    busy_s: float              # union of all device activity
    device_ops: List[Tuple[str, float]]   # most device time by name
    idle_gaps: List[Tuple[str, float]]    # idle time by the host's part

    @property
    def complete(self) -> bool:
        return (self.forwards > 0 and self.copies_seen == self.copies
                and self.forward_kernels >= self.launch_calls)


def reduce_events(events: Sequence[dict], top: int = 10
                  ) -> Optional[TraceReading]:
    """``events`` of a Chrome trace (``traceEvents``); times in us.
    None when the trace holds no ``bench.window``."""
    spans: Dict[str, List[Interval]] = {}
    runtime, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat") or "", float(e["ts"])
        iv = (ts, ts + float(e.get("dur", 0.0)))
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append(iv)
        elif cat.startswith(RUNTIME_PREFIX):
            runtime.append((iv, e["name"], e.get("args", {}).get(
                "correlation")))
        elif cat in DEVICE_CATS:
            device.append((iv, e["name"], e.get("args", {}).get(
                "correlation"), cat))
    if not spans.get(WINDOW):
        return None
    lo, hi = min(spans[WINDOW])[0], max(b for _, b in spans[WINDOW])
    engine, copy, wait = (_Spans(spans.get(n, [])) for n in
                          (ENGINE, COPY, WAIT))
    copy_corr, launch_calls = set(), 0
    for (a, _), name, corr in runtime:
        if copy.contains(a):
            copy_corr.add(corr)
        elif engine.contains(a) and "Launch" in name:
            launch_calls += 1
    fwd, every, by_name = [], [], {}
    copies_seen = forward_kernels = 0
    for iv, name, corr, cat in device:
        c = _clip(iv, lo, hi)
        if c is None:
            continue
        every.append(c)
        by_name[name] = by_name.get(name, 0.0) + (iv[1] - iv[0]) * 1e-6
        if corr is not None and corr in copy_corr:
            copies_seen += 1
        else:
            fwd.append(c)
            forward_kernels += cat == "kernel"
    busy = merged(every)
    gaps, edge = {}, lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            parts = {n: s.overlap(edge, a) for n, s in
                     ((ENGINE, engine), (COPY, copy), (WAIT, wait))}
            name = max(parts, key=parts.get)
            name = name if parts[name] > 0 else HOST_OTHER
            gaps[name] = gaps.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    return TraceReading(
        window_s=(hi - lo) * 1e-6,
        forwards=sum(1 for a, _ in engine.spans if lo <= a <= hi),
        copies=sum(1 for a, _ in copy.spans if lo <= a <= hi),
        copies_seen=copies_seen, launch_calls=launch_calls,
        forward_kernels=forward_kernels,
        forward_busy_s=union_length(fwd) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])


def read_profile(prof) -> Optional[TraceReading]:
    """Export ``prof``'s trace to a temporary file, reduce it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)
