"""Traffic of kind ``batches``: batches of input codes already on the
device, issued ahead through the port's serving entry.

The window drives ``repro_torch.kernels.lut_gather.ops.make_network_fn(
tables, n_in0=n_in, device=...)`` with its default plan (the call
``launch.registry.ModelRegistry`` makes for a model) through
``harness.window.run_window``.  The traffic file gives ``batch_rows``,
``in_flight``, ``pool_batches``, ``codes``, ``check_batches`` (batches
the comparison keeps), ``warm_batches`` and ``trace_batches``.
Everything but the engine is the harness's own.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from harness import check, data, roofline, trace
from harness.cell import Run
from harness.window import WindowResult, run_window

TRACE_TRIES = 3


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader (``bench/metrics/<name>.py``)
    reads: the configuration and traffic files, the forward's least time
    on this card (None where the table of peaks lacks it), the untraced
    stretch of the window and the trace of the traced stretch (None when
    no trace held every launch and copy)."""
    cfg: dict
    traffic: dict
    least_s: Optional[float]
    window: WindowResult
    trace: Optional[trace.TraceReading]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def end_to_end(res: WindowResult, setup_s: float) -> Dict[str, float]:
    return {
        "samples_per_s": res.issued * res.rows / res.span_s,
        "batch_p95_ms": float(np.percentile(res.latency_s, 95)) * 1e3,
        "setup_s": setup_s,
    }


def _launches() -> int:
    from repro_torch.kernels.lut_gather import lut_gather
    return sum(lut_gather.launch_counts().values())


def traced_stretch(fn, pool, n_out: int, in_flight: int, batches: int
                   ) -> Optional[trace.TraceReading]:
    """Trace ``batches`` batches; again, up to TRACE_TRIES times, while
    the trace misses a copy or a launch (the library's own count of its
    launches included)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for attempt in range(TRACE_TRIES):
        before = _launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                run_window(fn, pool, n_out, in_flight, batches=batches,
                           annotate=True)
        launched = _launches() - before
        reading = trace.read_profile(prof)
        if (reading is not None and reading.complete
                and reading.forward_kernels >= launched):
            return reading
        print(f"[trace] try {attempt + 1}: incomplete ({reading}; the "
              f"library counted {launched} launches)", file=sys.stderr,
              flush=True)
    return None


def _log_window(res: WindowResult, reading: Optional[trace.TraceReading]
                ) -> None:
    """The window's rate second by second, and, traced, the idle share
    of the traced stretch beside the one its device time a batch gives
    at the untraced stretch's rate (the profiler's own host cost is the
    difference where the host sets the pace)."""
    edges = np.arange(res.t_start, res.t_end, 1.0)
    by_s = [res.rate(a, a + 1.0) for a in edges if a + 1.0 <= res.t_end]
    if by_s:
        print(f"[window] samples/s second by second (median "
              f"{statistics.median(by_s):.6g}): "
              + " ".join(f"{r:.6g}" for r in by_s),
              file=sys.stderr, flush=True)
    if reading is not None and reading.forwards and res.span_s > 0:
        per = reading.busy_s / reading.forwards
        print(f"[trace] device time a batch {per * 1e6:.2f} us; idle "
              f"{100 * (1 - reading.busy_s / reading.window_s):.3f} % "
              f"traced, {100 * (1 - per * res.issued / res.span_s):.3f} % "
              f"at the untraced rate", file=sys.stderr, flush=True)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, marks: list) -> Run:
    from repro_torch.kernels.lut_gather import ops

    marks.append(("port import", time.perf_counter()))
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
        marks.append(("cuda context", time.perf_counter()))
    g = data.generator(seed, device)
    raw = data.make_network(cfg, g, device)
    pool = data.make_pool(cfg, traffic, g, device)
    _sync(device)
    marks.append(("data", time.perf_counter()))
    fn = ops.make_network_fn(data.port_tables(raw), n_in0=cfg["n_in"],
                             device=device)
    marks.append(("engine", time.perf_counter()))
    n_out = cfg["layers"][-1]["n_out"]
    in_flight = traffic["in_flight"]
    keep = traffic["check_batches"]
    # every shape the window uses, through the window's own loop
    run_window(fn, pool, n_out, in_flight, batches=traffic["warm_batches"])
    _sync(device)
    gc.collect()
    gc.freeze()
    marks.append(("warm-up", time.perf_counter()))
    print("[setup] " + " ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
        file=sys.stderr, flush=True)
    try:
        res = run_window(fn, pool, n_out, in_flight, seconds=seconds,
                         keep=keep, seed=seed)
        reading = (traced_stretch(fn, pool, n_out, in_flight,
                                  traffic["trace_batches"])
                   if traced else None)
    finally:
        gc.unfreeze()
    _log_window(res, reading)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the program's state goes before the reference runs
    del fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    least = roofline.least_seconds(
        cfg, res.rows,
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu")
    readings = check.compare(res.kept, pool, raw,
                             want_kept=min(keep, res.issued))
    return Run(attempted=res.issued, failed=readings["failed_batches"],
               correct=check.verdict(readings),
               checked=check.report(readings),
               end_to_end=end_to_end(res, res.t_start - marks[0][1]),
               context=Readings(cfg=cfg, traffic=traffic, least_s=least,
                                window=res, trace=reading),
               trace=reading, memory_peak_bytes=peak)
