"""One run of one cell: find its pieces by name, hand the run to the
driver of its traffic's kind, and make the result line.

A traffic mix's ``kind`` names its driver, ``bench/drivers/<kind>.py``:
a module with one function

    run(cfg, traffic, seed, seconds, traced, device, marks) -> Run

that makes the cell's data from the seed, builds the system under test,
warms up every shape the window uses, measures for ``seconds``, with
``traced`` reads the trace of a traced stretch, frees the program's
state and decides ``correct`` against the plain reference.  ``marks``
holds ``(name, perf_counter)`` stamps of the set-up so far, the
process's start first.  A new kind of traffic is a new driver file and
data files naming it; nothing here changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from harness import trace
from harness.spec import Benchmark


@dataclasses.dataclass
class Run:
    """What a driver hands back from one run."""
    attempted: int                  # requests or batches of the window
    failed: int                     # of them, those that were wrong
    correct: bool
    checked: Dict[str, dict]        # each number compared beside its limit
    end_to_end: Dict[str, float]    # every end-to-end value the kind reads
    context: object                 # what the per-layer readers read
    trace: Optional[trace.TraceReading]
    memory_peak_bytes: int          # read before the program was freed


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, marks: list) -> dict:
    """Run the cell once; return the result line's object (its
    ``checked`` key last)."""
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    driver = bench.driver(traffic["kind"])
    run = driver.run(cfg, traffic, seed, seconds, traced, device, marks)
    cuda = device.type == "cuda"
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    metrics: Dict[str, dict] = {}
    out: dict = {"correct": run.correct, "attempted": run.attempted,
                 "failed": run.failed, "metrics": metrics,
                 "device": dev_info}
    if not traced:
        for m in bench.end_to_end(workload):
            if m["name"] not in run.end_to_end:
                raise KeyError(f"traffic kind {traffic['kind']!r} does not "
                               f"measure {m['name']!r}")
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench.per_layer(workload)}
        for name, reader in bench.readers(workload).items():
            v = reader.read(run.context)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        if run.trace is not None:
            dev_info["busy_s"] = run.trace.busy_s
            dev_info["window_s"] = run.trace.window_s
            out["breakdown"] = {
                "device_ops": [[n, s] for n, s in run.trace.device_ops],
                "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    out["checked"] = run.checked
    return out
