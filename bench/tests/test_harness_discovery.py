"""A configuration, a traffic mix, a per-layer metric and a kind of
traffic with its driver, added as files, are found by name, with no file
of the benchmark edited."""
import hashlib
import json
import os

from harness.spec import Benchmark


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_pieces_found_by_name(tiny_root):
    before = _digests(tiny_root / "bench")
    metric = tiny_root / "bench" / "metrics" / "tiny_metric.py"
    metric.write_text("def read(ctx):\n    return 42.0\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "tiny_metric", "unit": "us", "better": "lower",
        "source": "host_clock", "layer": "device", "moves": "samples_per_s",
        "workloads": ["tiny.mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(str(tiny_root))
    assert bench.config(bench.workload("tiny.mix")["config"])["n_in"] == 12
    assert bench.traffic("tiny-mix")["batch_rows"] == 64
    readers = bench.readers("tiny.mix")
    assert readers["tiny_metric"].read(None) == 42.0
    # the metric is the tiny cell's alone; the others apply to every cell
    assert "tiny_metric" not in bench.readers("hdr-add2.eval-60k")
    assert set(bench.readers("tiny.mix")) == set(
        bench.readers("hdr-add2.eval-60k")) | {"tiny_metric"}
    after = _digests(tiny_root / "bench")
    assert {k: after[k] for k in before} == before


# a kind of traffic the benchmark does not drive yet, as a later change
# would add it: single rows sent on an open-loop schedule, each timed
# from when it was due
OPEN_ROWS_DRIVER = '''
import time

import numpy as np
import torch

from harness import check, data, schedule
from harness.cell import Run


def run(cfg, traffic, seed, seconds, traced, device, marks):
    from repro_torch.kernels.lut_gather import ops
    g = data.generator(seed, device)
    raw = data.make_network(cfg, g, device)
    pool = data.make_pool(cfg, traffic, g, device)
    fn = ops.make_network_fn(data.port_tables(raw), n_in0=cfg["n_in"],
                             device=device)
    rows = pool[0]
    offsets = schedule.poisson_offsets(traffic["rate"], rows.shape[0], seed)
    outs, done = [], []

    def submit(i):
        outs.append(fn(rows[i:i + 1]))
        done.append(time.perf_counter())

    t0, _, _ = schedule.send_on_schedule(submit, range(rows.shape[0]),
                                         offsets)
    lat = schedule.due_latencies(t0, offsets, done)
    r = check.compare([(0, 0, torch.cat(outs))], pool, raw, 1)
    return Run(attempted=len(done), failed=r["failed_batches"],
               correct=check.verdict(r), checked=check.report(r),
               end_to_end={"samples_per_s": len(done) / (done[-1] - t0),
                           "batch_p95_ms": np.percentile(lat, 95) * 1e3,
                           "setup_s": t0 - marks[0][1]},
               context=None, trace=None, memory_peak_bytes=0)
'''


def test_new_kind_of_traffic_found_by_name(tiny_root):
    import time

    import torch

    from harness.cell import run_cell

    before = _digests(tiny_root / "bench")
    bench_dir = tiny_root / "bench"
    (bench_dir / "drivers" / "open_rows.py").write_text(OPEN_ROWS_DRIVER)
    (bench_dir / "traffic" / "tiny-open.json").write_text(json.dumps({
        "kind": "open_rows", "batch_rows": 64, "pool_batches": 1,
        "codes": "uniform", "rate": 20000.0}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.open", "config": "tiny",
                              "traffic": "tiny-open", "chips": 1,
                              "why": "test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(str(tiny_root))
    for traced in (False, True):
        out = run_cell(bench, "tiny.open", 2 ** 31 + 9, 0.1, traced,
                       torch.device("cpu"), [("start", time.perf_counter())])
        assert out["correct"] and out["attempted"] == 64
        assert list(out)[-1] == "checked"
        # no trace: every per-layer reader finds nothing and stays out
        assert set(out["metrics"]) == (set() if traced else {
            "samples_per_s", "batch_p95_ms", "setup_s"})
    after = _digests(tiny_root / "bench")
    assert {k: after[k] for k in before} == before
