"""The trace reduction and the per-layer readers on a trace made by
hand (times in us, as the profiler's Chrome trace has them)."""
import types

import pytest

from harness import trace
from harness.spec import Benchmark
from harness.window import WindowResult


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def two_forwards(drop_copy=False):
    ev = [X("user_annotation", trace.WINDOW, 0, 100)]
    for i, t in enumerate((0, 50)):
        ev += [X("user_annotation", trace.ENGINE, t, 10),
               X("cuda_runtime", "cudaLaunchKernelExC", t + 2, 3, 10 + i),
               X("user_annotation", trace.COPY, t + 10, 5),
               X("cuda_runtime", "cudaMemcpyAsync", t + 11, 2, 20 + i),
               X("user_annotation", trace.WAIT, t + 15, 30)]
        # the forward's kernel, and an overlapping dependent launch
        ev += [X("kernel", "lut_fused", t + 10, 20, 10 + i),
               X("kernel", "lut_fused", t + 25, 10, 10 + i)]
        if not (drop_copy and i == 1):
            ev.append(X("gpu_memcpy", "Memcpy DtoH", t + 35, 5, 20 + i))
    ev.append(X("gpu_user_annotation", trace.ENGINE, 0, 100))  # not work
    return ev


def test_reduction_of_two_forwards():
    r = trace.reduce_events(two_forwards())
    assert r.complete
    assert (r.forwards, r.copies, r.copies_seen) == (2, 2, 2)
    assert (r.launch_calls, r.forward_kernels) == (2, 4)
    # kernels [10,35) and [60,85): their union, not their sum of 60 us
    assert r.forward_busy_s == pytest.approx(50e-6)
    assert r.busy_s == pytest.approx(60e-6)          # copies [35,40), [85,90)
    assert r.window_s == pytest.approx(100e-6)
    assert dict(r.device_ops) == pytest.approx(
        {"lut_fused": 60e-6, "Memcpy DtoH": 10e-6})
    # idle [0,10): the engine call; [40,60): 10 us of it in the engine
    # call, 5 in the wait; [90,100): the wait
    assert dict(r.idle_gaps) == pytest.approx(
        {trace.ENGINE: 30e-6, trace.WAIT: 10e-6})


def test_a_trace_missing_a_copy_gives_no_reading():
    r = trace.reduce_events(two_forwards(drop_copy=True))
    assert not r.complete
    assert trace.reduce_events([X("kernel", "k", 0, 1, 1)]) is None


def test_union_length():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_readers_on_a_reading():
    bench = Benchmark()
    Readings = bench.driver("batches").Readings
    r = trace.reduce_events(two_forwards())
    w = WindowResult(rows=10, issued=4, t_start=0.0, t_end=2e-4,
                     latency_s=[1e-4] * 4, done_s=[5e-5 * i for i in
                                                    range(1, 5)], host_call_s=[1e-5, 3e-5] * 2,
                     kept=[])
    ctx = Readings(cfg={}, traffic={}, least_s=5e-6, window=w,
                   trace=r)
    got = {n: m.read(ctx) for n, m in
           bench.readers("hdr-add2.eval-60k").items()}
    assert got == pytest.approx({
        "engine_host_us": 20.0, "launches_per_fwd": 2.0,
        "lut_kernels_us": 25.0, "lut_kernels_roofline": 20.0,
        "device_idle_share": 40.0, "lut_fwd_mfu": 10.0})
    # the idle share is the trace's alone: 60 us busy of 100 us
    # nothing to read: each device metric stays out, never reads 0
    ctx = Readings(cfg={}, traffic={}, least_s=None, window=w,
                   trace=None)
    got = {n: m.read(ctx) for n, m in
           bench.readers("hdr-add2.eval-60k").items()}
    assert got == {"engine_host_us": 20.0, "launches_per_fwd": None,
                   "lut_kernels_us": None, "lut_kernels_roofline": None,
                   "device_idle_share": None, "lut_fwd_mfu": None}
    # a context of another kind of traffic: every reader finds nothing
    got = {n: m.read(types.SimpleNamespace()) for n, m in
           bench.readers("hdr-add2.eval-60k").items()}
    assert set(got.values()) == {None}
