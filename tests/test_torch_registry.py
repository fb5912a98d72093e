"""Port parity of the serving registry (``repro_torch.launch.registry``):
serving a JAX-saved artifact on the CPU, it answers exactly what the
JAX registry answers (its engine in interpret mode) for the same
requests, and a hot-swap under a short Poisson stream drops nothing —
every answer equals the plain forward of the version that served it."""
import dataclasses
import gc
import pathlib
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro.artifact import load_artifact as jload
from repro.artifact import save_artifact as jsave
from repro.launch.registry import ModelRegistry as JaxRegistry
from repro_torch.artifact import load_artifact
from repro_torch.kernels.lut_gather import ops as tops
from repro_torch.launch import serve as TS
from repro_torch.launch.batching import MicroBatcher, replay_open_loop
from repro_torch.launch.fleet import LutFleet
from repro_torch.launch.registry import ModelRegistry, UnknownModelError
from repro_torch.launch.scheduler import ScoreboardScheduler, SLOTier

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _rows(n: int, n_in: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 4, (n, n_in)).astype(np.int32)


def _second_version(tmp_path) -> str:
    """The golden network with every truth table read back to front: the
    same widths, different answers (saved by the JAX package)."""
    jart = jload(str(GOLDEN))
    flipped = [dataclasses.replace(
        t, sub_table=np.ascontiguousarray(np.asarray(t.sub_table)[..., ::-1]))
        for t in jart.tables]
    return jsave(str(tmp_path), flipped, name="flipped", spec=jart.spec)


def _plain(path: str, rows: np.ndarray) -> np.ndarray:
    fn = tops.make_network_fn(load_artifact(path, device="cpu"),
                              fused=False, device="cpu")
    return fn(torch.from_numpy(rows)).numpy()


def test_port_registry_answers_like_reference_registry():
    n_in = jload(str(GOLDEN)).n_in
    rows = _rows(40, n_in, 1)
    with JaxRegistry(microbatch=8, deadline_s=0.005,
                     force_interpret=True) as jreg, \
            ModelRegistry(microbatch=8, deadline_s=0.005,
                          device="cpu") as reg:
        jreg.register("g", str(GOLDEN))
        entry = reg.register("g", str(GOLDEN))
        assert entry.plan.mode == "fused"
        jh = [jreg.submit("g", r) for r in rows]
        th = [reg.submit("g", r) for r in rows]
        want = np.stack([h.result(timeout=30.0) for h in jh])
        got = np.stack([h.result(timeout=30.0) for h in th])
        assert {h.tag for h in th} == {h.tag for h in jh}
        stats = reg.stats()["g"]
        assert stats["served"] == len(rows)
        assert stats["exec_mode"] == "fused"
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_swap_under_poisson_load_drops_nothing(tmp_path):
    old, new = str(GOLDEN), _second_version(tmp_path)
    n_in = jload(old).n_in
    rows = _rows(400, n_in, 2)
    want = {load_artifact(p, device="cpu").artifact_id: _plain(p, rows)
            for p in (old, new)}
    assert len(want) == 2
    with ModelRegistry(microbatch=16, deadline_s=0.002,
                       device="cpu") as reg:
        reg.register("m", old)
        handles = []
        # a ~0.5 s stream: the new engine's warm-up ends while requests
        # are still arriving
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(reg.client("m"), rows, rate=800.0, seed=4,
                             timeout_s=30.0)))
        feeder.start()
        time.sleep(0.01)
        report = reg.swap("m", new)
        feeder.join(timeout=60.0)
        assert not feeder.is_alive()
        with pytest.raises(UnknownModelError):
            reg.submit("nope", rows[0])
    assert (report.old_version, report.new_version) == (1, 2)
    assert len(handles) == len(rows)
    assert not any(h.failed for h in handles)
    tags = [h.tag for h in handles]
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=1.0),
                                      want[h.tag][i])
    assert set(tags) == set(want)        # the swap landed mid-stream


class _Cycle:
    """A node of a reference cycle: only the collector's full pass frees
    it."""

    def __init__(self):
        self.me = self


@pytest.mark.parametrize("case", ["stream", "swap", "second_registry"])
def test_full_collection_in_a_flush_skips_the_heap_from_before(case,
                                                                 tmp_path):
    """A full pass of the garbage collector that comes due inside a flush
    walks only what serving allocated since the first batcher started,
    not the heap that was there before: a pass holds every serving
    thread (the GIL) for as long as it walks, which on an H100 host
    stalled a flush of ``serve --lut`` for up to 0.7 s after training.
    Here 100k live cyclic objects in the oldest generation stand for the
    heap training leaves behind, and 100k more wait there as garbage.
    The first batcher's start frees the garbage rather than freezing it;
    a full pass inside a flush, after a swap or while a second registry
    that started first still serves, walks under half the live heap.
    When the last batcher stops, the heap goes back to the collector."""
    n = 100_000
    assert gc.get_freeze_count() < n // 10, "another test's batcher runs"
    old = str(GOLDEN)
    rows = _rows(64, jload(old).n_in, 3)
    live = [_Cycle() for _ in range(n)]
    dead = [_Cycle() for _ in range(n)]
    gc.collect()                  # both reach the oldest generation
    a_dead = weakref.ref(dead[0])
    del dead                      # ... where these are garbage
    passes = []

    def hook(model_id, batch):
        if len(passes) < 2:
            # what a full pass due now walks, and what it frees
            passes.append((len(gc.get_objects()), gc.collect()))

    with ModelRegistry(microbatch=16, deadline_s=0.002,
                       device="cpu") as other:
        other.register("o", old)
        assert a_dead() is None, "garbage frozen at the first start"
        with ModelRegistry(microbatch=16, deadline_s=0.002, device="cpu",
                           engine_hook=hook) as reg:
            reg.register("m", old)
            if case == "swap":
                reg.swap("m", _second_version(tmp_path))
            if case != "second_registry":
                other.close()
            handles = replay_open_loop(reg.client("m"), rows, rate=4000.0,
                                       seed=5, timeout_s=30.0)
        frozen = gc.get_freeze_count()      # the other still serves, or not
    assert len(passes) == 2 and not any(h.failed for h in handles)
    for walked, freed in passes:
        assert walked < n // 2 and freed < n // 10, (walked, freed)
    assert (frozen >= n) == (case == "second_registry")
    assert gc.get_freeze_count() < n // 10
    del live
    assert gc.collect() >= n


def test_batchers_shorten_the_gil_switch_interval_while_serving(tmp_path):
    """A flush gives the GIL up at each copy and launch; beside a thread
    that runs Python (a hot swap loading and planning its engine), taking
    it back cost up to the interpreter's switch interval each time, 5 ms
    by default: 9.5-21.4 ms a flush during swaps on an H100's host.
    Inside every flush, before and after a swap, the interval is
    ``SERVING_SWITCH_S`` (0.5 ms); once the last batcher stops it is what
    it was."""
    before = sys.getswitchinterval()
    rows = _rows(48, jload(str(GOLDEN)).n_in, 4)
    seen = []

    def hook(model_id, batch):
        seen.append(sys.getswitchinterval())

    with ModelRegistry(microbatch=8, deadline_s=0.002, device="cpu",
                       engine_hook=hook) as reg:
        reg.register("m", str(GOLDEN))
        handles = replay_open_loop(reg.client("m"), rows, rate=2000.0,
                                   seed=6, timeout_s=30.0)
        reg.swap("m", _second_version(tmp_path))
        handles += replay_open_loop(reg.client("m"), rows, rate=2000.0,
                                    seed=7, timeout_s=30.0)
    assert not any(h.failed for h in handles) and len(seen) >= 4
    assert max(seen) <= 5e-4, seen
    assert sys.getswitchinterval() == before


def _double(batch):
    return batch[:, :1] * 2


def _batcher(tmp_path, **kw):
    with MicroBatcher(_double, 8, 0.002, n_features=4, **kw) as mb:
        hs = [mb.submit(np.full(4, i, np.int32)) for i in range(20)]
        for i, h in enumerate(hs):
            assert h.result(timeout=30.0)[0] == 2 * i


def _batcher_stopped_twice(tmp_path):
    mb = MicroBatcher(_double, 8, 0.002, n_features=4).start()
    assert mb.submit(np.ones(4, np.int32)).result(timeout=30.0)[0] == 2
    mb.stop()
    mb.stop()
    _batcher(tmp_path)


def _failing_engine(tmp_path):
    def boom(batch):
        raise RuntimeError("engine down")
    with MicroBatcher(boom, 8, 0.002, n_features=4) as mb:
        h = mb.submit(np.ones(4, np.int32))
        with pytest.raises(RuntimeError):
            h.result(timeout=30.0)


def _registry(tmp_path, swap=False, **kw):
    rows = _rows(24, jload(str(GOLDEN)).n_in, 8)
    with ModelRegistry(microbatch=8, deadline_s=0.002, device="cpu",
                       **kw) as reg:
        reg.register("m", str(GOLDEN))
        if swap:
            reg.swap("m", _second_version(tmp_path))
        hs = replay_open_loop(reg.client("m"), rows, rate=4000.0, seed=8,
                              timeout_s=30.0)
    assert not any(h is None or h.failed for h in hs)


def _two_registries_interleaved(tmp_path):
    a = ModelRegistry(microbatch=8, deadline_s=0.002, device="cpu")
    a.register("a", str(GOLDEN))
    try:
        _registry(tmp_path)
    finally:
        a.close()


def _thread_fleet(tmp_path, swap=False):
    rows = _rows(24, jload(str(GOLDEN)).n_in, 9)
    with LutFleet(2, microbatch=8, deadline_s=0.002, device="cpu",
                  store_root=str(tmp_path / "fleet")) as fleet:
        fleet.distribute_artifact(str(GOLDEN), "m")
        if swap:
            fleet.swap_fleet("m", _second_version(tmp_path))
        hs = replay_open_loop(fleet.client("m"), rows, rate=4000.0, seed=9,
                              timeout_s=30.0)
    assert not any(h is None or h.failed for h in hs)


def _serve_lut(tmp_path, *extra):
    TS.main(["--lut", "--device", "cpu", "--lut-train-steps", "3",
             "--requests", "48", "--rate", "20000", "--microbatch", "16",
             "--deadline-ms", "5", *extra])


def _with_interval(interval):
    def run(tmp_path):
        before = sys.getswitchinterval()
        sys.setswitchinterval(interval)
        set_ = sys.getswitchinterval()     # as the interpreter holds it
        try:
            _registry(tmp_path)
            assert sys.getswitchinterval() == set_
        finally:
            sys.setswitchinterval(before)
    run.interval = interval
    return run


FRONT_ENDS = {
    "batcher": _batcher,
    "batcher_stopped_twice": _batcher_stopped_twice,
    "scheduled_batcher": lambda t: _batcher(
        t, scheduler=ScoreboardScheduler()),
    "failing_engine": _failing_engine,
    "registry": _registry,
    "registry_swap": lambda t: _registry(t, swap=True),
    "registry_work_stealing": lambda t: _registry(t, work_stealing=True),
    "registry_slo_tiers": lambda t: _registry(
        t, slo_tiers=[SLOTier("interactive", 0.5), SLOTier("batch")]),
    "two_registries_interleaved": _two_registries_interleaved,
    "thread_fleet": _thread_fleet,
    "thread_fleet_swap": lambda t: _thread_fleet(t, swap=True),
    "serve_lut": _serve_lut,
    "serve_lut_swap_demo": lambda t: _serve_lut(t, "--swap-demo"),
    "serve_lut_replicas": lambda t: _serve_lut(t, "--replicas", "2"),
    "serve_lut_slo_tiers": lambda t: _serve_lut(t, "--slo-tiers"),
    "serve_lut_fleet_swap_demo": lambda t: _serve_lut(
        t, "--fleet-swap-demo"),
    "caller_interval_longer": _with_interval(0.02),
    "caller_interval_shorter": _with_interval(2e-4),
}


@pytest.mark.parametrize("front_end", list(FRONT_ENDS))
def test_every_serving_front_end_restores_the_collector_and_interval(
        front_end, tmp_path, monkeypatch, capsys):
    """The frozen heap and the short switch interval are process-wide:
    every way the port serves (a bare batcher, one with a scheduler or a
    failing engine, the registry with a swap, work stealing or SLO
    tiers, two registries, the thread fleet, each mode of ``serve
    --lut``) holds them in every flush and hands both back when its
    last batcher stops, or the process would keep its garbage and the
    caller's interval would be lost.  A caller's interval shorter than
    ``SERVING_SWITCH_S`` is kept."""
    run = FRONT_ENDS[front_end]
    before = sys.getswitchinterval()
    serving = getattr(run, "interval", 0.02)
    assert gc.get_freeze_count() < 10_000, "another test's batcher runs"
    seen = []
    inner = MicroBatcher._flush_inner

    def flush_inner(mb, *a):
        if len(seen) < 3:
            seen.append((gc.get_freeze_count(), sys.getswitchinterval()))
        return inner(mb, *a)

    monkeypatch.setattr(MicroBatcher, "_flush_inner", flush_inner)
    run(tmp_path)
    capsys.readouterr()
    assert seen, "nothing was served"
    for frozen, interval in seen:
        assert frozen >= 10_000
        assert interval == pytest.approx(min(serving, 5e-4), abs=1e-6)
    assert gc.get_freeze_count() < 10_000
    assert sys.getswitchinterval() == before


@pytest.mark.parametrize("mode", ["plain", "slo_tiers", "work_stealing"])
def test_swapped_out_engines_are_freed_while_the_registry_serves(mode,
                                                                  tmp_path):
    """A long-lived registry swaps three times while a stream is served
    and while it goes on serving: every engine swapped out (the first
    one too, built before serving began) is freed once the collector
    runs, with a scheduler and a steal group bound to its batcher as
    well.  Nothing the first batcher's start left on the heap keeps an
    old version's engine, and its tables on the card, alive."""
    kw = {"plain": {}, "work_stealing": {"work_stealing": True},
          "slo_tiers": {"slo_tiers": [SLOTier("interactive", 0.5),
                                      SLOTier("batch")]}}[mode]
    paths = [str(GOLDEN), _second_version(tmp_path)]
    rows = _rows(300, jload(paths[0]).n_in, 10)
    with ModelRegistry(microbatch=8, deadline_s=0.002, device="cpu",
                       **kw) as reg:
        olds = [weakref.ref(reg.register("m", paths[0]).serve_fn)]
        handles = []
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(reg.client("m"), rows, rate=1500.0, seed=11,
                             timeout_s=30.0)))
        feeder.start()
        for i in range(3):
            reg.swap("m", paths[(i + 1) % 2])
            olds.append(weakref.ref(reg.get("m").serve_fn))
        feeder.join(timeout=60.0)
        assert not feeder.is_alive()
        gc.collect()
        alive = [i + 1 for i, r in enumerate(olds[:-1]) if r() is not None]
        assert alive == [], f"versions {alive} still held while serving"
        assert olds[-1]() is not None
        assert reg.submit("m", rows[0]).result(timeout=30.0) is not None
    assert len(handles) == len(rows)
    assert not any(h is None or h.failed for h in handles)
