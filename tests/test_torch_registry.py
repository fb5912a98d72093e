"""Port parity of the serving registry (``repro_torch.launch.registry``):
serving a JAX-saved artifact on the CPU, it answers exactly what the
JAX registry answers (its engine in interpret mode) for the same
requests, and a hot-swap under a short Poisson stream drops nothing —
every answer equals the plain forward of the version that served it."""
import dataclasses
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from repro.artifact import load_artifact as jload
from repro.artifact import save_artifact as jsave
from repro.launch.registry import ModelRegistry as JaxRegistry
from repro_torch.artifact import load_artifact
from repro_torch.kernels.lut_gather import ops as tops
from repro_torch.launch.batching import replay_open_loop
from repro_torch.launch.registry import ModelRegistry, UnknownModelError

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
