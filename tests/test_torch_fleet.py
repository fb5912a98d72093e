"""Port parity of the serving fleet over threads (``repro_torch.launch.
fleet``, ``transport="thread"``) and of its wire layer
(``repro_torch.launch.transport``).

The contracts of ``tests/test_fleet.py``, at its smallest sizes
(microbatch 8, a 16-input network), on the CPU (``device="cpu"``: the
plain PyTorch path):

* bit-exactness: every answer equals the JAX package's plain forward
  (``lut_synth.lut_layer_forward`` layer by layer, the integer chain of
  ``lut_forward``) of the same artifact, loaded by
  ``repro.artifact.load_artifact``;
* zero dropped, zero hung under a replica death with requests in flight;
* verified distribution: a bit-flipped copy is refused and re-fetched,
  and an exhausted fetch budget excludes the replica;
* two-phase swap: every answer's tag is the old or the new artifact id,
  its payload the forward of that version, and no microbatch mixes
  versions; a failed prepare aborts the cutover everywhere.

The networks are synthesised and saved by the JAX package (the port
reads its artifacts by the same ids).  The wire test holds the two
copies of the transport to the same bytes in both directions.
"""
import functools
import pathlib
import socket
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifact import load_artifact as jload
from repro.artifact import save_artifact as jsave
from repro.core import lut_synth as LS
from repro.core import lutdnn as LD
from repro.launch import transport as jwire
from repro_torch.artifact import load_artifact
from repro_torch.launch import transport as twire
from repro_torch.launch.batching import replay_open_loop
from repro_torch.launch.fleet import (FleetSwapError, LutFleet,
                                      NoHealthyReplica, ReplicaCrashed)
from repro_torch.launch.scheduler import (BATCH, DeadlineUnmeetable,
                                          interactive_tier)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"

SPEC_KW = dict(in_features=16, widths=(24, 12, 5), bits=2, fan_in=3,
               degree=1, adder_width=2)


def _synthesise(seed: int, name: str = "tfleet"):
    spec = LD.ModelSpec(name=f"{name}-{seed}", **SPEC_KW)
    model = LD.init_model(jax.random.key(seed), spec)
    return spec, LS.synthesise(model, spec)


@functools.lru_cache(maxsize=None)
def _jax_forward(path: str):
    """The JAX package's plain forward of the artifact at ``path``: the
    integer chain of ``lut_forward`` over its tables (jitted as one
    program; the chain is integer, so jit changes no value)."""
    tables = jload(path).tables

    @jax.jit
    def fwd(x):
        for t in tables:
            x = LS.lut_layer_forward(t, x)
        return x

    return fwd


def _want(path: str, rows: np.ndarray) -> np.ndarray:
    return np.asarray(_jax_forward(str(path))(jnp.asarray(rows)))


def _rows(n: int, seed: int = 3, width: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 4, (n, width)).astype(np.int32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """v0/v1 artifacts of one architecture (the swap payloads)."""
    root = tmp_path_factory.mktemp("tfleet-artifacts")
    paths = {}
    for seed in (0, 1):
        spec, tables = _synthesise(seed)
        paths[seed] = jsave(str(root), tables, name=f"tfleet-v{seed}",
                            spec=spec)
    return paths


def _fleet(n, **kw):
    kw.setdefault("microbatch", 8)
    kw.setdefault("deadline_s", 0.003)
    return LutFleet(n, device="cpu", **kw)


def _tag(path) -> str:
    return load_artifact(path, device="cpu").artifact_id


# ---------------------------------------------------------------------------
# the wire: both copies of the transport pack the same bytes
# ---------------------------------------------------------------------------

def test_transport_frames_decode_across_packages():
    assert twire.HEADER.format == jwire.HEADER.format == "!BII"
    assert twire.META_LEN.format == jwire.META_LEN.format
    assert (twire.MAX_PAYLOAD, twire.FETCH_CHUNK_BYTES) == \
        (jwire.MAX_PAYLOAD, jwire.FETCH_CHUNK_BYTES)
    assert twire.MSG_NAMES == jwire.MSG_NAMES
    for name in jwire.MSG_NAMES.values():
        assert getattr(twire, f"MSG_{name}") == getattr(jwire, f"MSG_{name}")
    row = np.arange(16, dtype=np.int32).reshape(2, 8)
    meta = dict(twire.array_meta(row), model_id="m",
                tier={"name": "interactive", "deadline_s": 0.25})
    assert meta == dict(jwire.array_meta(row), model_id="m",
                        tier={"name": "interactive", "deadline_s": 0.25})
    blob = twire.array_blob(row)
    assert blob == jwire.array_blob(row)
    payload = twire.pack_payload(meta, blob)
    assert payload == jwire.pack_payload(meta, blob)
    for unpack, to_array in ((jwire.unpack_payload, jwire.blob_array),
                             (twire.unpack_payload, twire.blob_array)):
        m, b = unpack(payload)
        assert m == meta
        np.testing.assert_array_equal(to_array(m, b), row)
    # whole frames over a socket, each package's sender to the other's
    # receiver
    for send_mod, recv_mod in ((twire, jwire), (jwire, twire)):
        a, b = socket.socketpair()
        tx, rx = send_mod.FrameConn(a), recv_mod.FrameConn(b)
        try:
            tx.send(send_mod.MSG_SUBMIT, 7, meta, blob)
            tx.send(send_mod.MSG_PING, 8, {})
            assert rx.recv() == (recv_mod.MSG_SUBMIT, 7, meta, blob)
            assert rx.recv() == (recv_mod.MSG_PING, 8, {}, b"")
        finally:
            tx.close()
            rx.close()


# ---------------------------------------------------------------------------
# routing: bit-exactness, load spread, health exclusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_replicas", [1, 2, 4])
def test_fleet_bit_exact_vs_jax_forward(artifacts, n_replicas):
    rows = _rows(48)
    want = _want(artifacts[0], rows)
    with _fleet(n_replicas) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i]), i
            assert h.version_tag == _tag(artifacts[0])
        st = fleet.stats()
        assert sum(v["served"] for v in st.values()) == len(rows)
        if n_replicas > 1:
            assert all(v["served"] > 0 for v in st.values()), st
        assert all(v["outstanding"] == 0 for v in st.values())
        # on the CPU no kernel launches; the counts come back all the same
        counts = fleet.launch_counts()
        assert set(counts) == {r.replica_id for r in fleet.replicas}
        assert all(n == 0 for c in counts.values() for n in c.values())


def test_router_excludes_dead_replica(artifacts):
    rows = _rows(24, seed=5)
    want = _want(artifacts[0], rows)
    with _fleet(3) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        fleet.kill_replica("r1")
        assert fleet.healthy_replicas() == ["r0", "r2"]
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i])
            assert h.replica_id in ("r0", "r2")
        assert fleet.stats()["r1"]["served"] == 0


def test_no_healthy_replica_raises_typed(artifacts):
    with _fleet(1, microbatch=4) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        fleet.kill_replica("r0")
        with pytest.raises(NoHealthyReplica):
            fleet.submit("m", _rows(1)[0])
        with pytest.raises(NoHealthyReplica):
            fleet.submit("nope", _rows(1)[0])


def test_fleet_needs_a_card_unless_told_and_has_no_mesh(monkeypatch,
                                                        tmp_path):
    """Replicas serve on the CUDA card unless the fleet names a device:
    without a card and without a name, building the fleet raises (no
    silent CPU fallback) and leaves no store behind.  A mesh cannot
    cross the process transport (the reference's ValueError), and
    leaves no store behind either."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LutFleet(2)
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="process transport"):
        LutFleet(1, device="cpu", mesh=object(), transport="process")
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# replica crash with requests in flight
# ---------------------------------------------------------------------------

def test_replica_crash_mid_request_zero_drops(artifacts):
    """Kill a replica while its queue holds live requests AND while a
    producer keeps submitting: every request completes bit-exactly,
    none hangs, none drops, and the router's counts come back to 0."""
    rows = _rows(120, seed=7)
    want = _want(artifacts[0], rows)
    # microbatches wider than the stream and a deadline well past the
    # submits: the victim still holds every request routed to it when
    # the kill lands (each re-dispatched request then waits out one
    # deadline alone)
    with _fleet(3, microbatch=64, deadline_s=0.1) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        first = [fleet.submit("m", r) for r in rows[:45]]
        victim = max(fleet.stats().items(),
                     key=lambda kv: kv[1]["outstanding"])[0]
        late: list = []

        def producer():
            for r in rows[45:]:
                late.append(fleet.submit("m", r))
                time.sleep(0.0005)

        t = threading.Thread(target=producer)
        t.start()
        fleet.kill_replica(victim)
        t.join(timeout=30.0)
        assert not t.is_alive()
        handles = first + late
        assert len(handles) == len(rows)
        retried = 0
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i]), i
            retried += h.retries
        assert retried > 0, "kill landed after all flushes — not in flight"
        st = fleet.stats()
        assert all(v["outstanding"] == 0 for v in st.values()), st
        assert st[victim]["healthy"] is False


def test_persistent_engine_fault_times_out_instead_of_spinning(artifacts):
    with _fleet(1, microbatch=4) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        fleet._replica("r0").crashed = True      # routable, always fails
        h = fleet.submit("m", _rows(1)[0])
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            h.result(timeout=0.5)
        assert time.monotonic() - t0 < 10.0
        assert h.retries > 0


def test_crashed_engine_raises_typed_error():
    with _fleet(2, microbatch=4) as fleet:
        fleet._replica("r0").crashed = True
        with pytest.raises(ReplicaCrashed):
            fleet._engine_gate("r0")


# ---------------------------------------------------------------------------
# artifact distribution
# ---------------------------------------------------------------------------

def test_corrupt_fetch_verification_and_refetch_golden():
    """A bit-flipped copy fails the manifest-hash admission check, is
    re-fetched clean, and the fleet reproduces the committed golden
    vectors exactly."""
    io = np.load(GOLDEN / "golden_io.npz")
    with _fleet(2, microbatch=16) as fleet:
        fleet.inject_fetch_corruption("r1", n=1)
        report = fleet.distribute_artifact(str(GOLDEN), "golden")
        assert report["r0"].admitted and report["r0"].verify_failures == 0
        assert report["r1"].admitted and report["r1"].verify_failures == 1
        assert report["r1"].fetches == 2
        assert report["r1"].artifact_id == str(io["artifact_id"])
        handles = [fleet.submit("golden", r) for r in io["inputs"]]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0),
                                  io["outputs"][i]), i
            assert h.version_tag == str(io["artifact_id"])


def test_exhausted_fetch_budget_excludes_replica(artifacts):
    rows = _rows(20, seed=11)
    want = _want(artifacts[0], rows)
    with _fleet(2, max_fetch_retries=1) as fleet:
        fleet.inject_fetch_corruption("r1", n=2)
        report = fleet.distribute_artifact(artifacts[0], "m")
        assert report["r0"].admitted and not report["r1"].admitted
        assert "verification" in report["r1"].error
        assert fleet.admitted_tags("m").keys() == {"r0"}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i])
            assert h.replica_id == "r0"


def test_concurrent_rollouts_report_their_own_fetch_counts(artifacts):
    with _fleet(2) as fleet:
        fleet.inject_fetch_corruption("r1", n=2)
        reports: dict = {}
        barrier = threading.Barrier(2)

        def rollout(model_id, src):
            barrier.wait()
            reports[model_id] = fleet.distribute_artifact(src, model_id)

        threads = [threading.Thread(target=rollout, args=("a", artifacts[0])),
                   threading.Thread(target=rollout, args=("b", artifacts[1]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        for mid in ("a", "b"):
            rep = reports[mid]
            assert rep["r0"].admitted and rep["r0"].fetches == 1
            assert rep["r0"].verify_failures == 0
            assert rep["r1"].admitted
            assert rep["r1"].fetches == rep["r1"].verify_failures + 1
        st = fleet.stats()
        assert (st["r0"]["fetches"], st["r1"]["fetches"]) == (2, 4)
        assert st["r1"]["verify_failures"] == 2


# ---------------------------------------------------------------------------
# two-phase coordinated swap
# ---------------------------------------------------------------------------

def test_two_phase_swap_atomicity_under_poisson_load(artifacts):
    """A fleet swap under a live Poisson stream: every answer's tag is
    exactly the old or the new artifact id, its payload the JAX forward
    of that version, no microbatch mixes versions, and after the commit
    every replica serves the new one."""
    rows = _rows(400, seed=13)
    want = {_tag(artifacts[s]): _want(artifacts[s], rows) for s in (0, 1)}
    tags = [_tag(artifacts[s]) for s in (0, 1)]
    with _fleet(3, microbatch=16, deadline_s=0.002) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles: list = []
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(fleet.client("m"), rows, rate=400.0,
                             timeout_s=60.0)))
        feeder.start()
        time.sleep(0.2)                        # land the swap mid-stream
        prepared = fleet.prepare_swap("m", artifacts[1])
        assert set(fleet.admitted_tags("m").values()) == {tags[0]}
        rep = fleet.commit_swap(prepared)
        feeder.join(timeout=60.0)
        assert not feeder.is_alive()
        assert rep.new_tag == tags[1] and not rep.not_cut
        assert set(rep.old_tags.values()) == {tags[0]}
        assert set(fleet.admitted_tags("m").values()) == {tags[1]}
        assert len(handles) == len(rows)
        by_tag = dict.fromkeys(tags, 0)
        flush_tags: dict = {}
        for i, h in enumerate(handles):
            out = h.result(timeout=30.0)
            assert h.version_tag in by_tag, h.version_tag
            by_tag[h.version_tag] += 1
            assert np.array_equal(out, want[h.version_tag][i]), i
            flush_tags.setdefault(h.flush_key, set()).add(h.version_tag)
        assert all(len(s) == 1 for s in flush_tags.values())
        assert by_tag[tags[0]] > 0 and by_tag[tags[1]] > 0, by_tag


def test_swap_prepare_failure_aborts_fleet_wide(artifacts):
    rows = _rows(12, seed=17)
    want = _want(artifacts[0], rows)
    with _fleet(2, max_fetch_retries=0) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        old = _tag(artifacts[0])
        fleet.inject_fetch_corruption("r1", n=1)
        with pytest.raises(FleetSwapError, match="still serve the old"):
            fleet.prepare_swap("m", artifacts[1])
        assert set(fleet.admitted_tags("m").values()) == {old}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i])
            assert h.version_tag == old


def test_commit_skips_replica_killed_after_prepare(artifacts):
    rows = _rows(16, seed=19)
    want = _want(artifacts[1], rows)
    with _fleet(2) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        prepared = fleet.prepare_swap("m", artifacts[1])
        fleet.kill_replica("r1")
        rep = fleet.commit_swap(prepared)
        assert list(rep.blackout_s) == ["r0"]
        assert rep.not_cut == {"r1": "replica unhealthy at commit"}
        assert fleet.admitted_tags("m") == {"r0": rep.new_tag}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i])


def test_commit_absorbs_replica_killed_mid_commit(artifacts):
    rows = _rows(24, seed=29)
    want = _want(artifacts[1], rows)
    with _fleet(3) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        prepared = fleet.prepare_swap("m", artifacts[1])
        fleet._replica("r1").registry.close()
        assert fleet._replica("r1").healthy          # the race, exactly
        rep = fleet.commit_swap(prepared)
        assert set(rep.not_cut) == {"r1"}
        assert sorted(rep.blackout_s) == ["r0", "r2"]
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i])
            assert h.version_tag == rep.new_tag
            assert h.replica_id in ("r0", "r2")


# ---------------------------------------------------------------------------
# SLO tiers through the fleet
# ---------------------------------------------------------------------------

def test_fleet_tier_routing_bit_exact(artifacts):
    rows = _rows(48, seed=31)
    want = _want(artifacts[0], rows)
    tiers = [interactive_tier(60.0), BATCH]
    with _fleet(2, slo_tiers=tiers, work_stealing=True) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles = [fleet.submit("m", r, tier=tiers[i % 2])
                   for i, r in enumerate(rows)]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=30.0), want[i]), i
        assert fleet.sheds == 0


def test_fleet_sheds_provably_late_request_typed(artifacts):
    rows = _rows(32, seed=37)
    with _fleet(2, microbatch=4,
                slo_tiers=[interactive_tier(60.0), BATCH]) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        for h in [fleet.submit("m", r, tier=BATCH) for r in rows]:
            h.result(timeout=30.0)
        assert all(r.registry.estimate_delay_s("m") is not None
                   for r in fleet.replicas)
        with pytest.raises(DeadlineUnmeetable, match="shed"):
            fleet.submit("m", rows[0], tier=interactive_tier(1e-9))
        assert fleet.sheds == 1
        ok = fleet.submit("m", rows[0], tier=BATCH)
        assert np.array_equal(ok.result(timeout=30.0),
                              _want(artifacts[0], rows[:1])[0])


# ---------------------------------------------------------------------------
# soak: every fault class under one continuous stream
# ---------------------------------------------------------------------------

def test_fleet_soak_kill_corrupt_swap_zero_drops(artifacts):
    rows = _rows(3000, seed=23)
    want = {_tag(artifacts[s]): _want(artifacts[s], rows) for s in (0, 1)}
    tags = [_tag(artifacts[s]) for s in (0, 1)]
    with _fleet(4, microbatch=16, deadline_s=0.002) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles: list = []
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(fleet.client("m"), rows, rate=500.0,
                             timeout_s=240.0)))
        feeder.start()
        time.sleep(0.05)
        fleet.inject_fetch_corruption("r2", n=1)
        rep1 = fleet.swap_fleet("m", artifacts[1])
        fleet.kill_replica("r0")
        time.sleep(0.05)
        rep2 = fleet.swap_fleet("m", artifacts[0])
        feeder.join(timeout=300.0)
        assert (rep1.new_tag, rep2.new_tag) == (tags[1], tags[0])
        assert fleet.stats()["r2"]["verify_failures"] == 1
        assert len(handles) == len(rows)
        for i, h in enumerate(handles):
            out = h.result(timeout=30.0)
            assert np.array_equal(out, want[h.version_tag][i]), i
        live = fleet.admitted_tags("m")
        assert "r0" not in live and set(live.values()) == {tags[0]}
        assert all(v["outstanding"] == 0 for v in fleet.stats().values())
