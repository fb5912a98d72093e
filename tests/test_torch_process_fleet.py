"""Port parity of the serving fleet across processes (``repro_torch.
launch.fleet`` with ``transport="process"``, ``launch/worker.py`` and
``launch/transport.py``), on the CPU: every worker is told
``device="cpu"`` and runs one intra-op thread (``OMP_NUM_THREADS=1``).

The contracts of ``tests/test_process_fleet.py`` at its smallest sizes:
1- and 2-worker conformance (bit for bit against the JAX package's plain
forward of the same artifact, tags and flush keys over the wire), a
SIGKILL with requests in flight (zero dropped, zero hung, the router's
counts back to zero), a partition between prepare and commit, a slab
corrupted in flight and re-fetched, an exhausted fetch budget, heartbeat
detection of a silent death with an epoch bump, and no mixed-version
microbatch under a swap.  Besides: a worker without a card refuses to
start unless told a device; PING answers while a warm-up holds the
engine; a SUBMIT that the connection's death refuses never also
completes its handle (the router would count it twice).
"""
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from repro.artifact import save_artifact as jsave
from repro_torch.kernels.lut_gather import lut_gather as LG
from repro_torch.launch import transport as wire
from repro_torch.launch.batching import replay_open_loop
from repro_torch.launch.fleet import FleetError, LutFleet, ProcessReplica
from repro_torch.launch.registry import UnknownModelError
from repro_torch.launch.worker import RemoteRegistry, WorkerServer
from test_torch_fleet import _rows, _synthesise, _tag, _want  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpfleet-artifacts")
    paths = {}
    for seed in (0, 1):
        spec, tables = _synthesise(seed, "tpfleet")
        paths[seed] = jsave(str(root), tables, name=f"tpfleet-v{seed}",
                            spec=spec)
    return paths


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _pfleet(n, **kw):
    kw.setdefault("microbatch", 8)
    kw.setdefault("deadline_s", 0.003)
    return LutFleet(n, transport="process", device="cpu", **kw)


def _wait_for(cond, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# conformance over the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_workers", [1, 2])
def test_process_fleet_bit_exact_vs_jax_forward(artifacts, n_workers):
    rows = _rows(32)
    want = _want(artifacts[0], rows)
    tag = _tag(artifacts[0])
    with _pfleet(n_workers) as fleet:
        assert all(isinstance(r, ProcessReplica) for r in fleet.replicas)
        assert len({r.proc.pid for r in fleet.replicas}) == n_workers
        report = fleet.distribute_artifact(artifacts[0], "m")
        assert all(d.admitted and d.fetches == 1 for d in report.values())
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i
            assert h.version_tag == tag
            assert h.flush_key is not None
        st = fleet.stats()
        assert sum(v["served"] for v in st.values()) == len(rows)
        if n_workers > 1:
            assert all(v["served"] > 0 for v in st.values()), st
        assert all(v["outstanding"] == 0 for v in st.values())
        # each worker reports its own launch counts over the wire (all
        # 0 on the CPU: the plain path launches no kernel)
        counts = fleet.launch_counts(reset=True)
        assert set(counts) == {r.replica_id for r in fleet.replicas}
        for c in counts.values():
            assert set(c) == set(LG.LIBRARY.launches) and not any(c.values())


def test_worker_needs_a_card_unless_told(monkeypatch, tmp_path):
    """A worker told no device serves on the CUDA card; with no card it
    refuses HELLO, and the fleet fails to start, reaps it and leaves no
    store behind."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(FleetError, match="no CUDA device"):
        LutFleet(1, transport="process")
    assert not list(tmp_path.iterdir())


ROOT_THAT_DIES = """
import os, sys
from repro_torch.launch.worker import spawn_worker
proc, _ = spawn_worker(sys.argv[1])
print(proc.pid, flush=True)
os._exit(0)
"""


def _running(pid: int) -> bool:
    """False once ``pid`` has exited (gone, or a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except FileNotFoundError:
        return False


def test_worker_exits_when_its_root_dies(tmp_path):
    """A worker outlives a severed connection (a partition) but not the
    root process that spawned it: with no one left to reconnect, a
    worker whose root died exits on its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    root = subprocess.run([sys.executable, "-c", ROOT_THAT_DIES,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=60)
    assert root.returncode == 0, root.stderr
    pid = int(root.stdout.split()[0])
    _wait_for(lambda: not _running(pid), 15.0)
    assert not _running(pid)


# ---------------------------------------------------------------------------
# SIGKILL with requests in flight
# ---------------------------------------------------------------------------

def test_sigkill_mid_request_zero_drops(artifacts):
    """SIGKILL a worker while its queue holds live requests and a
    producer keeps submitting: every request completes bit for bit,
    none hangs, and no replica's outstanding count is left off zero."""
    rows = _rows(120, seed=7)
    want = _want(artifacts[0], rows)
    # microbatches wider than the stream and a deadline well past the
    # submits: the victim still holds its requests when the kill lands
    # (each re-dispatched request then waits out one deadline alone)
    with _pfleet(2, microbatch=64, deadline_s=0.1) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        first = [fleet.submit("m", r) for r in rows[:40]]
        victim = max(fleet.stats().items(),
                     key=lambda kv: kv[1]["outstanding"])[0]
        late: list = []

        def producer():
            for r in rows[40:]:
                late.append(fleet.submit("m", r))
                time.sleep(0.0005)

        t = threading.Thread(target=producer)
        t.start()
        fleet.kill_replica(victim)                 # real SIGKILL
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert fleet._replica(victim).proc.poll() is not None
        handles = first + late
        assert len(handles) == len(rows)
        retried = 0
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i
            retried += h.retries
        assert retried > 0, "kill landed after all flushes — not in flight"
        st = fleet.stats()
        assert st[victim]["healthy"] is False
        assert all(v["outstanding"] == 0 for v in st.values()), st


class _Peer:
    """The worker's end of a socket pair, scripted: read one SUBMIT,
    then optionally answer it with a RESULT, then close without the
    ack."""

    def __init__(self, sock, send_result: bool):
        self.conn = wire.FrameConn(sock)
        self.send_result = send_result
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        _, rid, meta, blob = self.conn.recv()
        if self.send_result:
            out = np.zeros(3, np.int32)
            self.conn.send(wire.MSG_RESULT, rid, dict(
                wire.array_meta(out), ok=True, tag="v", flush_key=[0, 1]),
                wire.array_blob(out))
        self.conn.close()


@pytest.mark.parametrize("send_result", [False, True])
def test_submit_racing_connection_death_completes_at_most_once(send_result):
    """The race behind a dropped count: a connection that dies before a
    SUBMIT's ack.  With no answer, the call raises (the router re-routes
    and undoes its count) and the handle's ``on_done`` never fires; an
    answer that beat the lost ack completes the handle once, and the
    call returns it."""
    a, b = socket.socketpair()
    reg = RemoteRegistry.__new__(RemoteRegistry)
    reg.call_timeout_s = 10.0
    reg._client = wire.RpcClient(a)
    peer = _Peer(b, send_result)
    done = []
    try:
        if send_result:
            h = reg.submit("m", np.ones(4, np.int32), on_done=done.append)
            assert h.done and not h.failed and h.tag == "v"
            np.testing.assert_array_equal(h.result(timeout=1.0),
                                          np.zeros(3, np.int32))
        else:
            with pytest.raises(UnknownModelError, match="unreachable"):
                reg.submit("m", np.ones(4, np.int32), on_done=done.append)
    finally:
        peer.thread.join(timeout=10.0)
        reg._client.close()
    time.sleep(0.05)          # any late callback would land by now
    assert len(done) == (1 if send_result else 0)


# ---------------------------------------------------------------------------
# partition, corruption, fetch budget
# ---------------------------------------------------------------------------

def test_partition_during_commit_survivors_cut(artifacts):
    rows = _rows(24, seed=11)
    want = _want(artifacts[1], rows)
    with _pfleet(2) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        prepared = fleet.prepare_swap("m", artifacts[1])
        epoch0 = fleet.membership()["epoch"]
        fleet.partition_replica("r1")
        _wait_for(lambda: fleet.healthy_replicas() == ["r0"])
        assert fleet.healthy_replicas() == ["r0"]
        assert fleet.membership()["epoch"] == epoch0 + 1
        rep = fleet.commit_swap(prepared)
        assert "r1" in rep.not_cut
        assert list(rep.blackout_s) == ["r0"]
        assert fleet.admitted_tags("m") == {"r0": _tag(artifacts[1])}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i
            assert h.replica_id == "r0"
        assert fleet._replica("r1").proc.poll() is None   # still alive


def test_corrupt_slab_in_flight_refetched(artifacts):
    rows = _rows(16, seed=13)
    want = _want(artifacts[0], rows)
    tag = _tag(artifacts[0])
    with _pfleet(2) as fleet:
        fleet.inject_fetch_corruption("r1", n=1)
        report = fleet.distribute_artifact(artifacts[0], "m")
        assert report["r0"].admitted and report["r0"].fetches == 1
        assert report["r1"].admitted and report["r1"].fetches == 2
        assert report["r1"].verify_failures == 1
        assert report["r0"].artifact_id == report["r1"].artifact_id == tag
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i


def test_exhausted_fetch_budget_excludes_worker(artifacts):
    rows = _rows(12, seed=17)
    want = _want(artifacts[0], rows)
    with _pfleet(2, max_fetch_retries=1) as fleet:
        fleet.inject_fetch_corruption("r1", n=2)
        report = fleet.distribute_artifact(artifacts[0], "m")
        assert report["r0"].admitted and not report["r1"].admitted
        assert report["r1"].verify_failures == 2
        assert fleet.admitted_tags("m").keys() == {"r0"}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i
            assert h.replica_id == "r0"


# ---------------------------------------------------------------------------
# membership: heartbeat liveness and epochs
# ---------------------------------------------------------------------------

def test_heartbeat_detects_silent_worker_death(artifacts):
    rows = _rows(16, seed=19)
    want = _want(artifacts[0], rows)
    with _pfleet(2, heartbeat_s=0.05, heartbeat_miss_limit=2) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        m = fleet.membership()
        assert m["epoch"] == 2 and [e["event"] for e in m["events"]] == \
            ["join", "join"]
        fleet._replica("r1").proc.kill()        # silent host death
        t0 = time.monotonic()
        _wait_for(lambda: fleet.healthy_replicas() == ["r0"], 15.0)
        assert fleet.healthy_replicas() == ["r0"], "death never detected"
        assert time.monotonic() - t0 < 10.0
        m = fleet.membership()
        assert m["epoch"] == 3
        assert m["events"][-1]["event"] in ("heartbeat-dead", "conn-lost")
        assert m["replicas"] == {"r0": "up", "r1": "down"}
        handles = [fleet.submit("m", r) for r in rows]
        for i, h in enumerate(handles):
            assert np.array_equal(h.result(timeout=60.0), want[i]), i
            assert h.replica_id == "r0"
        fleet.kill_replica("r0")
        assert fleet.membership()["events"][-1]["event"] == "killed"
        assert fleet.membership()["epoch"] == 4


class _Sink:
    """A FrameConn stand-in that keeps what the worker sends."""

    def __init__(self):
        self.sent = []

    def send(self, msg_type, req_id, meta, blob=b""):
        self.sent.append((msg_type, req_id, meta))


def test_ping_answers_while_a_warm_up_holds_the_engine(artifacts,
                                                      monkeypatch):
    """PING is served inline by the reader loop; it must not wait on
    anything a REGISTER's warm-up holds (a first warm-up on a card can
    include an nvcc build)."""
    from repro_torch.kernels.lut_gather import ops

    release = threading.Event()
    real = ops.make_network_fn

    def slow_make(*a, **kw):
        fn = real(*a, **kw)

        def warming(x):
            release.wait(timeout=30.0)
            return fn(x)

        return warming

    monkeypatch.setattr(ops, "make_network_fn", slow_make)
    sink = _Sink()
    srv = WorkerServer(sink, store_dir=str(artifacts[0]), device="cpu")
    srv._hello(1, {"microbatch": 4})
    reg = threading.Thread(target=srv._register, args=(
        2, {"model_id": "m", "path": str(artifacts[0])}))
    reg.start()
    try:
        time.sleep(0.2)                        # the warm-up is blocked
        assert reg.is_alive()
        t0 = time.monotonic()
        srv._ping(3, {})
        assert time.monotonic() - t0 < 1.0
        assert sink.sent[-1][:2] == (wire.MSG_OK, 3)
        assert set(sink.sent[-1][2]["launches"]) == set(LG.LIBRARY.launches)
    finally:
        release.set()
        reg.join(timeout=30.0)
        srv.registry.close()
    assert not reg.is_alive()
    assert sink.sent[-1][:2] == (wire.MSG_OK, 2)


# ---------------------------------------------------------------------------
# swap atomicity under load, over the wire
# ---------------------------------------------------------------------------

def test_no_mixed_version_microbatch_across_processes(artifacts):
    rows = _rows(450, seed=23)          # 1.5 s: the swap lands mid-stream
    want = {_tag(artifacts[s]): _want(artifacts[s], rows) for s in (0, 1)}
    tags = [_tag(artifacts[s]) for s in (0, 1)]
    with _pfleet(2, microbatch=16, deadline_s=0.002) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles: list = []
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(fleet.client("m"), rows, rate=300.0,
                             timeout_s=120.0)))
        feeder.start()
        time.sleep(0.1)
        rep = fleet.commit_swap(fleet.prepare_swap("m", artifacts[1]))
        feeder.join(timeout=120.0)
        assert not feeder.is_alive()
        assert rep.new_tag == tags[1] and not rep.not_cut
        assert len(handles) == len(rows)
        flush_tags: dict = {}
        by_tag = dict.fromkeys(tags, 0)
        for i, h in enumerate(handles):
            out = h.result(timeout=60.0)
            assert h.version_tag in by_tag, h.version_tag
            by_tag[h.version_tag] += 1
            assert np.array_equal(out, want[h.version_tag][i]), i
            flush_tags.setdefault(h.flush_key, set()).add(h.version_tag)
        assert all(len(s) == 1 for s in flush_tags.values())
        assert by_tag[tags[0]] > 0 and by_tag[tags[1]] > 0, by_tag
        assert set(fleet.admitted_tags("m").values()) == {tags[1]}


# ---------------------------------------------------------------------------
# soak: every process-fault class under one stream
# ---------------------------------------------------------------------------

def test_process_fleet_soak_kill_partition_corrupt_swap(artifacts):
    rows = _rows(1500, seed=29)
    want = {_tag(artifacts[s]): _want(artifacts[s], rows) for s in (0, 1)}
    tags = [_tag(artifacts[s]) for s in (0, 1)]
    with _pfleet(4, microbatch=16, deadline_s=0.002,
                 heartbeat_s=0.1) as fleet:
        fleet.distribute_artifact(artifacts[0], "m")
        handles: list = []
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(fleet.client("m"), rows, rate=400.0,
                             timeout_s=600.0)))
        feeder.start()
        time.sleep(0.05)
        fleet.inject_fetch_corruption("r2", n=1)
        rep1 = fleet.swap_fleet("m", artifacts[1])
        fleet.kill_replica("r0")
        time.sleep(0.05)
        fleet.partition_replica("r3")
        _wait_for(lambda: set(fleet.healthy_replicas()) == {"r1", "r2"},
                  15.0)
        assert set(fleet.healthy_replicas()) == {"r1", "r2"}
        rep2 = fleet.swap_fleet("m", artifacts[0])
        feeder.join(timeout=600.0)
        assert (rep1.new_tag, rep2.new_tag) == (tags[1], tags[0])
        assert fleet.stats()["r2"]["verify_failures"] == 1
        assert len(handles) == len(rows)
        for i, h in enumerate(handles):
            out = h.result(timeout=60.0)
            assert np.array_equal(out, want[h.version_tag][i]), i
        live = fleet.admitted_tags("m")
        assert set(live) == {"r1", "r2"} and set(live.values()) == {tags[0]}
        events = [e["event"] for e in fleet.membership()["events"]]
        assert events.count("join") == 4 and "killed" in events
        assert fleet._replica("r3").proc.poll() is None
