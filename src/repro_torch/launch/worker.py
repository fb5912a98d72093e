"""Worker-process side of the cross-process LUT fleet, plus the
root-side client that drives it (port of ``repro.launch.worker``).

``python -m repro_torch.launch.worker --store DIR [--device DEV]`` binds
a loopback socket, prints one READY line (``LUT-WORKER READY port=<p>
pid=<pid>``) on stdout, accepts ONE root connection at a time, and
serves the wire protocol documented in
:mod:`repro_torch.launch.transport`: a ``HELLO`` stands up a
:class:`repro_torch.launch.registry.ModelRegistry` from the
root-supplied config, then ``SUBMIT``/``PREPARE``/``COMMIT``/
``ABANDON``/``PING`` (and streaming ``FETCH_*`` artifact transfer,
re-verified on receipt via ``verify_artifact``) operate it remotely.

The worker's registry runs on the CUDA card unless HELLO's ``device``
(or, failing that, ``--device``) names another device; without a card
and without such a name, HELLO fails with the registry's error.  A
worker builds nothing at start: its first REGISTER loads the kernel
library, and where the library is not yet in ``kernels/*/_build/`` that
first call pays the ``nvcc`` build (seconds) inside the root's call
timeout.  Each PING reply carries the worker's kernel launch counts
(``launches``), since counts live in the process that launches.

The root side (``spawn_worker`` + :class:`RemoteRegistry`) duck-types
the in-process ``ModelRegistry`` surface the fleet router consumes —
``submit``/``register``/``swap``/``prepare``/``commit``/``abandon``/
``model_ids``/``estimate_delay_s``/``close`` — so
``launch/fleet.LutFleet`` routes, distributes, and two-phase-swaps
identically over threads and processes.  ``estimate_delay_s`` is served
from the last heartbeat's piggybacked estimates (the router calls it
under its lock; it must never block on the wire).

torch is imported lazily (at HELLO time in the worker, never by the
root-side client), so spawning is cheap and the root process can manage
workers without touching the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.launch.transport import (FETCH_CHUNK_BYTES, MSG_ABANDON,
                                          MSG_COMMIT, MSG_ERR,
                                          MSG_FETCH_BEGIN, MSG_FETCH_CHUNK,
                                          MSG_FETCH_END, MSG_HELLO,
                                          MSG_LEAVE, MSG_MODEL_IDS, MSG_OK,
                                          MSG_PING, MSG_PREPARE,
                                          MSG_REGISTER, MSG_RESULT,
                                          MSG_SUBMIT, MSG_SWAP,
                                          ConnectionClosed, FrameConn,
                                          RpcClient, RpcError,
                                          TransportError, array_blob,
                                          array_meta, blob_array)

READY_PREFIX = "LUT-WORKER READY"
# how often a worker waiting for a root connection checks that the root
# process that spawned it still runs
ROOT_CHECK_S = 1.0


# ---------------------------------------------------------------------------
# worker (server) side
# ---------------------------------------------------------------------------


class WorkerServer:
    """Serves one root connection against one local ``ModelRegistry``.

    The reader loop stays non-blocking-fast: ``PING`` and ``SUBMIT``
    (admission + scoreboard insert) are handled inline; anything that
    loads or warms an engine (register/prepare/commit/swap, fetch
    assembly + verification) runs on a side thread so heartbeats keep
    flowing during multi-second warms (a first warm-up on a card may
    include the kernels' nvcc build).  ``device`` is the registry's
    device when HELLO names none (None: the CUDA card)."""

    def __init__(self, conn: FrameConn, store_dir: str,
                 device: Optional[str] = None):
        self.conn = conn
        self.store_dir = store_dir
        self.device = device
        self.registry = None                    # built on HELLO
        self._prepared: Dict[str, Any] = {}     # entry_id -> ModelEntry
        self._seq = 0
        self._xfers: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    # -- replies -------------------------------------------------------
    def _ok(self, rid: int, meta: Dict[str, Any], blob: bytes = b"") -> None:
        try:
            self.conn.send(MSG_OK, rid, meta, blob)
        except TransportError:
            pass

    def _err(self, rid: int, kind: str, msg: str) -> None:
        try:
            self.conn.send(MSG_ERR, rid, {"kind": kind, "error": msg})
        except TransportError:
            pass

    # -- serve loop ----------------------------------------------------
    def serve(self) -> bool:
        """Serve one root connection.  Returns True on a cooperative
        LEAVE (the worker should exit), False when the connection died
        under us — a PARTITION, not a shutdown: the registry (and any
        admitted work) stays alive so the process can outlive the
        severed socket and serve a future root connection."""
        left = False
        while True:
            try:
                msg, rid, meta, blob = self.conn.recv()
            except TransportError:
                break
            if msg == MSG_PING:
                self._ping(rid, meta)
            elif msg == MSG_SUBMIT:
                self._submit(rid, meta, blob)
            elif msg == MSG_FETCH_BEGIN:
                self._fetch_begin(rid, meta)
            elif msg == MSG_FETCH_CHUNK:
                self._fetch_chunk(meta, blob)
            elif msg == MSG_LEAVE:
                self._ok(rid, {})
                left = True
                break
            else:
                threading.Thread(target=self._slow, daemon=True,
                                 args=(msg, rid, meta, blob)).start()
        if left and self.registry is not None:
            self.registry.close()
        return left

    # -- fast inline handlers ------------------------------------------
    def _ping(self, rid: int, meta: Dict[str, Any]) -> None:
        """Delay estimates per model and this process's kernel launch
        counts (zeroed first when asked).  Takes no lock that a warm-up
        holds: the registry warms a new engine outside its routing
        lock, and the counts have their own."""
        ests: Dict[str, Optional[float]] = {}
        launches: Dict[str, int] = {}
        if self.registry is not None:
            from repro_torch.kernels.lut_gather import lut_gather as LG

            for mid in self.registry.model_ids():
                try:
                    ests[mid] = self.registry.estimate_delay_s(mid)
                except Exception:
                    ests[mid] = None
            launches = LG.launch_counts()
            if meta.get("reset_launches"):
                LG.reset_launch_counts()
        self._ok(rid, {"pid": os.getpid(), "delay_est": ests,
                       "launches": launches})

    def _submit(self, rid: int, meta: Dict[str, Any], blob: bytes) -> None:
        from repro_torch.launch.registry import UnknownModelError
        from repro_torch.launch.scheduler import DeadlineUnmeetable, SLOTier

        if self.registry is None:
            self._err(rid, "internal", "SUBMIT before HELLO")
            return
        tier = None
        if meta.get("tier"):
            t = meta["tier"]
            tier = SLOTier(t["name"], deadline_s=t.get("deadline_s"))
        try:
            x = blob_array(meta, blob)

            def on_done(h, rid=rid):
                self._send_result(rid, h)

            self.registry.submit(meta["model_id"], x,
                                 on_done=on_done, tier=tier)
        except UnknownModelError as e:
            self._err(rid, "unknown_model", str(e))
            return
        except DeadlineUnmeetable as e:
            self._err(rid, "deadline_unmeetable", str(e))
            return
        except Exception as e:
            self._err(rid, "internal", f"{type(e).__name__}: {e}")
            return
        self._ok(rid, {})

    def _send_result(self, rid: int, h) -> None:
        """Second answer to a SUBMIT: fires on the batcher thread via
        the handle's ``on_done`` hook once its microbatch flushed."""
        try:
            if h.failed:
                self.conn.send(MSG_RESULT, rid, {
                    "ok": False, "kind": "engine",
                    "error": f"{type(h._exc).__name__}: {h._exc}",
                    "tag": h.tag, "flush_key": list(h.flush_key or ())})
                return
            meta = array_meta(h._out)
            meta.update({"ok": True, "tag": h.tag,
                         "flush_key": list(h.flush_key or ())})
            self.conn.send(MSG_RESULT, rid, meta, array_blob(h._out))
        except TransportError:
            pass          # root is gone; its FleetHandle re-dispatches

    # -- streaming artifact transfer -----------------------------------
    def _fetch_begin(self, rid: int, meta: Dict[str, Any]) -> None:
        tmp = tempfile.mkdtemp(prefix="xfer-", dir=self.store_dir)
        with self._lock:
            self._xfers[rid] = {"dir": tmp, "name": meta["artifact"],
                                "files": {f: open(os.path.join(tmp, f), "wb")
                                          for f in meta["files"]}}

    def _fetch_chunk(self, meta: Dict[str, Any], blob: bytes) -> None:
        with self._lock:
            x = self._xfers.get(meta["xfer"])
        if x is not None:
            x["files"][meta["file"]].write(blob)

    def _finish_fetch(self, rid: int, meta: Dict[str, Any]) -> None:
        from repro_torch.artifact import ArtifactError, verify_artifact

        with self._lock:
            x = self._xfers.pop(meta["xfer"], None)
        if x is None:
            self._err(rid, "artifact", f"unknown transfer {meta['xfer']}")
            return
        for f in x["files"].values():
            f.close()
        dst = os.path.join(self.store_dir, x["name"])
        try:
            shutil.rmtree(dst, ignore_errors=True)
            os.rename(x["dir"], dst)
            # admission gate: per-slab SHA-256 re-hash of the bytes as
            # received — transport is where bits flip
            manifest = verify_artifact(dst)
        except ArtifactError as e:
            shutil.rmtree(dst, ignore_errors=True)
            self._err(rid, "artifact", str(e))
            return
        except OSError as e:
            shutil.rmtree(x["dir"], ignore_errors=True)
            self._err(rid, "artifact", f"assembly failed: {e}")
            return
        self._ok(rid, {"artifact_id": manifest["artifact_id"], "path": dst})

    # -- slow handlers (side threads) ----------------------------------
    def _slow(self, msg: int, rid: int, meta: Dict[str, Any],
              blob: bytes) -> None:
        try:
            if msg == MSG_HELLO:
                self._hello(rid, meta)
            elif msg == MSG_FETCH_END:
                self._finish_fetch(rid, meta)
            elif msg == MSG_REGISTER:
                self._register(rid, meta)
            elif msg == MSG_SWAP:
                self._swap(rid, meta)
            elif msg == MSG_PREPARE:
                self._prepare(rid, meta)
            elif msg == MSG_COMMIT:
                self._commit(rid, meta)
            elif msg == MSG_ABANDON:
                self._abandon(rid, meta)
            elif msg == MSG_MODEL_IDS:
                self._ok(rid, {"model_ids": self.registry.model_ids()})
            else:
                self._err(rid, "internal", f"unhandled message type {msg}")
        except Exception as e:
            self._err(rid, self._kind_of(e), f"{type(e).__name__}: {e}")

    @staticmethod
    def _kind_of(e: Exception) -> str:
        from repro_torch.artifact import ArtifactError
        from repro_torch.launch.registry import UnknownModelError
        from repro_torch.launch.scheduler import DeadlineUnmeetable

        if isinstance(e, UnknownModelError):
            return "unknown_model"
        if isinstance(e, DeadlineUnmeetable):
            return "deadline_unmeetable"
        if isinstance(e, ArtifactError):
            return "artifact"
        return "internal"

    def _hello(self, rid: int, meta: Dict[str, Any]) -> None:
        from repro_torch.launch.registry import ModelRegistry
        from repro_torch.launch.scheduler import SLOTier

        tiers = None
        if meta.get("slo_tiers"):
            tiers = [SLOTier(t["name"], deadline_s=t.get("deadline_s"))
                     for t in meta["slo_tiers"]]
        self.registry = ModelRegistry(
            meta.get("microbatch", 64), meta.get("deadline_s", 2e-3),
            device=meta.get("device") or self.device,
            slo_tiers=tiers, work_stealing=meta.get("work_stealing", False))
        self._ok(rid, {"pid": os.getpid(), "epoch": meta.get("epoch", 0),
                       "device": str(self.registry.device)})

    def _load(self, path: str):
        # hashes were checked at fetch admission — load without
        # re-hashing, packed: int4 slabs feed the kernels as they are
        from repro_torch.artifact import load_artifact
        return load_artifact(path, verify=False, unpack_int4=False,
                             device=self.registry.device)

    def _register(self, rid: int, meta: Dict[str, Any]) -> None:
        entry = self.registry.register(meta["model_id"],
                                       self._load(meta["path"]))
        self._ok(rid, {"version_tag": entry.version_tag,
                       "artifact_id": entry.artifact_id,
                       "warm_s": entry.warm_s})

    def _swap(self, rid: int, meta: Dict[str, Any]) -> None:
        rep = self.registry.swap(meta["model_id"], self._load(meta["path"]))
        self._ok(rid, dataclasses.asdict(rep))

    def _prepare(self, rid: int, meta: Dict[str, Any]) -> None:
        entry = self.registry.prepare(meta["model_id"],
                                      self._load(meta["path"]))
        with self._lock:
            self._seq += 1
            eid = f"e{self._seq}"
            self._prepared[eid] = entry
        self._ok(rid, {"entry_id": eid, "version_tag": entry.version_tag,
                       "artifact_id": entry.artifact_id,
                       "warm_s": entry.warm_s})

    def _pop_prepared(self, eid: str):
        with self._lock:
            entry = self._prepared.pop(eid, None)
        if entry is None:
            raise KeyError(f"no prepared entry {eid!r}")
        return entry

    def _commit(self, rid: int, meta: Dict[str, Any]) -> None:
        rep = self.registry.commit(meta["model_id"],
                                   self._pop_prepared(meta["entry_id"]))
        self._ok(rid, dataclasses.asdict(rep))

    def _abandon(self, rid: int, meta: Dict[str, Any]) -> None:
        try:
            self.registry.abandon(self._pop_prepared(meta["entry_id"]))
        except KeyError:
            pass                               # abandon is idempotent
        self._ok(rid, {})


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.worker",
        description="One LUT fleet worker: serves a root connection "
                    "over the socket RPC of repro_torch.launch.transport.")
    ap.add_argument("--store", required=True,
                    help="worker-local artifact store directory")
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="the registry's device when HELLO names none "
                         "(default: the CUDA card; 'cpu' for the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    os.makedirs(args.store, exist_ok=True)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.bind, 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    print(f"{READY_PREFIX} port={port} pid={os.getpid()}", flush=True)
    # the listener stays open for the worker's whole life: losing the
    # root connection is a PARTITION (the worker, its registry, and any
    # admitted work survive and await a reconnect), not a shutdown —
    # only a cooperative LEAVE, a signal, or the exit of the root
    # process that spawned it (no one is left to reconnect) ends it
    root = os.getppid()
    srv.settimeout(ROOT_CHECK_S)
    server = None
    while True:
        try:
            sock, _ = srv.accept()
        except socket.timeout:
            if os.getppid() != root:
                if server is not None and server.registry is not None:
                    server.registry.close()
                break
            continue
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if server is None:
            server = WorkerServer(FrameConn(sock), args.store, args.device)
        else:
            server.conn = FrameConn(sock)
        if server.serve():
            break
    srv.close()
    return 0


# ---------------------------------------------------------------------------
# root (client) side
# ---------------------------------------------------------------------------


class WorkerDied(ConnectionClosed):
    """The worker process (or its connection) went away."""


def spawn_worker(store_dir: str, *, ready_timeout_s: float = 30.0
                 ) -> Tuple[subprocess.Popen, int]:
    """Launch a worker subprocess and wait for its READY line.  The
    child inherits the parent env (``OMP_NUM_THREADS``,
    ``CUDA_VISIBLE_DEVICES``) with ``src/`` guaranteed on PYTHONPATH."""
    import repro_torch

    src_root = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.worker",
         "--store", store_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    deadline = time.monotonic() + ready_timeout_s
    port = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith(READY_PREFIX):
            fields = dict(kv.split("=") for kv in line.split()[2:])
            port = int(fields["port"])
            break
    if port is None:
        proc.kill()
        proc.wait()
        raise WorkerDied(
            f"worker did not print READY within {ready_timeout_s}s "
            f"(exit code {proc.poll()})")
    # drain any further stdout so the child never blocks on a full pipe
    threading.Thread(target=lambda: proc.stdout.read(), daemon=True).start()
    return proc, port


class RemoteEntry:
    """Root-side token for a prepared (phase-1) engine on a worker —
    the process peer of ``registry.ModelEntry`` in the fleet's
    ``PreparedFleetSwap``."""

    __slots__ = ("entry_id", "version_tag", "artifact_id", "warm_s")

    def __init__(self, entry_id: str, version_tag: str,
                 artifact_id: Optional[str], warm_s: float):
        self.entry_id = entry_id
        self.version_tag = version_tag
        self.artifact_id = artifact_id
        self.warm_s = warm_s


class RemoteArtifact:
    """Root-side token for an artifact fetched + verified into a
    worker's local store (``artifact_id`` was computed BY the worker
    from the bytes it received)."""

    __slots__ = ("artifact_id", "path")

    def __init__(self, artifact_id: str, path: str):
        self.artifact_id = artifact_id
        self.path = path


class RemoteRegistry:
    """Client proxy duck-typing the ``ModelRegistry`` surface the fleet
    consumes, over one :class:`transport.RpcClient` connection."""

    def __init__(self, proc: subprocess.Popen, port: int, *,
                 on_dead=None, call_timeout_s: float = 60.0):
        self.proc = proc
        self.port = port
        self.call_timeout_s = call_timeout_s
        sock = socket.create_connection(("127.0.0.1", port), timeout=10.0)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._client = RpcClient(sock, on_dead=on_dead)
        # written by the fleet's heartbeat prober, read by the router's
        # _pick under the fleet lock — never a blocking RPC
        self._delay_est: Dict[str, Optional[float]] = {}
        self._est_lock = threading.Lock()
        self._closed = False

    # -- registry lifecycle surface ------------------------------------
    def hello(self, config: Dict[str, Any]) -> Dict[str, Any]:
        meta, _ = self._client.call(MSG_HELLO, config,
                                    timeout=self.call_timeout_s)
        return meta

    def register(self, model_id: str, art: RemoteArtifact) -> None:
        self._call_typed(MSG_REGISTER,
                         {"model_id": model_id, "path": art.path})

    def swap(self, model_id: str, art: RemoteArtifact):
        meta = self._call_typed(MSG_SWAP,
                                {"model_id": model_id, "path": art.path})
        return _rebuild_swap_report(meta)

    def prepare(self, model_id: str, art: RemoteArtifact) -> RemoteEntry:
        meta = self._call_typed(MSG_PREPARE,
                                {"model_id": model_id, "path": art.path})
        return RemoteEntry(meta["entry_id"], meta["version_tag"],
                           meta.get("artifact_id"), meta.get("warm_s", 0.0))

    def commit(self, model_id: str, entry: RemoteEntry):
        meta = self._call_typed(MSG_COMMIT, {"model_id": model_id,
                                             "entry_id": entry.entry_id})
        return _rebuild_swap_report(meta)

    def abandon(self, entry) -> None:
        """Best-effort by contract: the fleet abandons prepared entries
        on hosts it already knows are dead."""
        try:
            self._call_typed(MSG_ABANDON, {"entry_id": entry.entry_id},
                             timeout=5.0)
        except (TransportError, RpcError):
            pass

    def model_ids(self) -> List[str]:
        meta = self._call_typed(MSG_MODEL_IDS, {})
        return list(meta.get("model_ids", []))

    def estimate_delay_s(self, model_id: str,
                         deadline_at: Optional[float] = None
                         ) -> Optional[float]:
        """Heartbeat-cached estimate (the router calls this under its
        lock — a blocking RPC here would serialize routing on the
        slowest worker)."""
        with self._est_lock:
            return self._delay_est.get(model_id)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        left = False
        try:
            self._client.call(MSG_LEAVE, {}, timeout=10.0)
            left = True
        except (TransportError, RpcError):
            pass
        self._client.close()
        if not left:
            # the cooperative goodbye never arrived (dead or
            # partitioned peer) — a partition-surviving worker would
            # otherwise linger in accept() forever, so reap it
            try:
                self.proc.terminate()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10.0)

    # -- request path --------------------------------------------------
    def submit(self, model_id: str, x, on_done=None, tier=None):
        """Submit one request; returns a live ``RequestHandle`` that
        completes when the worker's RESULT frame lands.  Typed errors
        map back: unknown model / deadline shed raise exactly what the
        in-process registry raises; a dead or unresponsive connection
        raises ``UnknownModelError`` so the router excludes this
        replica and re-routes (the fleet's heartbeat prober handles the
        health downgrade).

        A request completes (and ``on_done`` fires) exactly once, and
        only if this call returns it: a connection that dies before the
        SUBMIT is acknowledged fails the call, not the handle, so the
        caller's bookkeeping for a refused submit is never also run by
        ``on_done``.  A RESULT that beats its own ack completes the
        handle at once, and the call then returns it even if the ack is
        lost."""
        from repro_torch.launch.batching import RequestHandle
        from repro_torch.launch.registry import UnknownModelError
        from repro_torch.launch.scheduler import DeadlineUnmeetable

        now = time.monotonic()
        h = RequestHandle(
            x=np.asarray(x), t_submit=now, on_done=on_done, tier=tier,
            deadline_at=(now + tier.deadline_s
                         if tier is not None and tier.deadline_s is not None
                         else None))
        rid = self._client.new_req_id()
        lock = threading.Lock()
        state = {"acked": False, "held": False}

        def complete():
            h.t_done = time.monotonic()
            h._event.set()
            if h.on_done is not None:
                try:
                    h.on_done(h)
                except Exception:
                    pass

        def on_result(meta, blob, exc):
            if exc is not None:
                h._exc = exc
                with lock:
                    # not yet acked: the SUBMIT call fails with the
                    # connection, and its caller re-routes the request
                    state["held"] = not state["acked"]
                    if state["held"]:
                        return
            elif meta.get("ok"):
                h._out = blob_array(meta, blob)
                h.tag = meta.get("tag")
                h.flush_key = tuple(meta.get("flush_key") or ())
            else:
                h._exc = RuntimeError(meta.get("error", "engine failed"))
                h.tag = meta.get("tag")
                h.flush_key = tuple(meta.get("flush_key") or ())
            complete()

        self._client.expect_result(rid, on_result)
        meta = dict(array_meta(h.x))
        meta["model_id"] = model_id
        if tier is not None:
            meta["tier"] = {"name": tier.name, "deadline_s": tier.deadline_s}
        try:
            self._client.call(MSG_SUBMIT, meta, array_blob(h.x),
                              req_id=rid, timeout=self.call_timeout_s)
        except RpcError as e:
            self._drop_result_handler(rid)
            if e.kind == "unknown_model":
                raise UnknownModelError(str(e)) from e
            if e.kind == "deadline_unmeetable":
                raise DeadlineUnmeetable(str(e)) from e
            raise UnknownModelError(f"worker rejected submit: {e}") from e
        except TransportError as e:
            self._drop_result_handler(rid)
            if h.done and not h.failed:
                return h                   # answered; only the ack was lost
            raise UnknownModelError(
                f"worker unreachable for submit: {e}") from e
        with lock:
            state["acked"] = True
            held = state["held"]
        if held:
            # the connection died between the ack and this line
            complete()
        return h

    def _drop_result_handler(self, rid: int) -> None:
        with self._client._lock:
            self._client._result_handlers.pop(rid, None)

    # -- artifact transfer ---------------------------------------------
    def fetch(self, source: str, *, corrupt: bool = False) -> RemoteArtifact:
        """Stream ``source`` (an artifact dir, or a directory holding
        one) to the worker's store.
        The worker re-hashes every slab on receipt; a verification
        failure surfaces as ``ArtifactError`` here so the fleet's
        retry-budget loop treats wire corruption exactly like the
        thread fleet's copy corruption.  ``corrupt=True`` flips one bit
        mid-stream in the slab payload (fault injection)."""
        from repro_torch.artifact import ArtifactError, find_artifacts
        from repro_torch.artifact.store import MANIFEST, SLAB_FILE

        # a directory of artifacts sends the one copy_artifact would
        hits = find_artifacts(source)
        if not hits:
            raise ArtifactError(f"no artifact manifest under {source!r}")
        source = hits[0]
        files = [MANIFEST, SLAB_FILE]
        xfer = self._client.new_req_id()
        self._client.send_oneway(
            MSG_FETCH_BEGIN, xfer,
            {"artifact": os.path.basename(os.path.normpath(source)),
             "files": files})
        for name in files:
            path = os.path.join(source, name)
            size = os.path.getsize(path)
            flip_at = size // 2 if (corrupt and name == SLAB_FILE) else None
            sent = 0
            with open(path, "rb") as f:
                seq = 0
                while True:
                    chunk = f.read(FETCH_CHUNK_BYTES)
                    if not chunk:
                        break
                    if (flip_at is not None
                            and sent <= flip_at < sent + len(chunk)):
                        b = bytearray(chunk)
                        b[flip_at - sent] ^= 0x01
                        chunk = bytes(b)
                    self._client.send_oneway(
                        MSG_FETCH_CHUNK, self._client.new_req_id(),
                        {"xfer": xfer, "file": name, "seq": seq}, chunk)
                    sent += len(chunk)
                    seq += 1
        try:
            meta = self._call_typed(MSG_FETCH_END, {"xfer": xfer})
        except RpcError as e:
            if e.kind == "artifact":
                raise ArtifactError(str(e)) from e
            raise
        return RemoteArtifact(meta["artifact_id"], meta["path"])

    # -- probing -------------------------------------------------------
    def ping(self, timeout: float = 5.0,
             reset_launches: bool = False) -> Dict[str, Any]:
        """Liveness probe; refreshes the cached delay estimates.  The
        reply's ``launches`` are the worker's kernel launch counts
        (before the reset, with ``reset_launches``)."""
        meta, _ = self._client.call(
            MSG_PING, {"reset_launches": True} if reset_launches else {},
            timeout=timeout)
        with self._est_lock:
            self._delay_est = dict(meta.get("delay_est", {}))
        return meta

    def partition(self) -> None:
        """Fault injection: sever the socket without touching the
        worker process (a network partition, not a host death)."""
        self._client.conn.close()

    # -- internals -----------------------------------------------------
    def _call_typed(self, msg_type: int, meta: Dict[str, Any],
                    timeout: Optional[float] = None) -> Dict[str, Any]:
        out, _ = self._client.call(
            msg_type, meta,
            timeout=self.call_timeout_s if timeout is None else timeout)
        return out


def _rebuild_swap_report(meta: Dict[str, Any]):
    from repro_torch.launch.registry import SwapReport
    fields = {f: meta.get(f) for f in (
        "model_id", "old_version", "new_version", "old_artifact_id",
        "new_artifact_id", "warm_s", "blackout_s", "drained_requests")}
    return SwapReport(**fields)


if __name__ == "__main__":
    sys.exit(main())
