"""Multi-replica LUT serving fleet: routing, artifact distribution,
and coordinated hot-swap (port of ``repro.launch.fleet``).

One ``ModelRegistry`` covers one host.  This module lifts that to a
FLEET: N registry replicas (threads standing in for hosts, the same
stand-in pattern the MicroBatcher uses for async serving, or real
worker processes) behind a ``LutFleet`` router.  Every replica serves
on the CUDA card unless the fleet is given another ``device``
(``"cpu"``: the plain PyTorch path); without a card and without one,
building the fleet raises.  Three fleet-level contracts, each pinned by
tests/test_torch_fleet.py and tests/test_torch_process_fleet.py:

* **Routing** — ``submit`` picks the healthy replica with the fewest
  outstanding requests (least-outstanding, ties by replica id) among
  those that have ADMITTED the model's artifact.  A replica that dies
  with requests in flight fails those batches with the typed
  ``ReplicaCrashed``; their ``FleetHandle``s re-dispatch to a healthy
  replica transparently, and submits that race the death are absorbed
  the same way — zero requests dropped, zero silently hung.  Responses
  are bit-exact vs the plain forward of the served artifact: a replica
  is a pure execution placement, never a numeric change.

* **Artifact distribution** — ``distribute_artifact`` ships a
  content-addressed artifact (``repro_torch.artifact``) to every
  replica's local store (``copy_artifact``) and gates admission on a
  full manifest-hash re-verification (``verify_artifact``) AT THE
  REPLICA — transport is where bits flip, and content-addressed ids
  make the check free.  A copy that fails verification is deleted and
  re-fetched; a replica that exhausts its fetch budget is simply never
  admitted for that model and the router excludes it.

* **Coordinated swap** — two-phase: ``prepare_swap`` distributes +
  verifies the new artifact and warms a replacement engine OFF-PATH on
  every replica (old version keeps serving throughout; any failure
  aborts the whole cutover with every replica still on the old
  version); ``commit_swap`` then cuts replicas over one registry-commit
  at a time — each commit is a microsecond dict swap, so the fleet
  converges within one tight loop.  Every response echoes the version
  tag of the engine that ACTUALLY served it (stamped at flush time by
  the MicroBatcher), so the harness can prove the cutover window never
  serves anything but old-or-new and no microbatch ever mixes versions.

The fleet runs over TWO transports behind one router:

* ``transport="thread"`` — replicas are in-process registries (the
  original stand-in: ``copy_artifact`` plays the wire), still the
  default for the pure scheduling/consistency harnesses.
* ``transport="process"`` — replicas are REAL worker processes
  (``launch/worker.py``) behind the length-prefixed socket RPC of
  ``launch/transport.py``: submits, two-phase swaps, and artifact
  distribution (streaming slab transfer, per-slab SHA-256 re-verified
  on receipt) all cross a process boundary.  Membership is versioned
  by a root-owned EPOCH counter (every join/leave/death bumps it) and
  liveness comes from a heartbeat prober — not injected flags: a
  worker that misses ``heartbeat_miss_limit`` consecutive pings is
  declared dead, its in-flight requests fail over via their
  ``FleetHandle``, and the router stops picking it.  Kernel launches
  are counted in the process that launches, so each worker reports
  its own counts in its PING replies (``launch_counts``).

``_pick``/``_dispatch``/``prepare_swap``/``commit_swap`` are shared
verbatim across both transports — a replica is a pure execution
placement, so every contract above holds bit-for-bit over the wire
(tests/test_torch_process_fleet.py re-pins them through real SIGKILL,
socket partition, and in-flight slab corruption).

``mesh=`` (thread transport) makes every replica's registry split its
microbatches over that device mesh; a mesh cannot cross the process
transport, whose workers own their devices.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.artifact import (ArtifactError, copy_artifact,
                                  load_artifact, verify_artifact)
from repro_torch.artifact.store import SLAB_FILE
from repro_torch.device import DeviceLike
from repro_torch.launch.registry import (ModelEntry, ModelRegistry,
                                         SwapReport, UnknownModelError)
from repro_torch.launch.scheduler import DeadlineUnmeetable, SLOTier
from repro_torch.launch.worker import RemoteRegistry, spawn_worker


class FleetError(RuntimeError):
    """Fleet-level routing/coordination failure."""


class NoHealthyReplica(FleetError):
    """No healthy replica has admitted the requested model."""


class ReplicaCrashed(RuntimeError):
    """Injected host death: the replica's engine gate raises this for
    every batch once the replica is killed, failing in-flight requests
    the way a severed host connection would (they re-dispatch via their
    FleetHandle, they do not drain gracefully)."""


class FleetSwapError(FleetError):
    """A two-phase swap could not prepare everywhere — the commit was
    never attempted and every replica still serves the old version."""


@dataclasses.dataclass
class Replica:
    """One in-process 'host': its registry, local artifact store, and
    the router-side bookkeeping (health, load, fault injection)."""

    replica_id: str
    registry: ModelRegistry
    store_dir: str
    healthy: bool = True
    crashed: bool = False
    outstanding: int = 0                 # in-flight requests (router lock)
    served: int = 0                      # completed requests
    fetches: int = 0                     # artifact transfer attempts
    verify_failures: int = 0             # copies rejected at admission
    fetch_faults: int = 0                # injected corruptions pending
    admitted: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProcessReplica(Replica):
    """A real worker process behind the socket transport.  ``registry``
    is a ``worker.RemoteRegistry`` proxy duck-typing the in-process
    surface, so every router code path is shared with ``Replica``."""

    proc: Any = None                     # subprocess.Popen
    port: int = 0
    missed_beats: int = 0                # consecutive failed heartbeats


@dataclasses.dataclass
class _FetchAcct:
    """Per-rollout fetch accounting.  ``Replica.fetches`` /
    ``verify_failures`` are fleet-lifetime counters shared by every
    concurrent rollout; a distribution report must count only ITS OWN
    attempts, so ``_fetch_verified`` accumulates into one of these
    under the router lock instead of callers diffing the shared
    counters outside it."""

    fetches: int = 0
    verify_failures: int = 0


@dataclasses.dataclass
class ReplicaDistribution:
    """Per-replica outcome of one distribute/prepare round."""

    replica_id: str
    admitted: bool
    artifact_id: Optional[str]
    fetches: int
    verify_failures: int
    error: Optional[str] = None


@dataclasses.dataclass
class PreparedFleetSwap:
    """Phase-1 token: every target replica holds a warmed, verified,
    NOT-yet-routable engine for ``new_tag``."""

    model_id: str
    new_tag: str
    entries: Dict[str, Tuple[Replica, ModelEntry]]
    distribution: Dict[str, ReplicaDistribution]
    prepare_s: float = 0.0


@dataclasses.dataclass
class FleetSwapReport:
    """What the fleet cutover cost.  ``commit_window_s`` spans the
    first replica's cut to the last's — the only interval during which
    different replicas may serve different versions (each individual
    response is still exactly old or new, stamped by tag)."""

    model_id: str
    old_tags: Dict[str, str]
    new_tag: str
    commit_window_s: float
    blackout_s: Dict[str, float]
    drained_requests: Dict[str, int]
    prepare_s: float
    # replicas whose commit failed mid-cutover (e.g. a kill racing the
    # commit loop): replica id -> error.  The survivors still cut; the
    # caller sees exactly which hosts did not.
    not_cut: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def max_blackout_s(self) -> float:
        return max(self.blackout_s.values(), default=0.0)

    @property
    def total_drained(self) -> int:
        return sum(self.drained_requests.values())


class FleetHandle:
    """One fleet-level request.  Wraps the replica-local
    ``RequestHandle`` it is currently riding; if that replica's batch
    fails (host death, engine fault), ``result()`` re-dispatches to a
    healthy replica and keeps waiting — the caller sees one completed
    request or one typed error, never a silent drop.

    ``version_tag`` (valid once done) echoes the artifact version of
    the engine that actually served the final attempt; ``flush_key``
    identifies the exact (replica, microbatch) it rode in."""

    def __init__(self, fleet: "LutFleet", model_id: str, x,
                 tier: Optional[SLOTier] = None):
        self._fleet = fleet
        self.model_id = model_id
        self.x = np.asarray(x)
        self.tier = tier
        self.t_submit = time.monotonic()
        self.replica_ids: List[str] = []   # dispatch history, last = current
        self.retries = 0                   # re-dispatches after a failure
        self.route_s = 0.0                 # cumulative router-side time
        self._inner = None                 # current RequestHandle

    @property
    def replica_id(self) -> Optional[str]:
        return self.replica_ids[-1] if self.replica_ids else None

    @property
    def done(self) -> bool:
        return self._inner is not None and self._inner.done

    @property
    def failed(self) -> bool:
        return self._inner is not None and self._inner.failed

    @property
    def version_tag(self) -> Optional[str]:
        return None if self._inner is None else self._inner.tag

    @property
    def flush_key(self) -> Optional[tuple]:
        if self._inner is None or self._inner.flush_key is None:
            return None
        return (self.replica_id,) + tuple(self._inner.flush_key)

    @property
    def latency_s(self) -> float:
        """Submit-to-completion, across re-dispatches (valid once done)."""
        return self._inner.t_done - self.t_submit

    def result(self, timeout: Optional[float] = 60.0) -> np.ndarray:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            try:
                return self._inner.result(timeout=left)
            except TimeoutError:
                raise
            except RuntimeError:
                # this attempt's batch failed (replica death / engine
                # fault) — re-dispatch; NoHealthyReplica ends the loop.
                # A persistently fast-failing replica must not turn the
                # timeout into an infinite retry spin: a failed handle
                # completes instantly (the event IS set), so the
                # deadline has to be enforced here, between attempts.
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"request not served within timeout after "
                        f"{self.retries} re-dispatches")
                self.retries += 1
                self._fleet._dispatch(self)


class LutFleet:
    """N registry replicas behind a least-outstanding router, with
    verified artifact distribution and two-phase coordinated swap.
    Context-manages like the registry: ``close()`` tears every replica
    down (draining queues) and removes the fleet-owned store."""

    def __init__(self, n_replicas: int = 2, microbatch: int = 64,
                 deadline_s: float = 2e-3, *, mesh=None,
                 device: DeviceLike = None,
                 store_root: Optional[str] = None,
                 max_fetch_retries: int = 2,
                 slo_tiers: Optional[List[SLOTier]] = None,
                 work_stealing: bool = False,
                 transport: str = "thread",
                 heartbeat_s: float = 0.25,
                 heartbeat_miss_limit: int = 3):
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if transport not in ("thread", "process"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "process" and mesh is not None:
            raise ValueError("a device mesh cannot cross the process "
                             "transport — workers own their devices")
        self.transport = transport
        self.max_fetch_retries = max_fetch_retries
        self.slo_tiers = list(slo_tiers) if slo_tiers else None
        self.sheds = 0               # requests shed before dispatch
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_miss_limit = int(heartbeat_miss_limit)
        # membership: a root-owned epoch counter — every join, leave,
        # and declared death bumps it (see transport.py "Epoch
        # semantics"); the event log names each bump
        self.epoch = 0
        self.membership_events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._own_store = store_root is None
        self.store_root = store_root or tempfile.mkdtemp(prefix="lut-fleet-")
        self.replicas: List[Replica] = []
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # a worker resolves the device itself (None: its CUDA card)
        self._worker_config = {
            "microbatch": microbatch, "deadline_s": deadline_s,
            "device": None if device is None else str(device),
            "work_stealing": work_stealing,
            "slo_tiers": ([{"name": t.name, "deadline_s": t.deadline_s}
                           for t in slo_tiers] if slo_tiers else None)}
        try:
            if transport == "process":
                self._spawn_workers(n_replicas)
                self._hb_thread = threading.Thread(
                    target=self._heartbeat_loop, daemon=True,
                    name="fleet-heartbeat")
                self._hb_thread.start()
            else:
                for i in range(n_replicas):
                    rid = f"r{i}"
                    store = os.path.join(self.store_root, rid)
                    os.makedirs(store, exist_ok=True)
                    reg = ModelRegistry(
                        microbatch, deadline_s, device=device, mesh=mesh,
                        engine_hook=lambda mid, batch, rid=rid:
                            self._engine_gate(rid),
                        slo_tiers=slo_tiers, work_stealing=work_stealing)
                    self.replicas.append(Replica(
                        replica_id=rid, registry=reg, store_dir=store))
                    self._bump_epoch("join", rid)
        except BaseException:
            # no replica, worker or store outlives a fleet that failed
            # to start (no card, a worker that would not come up)
            self.close()
            raise

    def _spawn_workers(self, n: int) -> None:
        """Spawn + HELLO all workers in parallel (each spawn pays a
        Python/torch cold start and, on a card, a CUDA context; hosts
        would come up concurrently).  Any failure tears down every
        worker that started and raises."""
        results: Dict[str, ProcessReplica] = {}
        errors: Dict[str, str] = {}

        def one(i: int) -> None:
            rid = f"r{i}"
            store = os.path.join(self.store_root, rid)
            os.makedirs(store, exist_ok=True)
            proc = reg = None
            try:
                proc, port = spawn_worker(store)
                reg = RemoteRegistry(
                    proc, port,
                    on_dead=lambda exc, rid=rid: self._conn_lost(rid))
                reg.hello(dict(self._worker_config, epoch=i + 1))
                results[rid] = ProcessReplica(
                    replica_id=rid, registry=reg, store_dir=store,
                    proc=proc, port=port)
            except Exception as e:
                errors[rid] = str(e)
                # a worker that started but failed its HELLO (no card,
                # a bad config) must not outlive the fleet
                if reg is not None:
                    reg.close()
                elif proc is not None:
                    proc.kill()
                    proc.wait(timeout=10.0)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for r in results.values():
                try:
                    r.registry.close()
                except Exception:
                    pass
            raise FleetError(f"worker spawn failed: {errors}")
        for rid in sorted(results, key=lambda s: int(s[1:])):
            self.replicas.append(results[rid])
            self._bump_epoch("join", rid)

    # -- membership ---------------------------------------------------
    def _bump_epoch(self, event: str, replica_id: str) -> int:
        with self._lock:
            self.epoch += 1
            self.membership_events.append(
                {"epoch": self.epoch, "event": event,
                 "replica_id": replica_id, "t": time.monotonic()})
            return self.epoch

    def membership(self) -> Dict[str, Any]:
        """The current membership view: epoch, per-replica up/down, and
        the full join/leave/death event log."""
        with self._lock:
            return {"epoch": self.epoch,
                    "events": list(self.membership_events),
                    "replicas": {r.replica_id:
                                 ("up" if r.healthy else "down")
                                 for r in self.replicas}}

    def _conn_lost(self, replica_id: str) -> None:
        """The replica's connection died (reader thread callback): mark
        it down and bump the epoch.  In-flight handles were already
        failed by the transport — their FleetHandles re-dispatch."""
        try:
            r = self._replica(replica_id)
        except FleetError:
            return
        with self._lock:
            if not r.healthy:
                return
            r.healthy = False
        self._bump_epoch("conn-lost", replica_id)

    def _heartbeat_loop(self) -> None:
        """Liveness prober: PING every process replica each interval;
        ``heartbeat_miss_limit`` consecutive misses declare it dead
        (down + epoch bump — no injected flags).  Ping replies carry
        per-model delay estimates, refreshing the router's cached
        ``estimate_delay_s`` view as a side effect."""
        while not self._hb_stop.wait(self.heartbeat_s):
            for r in self.replicas:
                if not isinstance(r, ProcessReplica):
                    continue
                with self._lock:
                    if not r.healthy:
                        continue
                try:
                    r.registry.ping(timeout=max(1.0, 4 * self.heartbeat_s))
                except Exception:
                    with self._lock:
                        r.missed_beats += 1
                        declared = (r.healthy and r.missed_beats
                                    >= self.heartbeat_miss_limit)
                        if declared:
                            r.healthy = False
                    if declared:
                        self._bump_epoch("heartbeat-dead", r.replica_id)
                else:
                    with self._lock:
                        r.missed_beats = 0

    # -- lifecycle ----------------------------------------------------
    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
        for r in self.replicas:
            try:
                r.registry.close()
            except Exception:
                pass               # a dead worker's close is best-effort
        if self._own_store:
            shutil.rmtree(self.store_root, ignore_errors=True)

    def __enter__(self) -> "LutFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fault injection ----------------------------------------------
    def _replica(self, replica_id: str) -> Replica:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise FleetError(f"no replica {replica_id!r}")

    def _engine_gate(self, replica_id: str) -> None:
        """Runs on the replica's batcher thread before every engine
        dispatch — the point where an injected host death takes effect
        for batches already in flight."""
        if self._replica(replica_id).crashed:
            raise ReplicaCrashed(replica_id)

    def kill_replica(self, replica_id: str) -> None:
        """Host death.  Thread transport: simulated — the replica
        leaves the routing set immediately, every batch it still holds
        FAILS (no graceful drain — the engine gate raises), and its
        registry is torn down.  Process transport: REAL — the worker is
        SIGKILLed and its connection severed, so in-flight requests
        fail exactly as a dead host's would.  Affected requests
        re-dispatch through their FleetHandle; the fleet-level contract
        stays zero-dropped."""
        r = self._replica(replica_id)
        with self._lock:
            r.healthy = False
            r.crashed = True
        self._bump_epoch("killed", replica_id)
        if isinstance(r, ProcessReplica):
            try:
                r.proc.kill()                  # SIGKILL: no cleanup runs
            except OSError:
                pass
            # sever our side too: TCP may not surface the peer death
            # promptly, and in-flight handles must fail NOW to re-route
            r.registry._client.close()
            try:
                r.proc.wait(timeout=10.0)
            except Exception:
                pass
        else:
            r.registry.close()

    def partition_replica(self, replica_id: str) -> None:
        """Fault injection (process transport): sever the root<->worker
        socket WITHOUT touching the worker — a network partition, not a
        host death.  The transport fails in-flight handles (they
        re-dispatch) and the connection-loss callback marks the replica
        down with an epoch bump."""
        r = self._replica(replica_id)
        if not isinstance(r, ProcessReplica):
            raise FleetError(
                "partition_replica needs the process transport")
        r.registry.partition()

    def inject_fetch_corruption(self, replica_id: str, n: int = 1) -> None:
        """The next ``n`` artifact fetches landing on this replica get
        one bit flipped in ``slabs.bin`` after the copy — a transport
        corruption the manifest-hash admission gate must catch."""
        with self._lock:
            self._replica(replica_id).fetch_faults += n

    # -- artifact distribution ----------------------------------------
    def _fetch_verified(self, r: Replica, source: str, acct: _FetchAcct):
        """Ship ``source`` to the replica's local store and admit it
        only after the copy re-verifies against its manifest hashes —
        thread transport: local copy + re-hash here; process transport:
        streaming slab transfer, re-hashed BY THE WORKER on receipt.
        Corrupt copies are deleted and re-fetched up to the retry
        budget.  All counter updates (the replica's fleet-lifetime
        totals AND ``acct``, this rollout's own tally) happen under the
        router lock — concurrent rollouts never read each other's
        increments.  Returns the admitted artifact (loaded+packed for
        thread replicas, a ``RemoteArtifact`` token for process
        replicas)."""
        last: Optional[ArtifactError] = None
        for _ in range(1 + self.max_fetch_retries):
            with self._lock:
                r.fetches += 1
                acct.fetches += 1
                corrupt = r.fetch_faults > 0
                if corrupt:
                    r.fetch_faults -= 1
            if isinstance(r, ProcessReplica):
                try:
                    return r.registry.fetch(source, corrupt=corrupt)
                except ArtifactError as e:
                    last = e
                    with self._lock:
                        r.verify_failures += 1
                        acct.verify_failures += 1
                    continue
            dst = copy_artifact(source, r.store_dir)
            if corrupt:
                _flip_one_bit(os.path.join(dst, SLAB_FILE))
            try:
                verify_artifact(dst)
            except ArtifactError as e:
                last = e
                with self._lock:
                    r.verify_failures += 1
                    acct.verify_failures += 1
                # never leave a copy that could be admitted by a later
                # (non-verifying) reader
                shutil.rmtree(dst, ignore_errors=True)
                continue
            # hashes checked above — load without re-hashing, packed so
            # the replica keeps the halved int4 table residency, onto
            # the device the replica serves on
            return load_artifact(dst, verify=False, unpack_int4=False,
                                 device=r.registry.device)
        raise ArtifactError(
            f"{r.replica_id}: artifact from {source!r} failed hash "
            f"verification {1 + self.max_fetch_retries} times — replica "
            f"not admitted") from last

    def distribute_artifact(self, source: str, model_id: str) \
            -> Dict[str, ReplicaDistribution]:
        """Roll an artifact out to every healthy replica: fetch, verify,
        register (or hot-swap, when the replica already serves
        ``model_id``), admit.  Replicas fetch + warm in parallel — the
        engine warm-up is the long pole and hosts would do it
        concurrently.  Raises only when NO replica admitted; partial
        admission is reported per replica and the router simply excludes
        the failures."""
        report: Dict[str, ReplicaDistribution] = {}

        def one(r: Replica) -> None:
            acct = _FetchAcct()
            try:
                art = self._fetch_verified(r, source, acct)
                if model_id in r.registry.model_ids():
                    r.registry.swap(model_id, art)
                else:
                    r.registry.register(model_id, art)
            # broad on purpose: ANY failure (incl. UnknownModelError —
            # a KeyError — from a racing kill) must land in the report
            # as a non-admitted replica, never kill the worker thread
            # and vanish from the rollout accounting
            except Exception as e:
                report[r.replica_id] = ReplicaDistribution(
                    r.replica_id, False, None, acct.fetches,
                    acct.verify_failures, error=str(e))
                return
            with self._lock:
                r.admitted[model_id] = art.artifact_id
            report[r.replica_id] = ReplicaDistribution(
                r.replica_id, True, art.artifact_id, acct.fetches,
                acct.verify_failures)

        targets = [r for r in self.replicas if r.healthy]
        if not targets:
            raise NoHealthyReplica("fleet has no healthy replica")
        threads = [threading.Thread(target=one, args=(r,)) for r in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if not any(d.admitted for d in report.values()):
            raise FleetError(
                f"artifact rollout of {model_id!r} admitted on no "
                f"replica: { {k: d.error for k, d in report.items()} }")
        return report

    # -- two-phase coordinated swap -----------------------------------
    def prepare_swap(self, model_id: str, source: str) -> PreparedFleetSwap:
        """Phase 1: distribute + verify the new artifact and warm a
        replacement engine OFF-PATH on every serving replica.  All-or-
        nothing: one failed replica aborts the fleet cutover (prepared
        engines stand down) and every replica keeps serving the old
        version."""
        targets = [r for r in self.replicas
                   if r.healthy and model_id in r.admitted]
        if not targets:
            raise NoHealthyReplica(
                f"no healthy replica serves {model_id!r}")
        t0 = time.monotonic()
        entries: Dict[str, Tuple[Replica, ModelEntry]] = {}
        dist: Dict[str, ReplicaDistribution] = {}
        errors: Dict[str, str] = {}

        def one(r: Replica) -> None:
            acct = _FetchAcct()
            try:
                art = self._fetch_verified(r, source, acct)
                entries[r.replica_id] = (
                    r, r.registry.prepare(model_id, art))
                dist[r.replica_id] = ReplicaDistribution(
                    r.replica_id, True, art.artifact_id,
                    acct.fetches, acct.verify_failures)
            # broad on purpose: a failure that escaped the worker (e.g.
            # UnknownModelError, a KeyError, from a kill racing this
            # prepare) would skip the all-or-nothing abort check below
            except Exception as e:
                errors[r.replica_id] = str(e)
                dist[r.replica_id] = ReplicaDistribution(
                    r.replica_id, False, None, acct.fetches,
                    acct.verify_failures, error=str(e))

        threads = [threading.Thread(target=one, args=(r,)) for r in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors or not entries:
            for r, entry in entries.values():
                r.registry.abandon(entry)
            raise FleetSwapError(
                f"prepare_swap({model_id!r}) failed on "
                f"{sorted(errors)} ({errors}); commit never attempted — "
                f"all replicas still serve the old version")
        new_tag = next(iter(entries.values()))[1].version_tag
        prepared = PreparedFleetSwap(model_id=model_id, new_tag=new_tag,
                                     entries=entries, distribution=dist)
        prepared.prepare_s = time.monotonic() - t0
        return prepared

    def commit_swap(self, prepared: PreparedFleetSwap) -> FleetSwapReport:
        """Phase 2: cut every prepared replica over.  Each registry
        commit is one dict assignment under that replica's routing lock
        (microseconds), so the whole fleet converges within one tight
        loop; in-flight requests finish on whichever engine holds them
        and every response is tagged with the version that served it."""
        old_tags: Dict[str, str] = {}
        blackout: Dict[str, float] = {}
        drained: Dict[str, int] = {}
        t0 = time.monotonic()
        not_cut: Dict[str, str] = {}
        for rid, (r, entry) in sorted(prepared.entries.items()):
            if not r.healthy:
                # the host died between prepare and commit: its engine
                # stands down, the survivors still cut over
                r.registry.abandon(entry)
                not_cut[rid] = "replica unhealthy at commit"
                continue
            with self._lock:
                old_tags[rid] = r.admitted.get(prepared.model_id, "")
            try:
                rep: SwapReport = r.registry.commit(prepared.model_id,
                                                    entry)
            # broad on purpose: a kill can race the healthy check above
            # (registry closed -> UnknownModelError, a KeyError) and
            # the exception must not escape mid-loop — that would leave
            # the fleet half-old/half-new with no report and the
            # remaining prepared entries never abandoned.  The failed
            # replica is recorded as not-cut; the survivors still cut.
            except Exception as e:
                old_tags.pop(rid, None)
                not_cut[rid] = str(e)
                try:
                    # commit's own failure paths stop the entry batcher
                    # already; abandon is idempotent and covers the rest
                    r.registry.abandon(entry)
                except Exception:
                    pass
                continue
            with self._lock:
                r.admitted[prepared.model_id] = entry.version_tag
            blackout[rid] = rep.blackout_s
            drained[rid] = rep.drained_requests
        window = time.monotonic() - t0
        return FleetSwapReport(
            model_id=prepared.model_id, old_tags=old_tags,
            new_tag=prepared.new_tag, commit_window_s=window,
            blackout_s=blackout, drained_requests=drained,
            prepare_s=prepared.prepare_s, not_cut=not_cut)

    def swap_fleet(self, model_id: str, source: str) -> FleetSwapReport:
        """prepare + commit in one call (the CLI demo entry)."""
        return self.commit_swap(self.prepare_swap(model_id, source))

    # -- request path -------------------------------------------------
    def _pick(self, model_id: str, exclude=(),
              tier: Optional[SLOTier] = None) -> Optional[Replica]:
        with self._lock:
            cands = [r for r in self.replicas
                     if r.healthy and model_id in r.admitted
                     and r.replica_id not in exclude]
            if not cands:
                return None
            if tier is not None and tier.has_deadline:
                # deadline-class requests rank by ESTIMATED DELAY (live
                # queue depth x kernel estimate) first — outstanding
                # count alone can't see a deep scoreboard behind a
                # small in-flight window
                return min(cands, key=lambda r: (
                    r.registry.estimate_delay_s(model_id) or 0.0,
                    r.outstanding, r.replica_id))
            return min(cands, key=lambda r: (r.outstanding, r.replica_id))

    def _dispatch(self, h: FleetHandle) -> None:
        """Place (or re-place) a request on the best replica.  Prefers
        replicas this request has not failed on; a submit that races a
        replica death is absorbed and re-routed, mirroring the
        registry's own BatcherStopped re-route one level down."""
        t0 = time.perf_counter()
        tried = set(h.replica_ids)
        attempts = 0
        shed: Optional[DeadlineUnmeetable] = None
        while True:
            r = self._pick(h.model_id, exclude=tried, tier=h.tier)
            if r is None:
                # every untried replica is out — fall back to ANY
                # healthy one (a transient engine fault is retryable on
                # the same host) before giving up
                tried = set()
                r = self._pick(h.model_id, tier=h.tier)
            attempts += 1
            if r is None or attempts > 2 * len(self.replicas):
                h.route_s += time.perf_counter() - t0
                if shed is not None:
                    # every candidate's admission control proved the
                    # deadline unmeetable — surface the TYPED shed, not
                    # a routing failure
                    with self._lock:
                        self.sheds += 1
                    raise shed
                raise NoHealthyReplica(
                    f"no healthy replica can serve {h.model_id!r} "
                    f"(request re-dispatched {h.retries} times)")

            def done_cb(_h, r=r):
                with self._lock:
                    r.outstanding -= 1
                    r.served += 1

            with self._lock:
                r.outstanding += 1
            try:
                inner = r.registry.submit(h.model_id, h.x,
                                          on_done=done_cb, tier=h.tier)
            except UnknownModelError:
                # raced a kill/unregister: un-count, exclude, move on
                with self._lock:
                    r.outstanding -= 1
                tried.add(r.replica_id)
                continue
            except DeadlineUnmeetable as e:
                # this replica shed the request — try the others, raise
                # the shed only when every candidate refuses
                with self._lock:
                    r.outstanding -= 1
                shed = e
                tried.add(r.replica_id)
                continue
            h._inner = inner
            h.replica_ids.append(r.replica_id)
            h.route_s += time.perf_counter() - t0
            return

    def _shed_check(self, model_id: str, tier: Optional[SLOTier]) -> None:
        """Pre-dispatch admission: when even the BEST candidate
        replica's delay estimate provably misses the tier deadline,
        shed here — a rejection costs a few dict lookups, never a queue
        traversal or a dispatch attempt."""
        if tier is None or not tier.has_deadline:
            return
        with self._lock:
            cands = [r for r in self.replicas
                     if r.healthy and model_id in r.admitted]
        ests = [r.registry.estimate_delay_s(model_id) for r in cands]
        known = [e for e in ests if e is not None]
        # no history yet (or no candidates — dispatch will raise the
        # routing error, not a shed): always admit
        if not cands or len(known) < len(ests) or not known:
            return
        best = min(known)
        if best > tier.deadline_s:
            with self._lock:
                self.sheds += 1
            raise DeadlineUnmeetable(
                f"deadline {tier.deadline_s * 1e3:.2f} ms but the best "
                f"replica's estimated service is {best * 1e3:.2f} ms — "
                f"request shed before dispatch")

    def submit(self, model_id: str, x,
               tier: Optional[SLOTier] = None) -> FleetHandle:
        """Route one request to the least-loaded healthy replica that
        has admitted ``model_id``.  The returned handle re-dispatches
        itself on replica failure — ``result()`` returns the one true
        response or raises ``NoHealthyReplica``.  A deadline-class
        ``tier`` request that provably cannot meet its deadline is
        shed with the typed ``DeadlineUnmeetable`` before dispatch."""
        self._shed_check(model_id, tier)
        h = FleetHandle(self, model_id, x, tier=tier)
        self._dispatch(h)
        return h

    def client(self, model_id: str) -> "FleetClient":
        """Single-model view duck-typing ``MicroBatcher.submit`` so the
        open-loop Poisson load generator (batching.replay_open_loop)
        runs against a fleet unchanged."""
        return FleetClient(self, model_id)

    # -- introspection ------------------------------------------------
    def healthy_replicas(self) -> List[str]:
        with self._lock:
            return [r.replica_id for r in self.replicas if r.healthy]

    def admitted_tags(self, model_id: str) -> Dict[str, str]:
        """replica id -> artifact/version tag currently admitted (the
        post-commit consistency check: all equal)."""
        with self._lock:
            return {r.replica_id: r.admitted[model_id]
                    for r in self.replicas
                    if r.healthy and model_id in r.admitted}

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {r.replica_id: {
                "healthy": r.healthy,
                "outstanding": r.outstanding,
                "served": r.served,
                "fetches": r.fetches,
                "verify_failures": r.verify_failures,
                "admitted": dict(r.admitted),
            } for r in self.replicas}

    def launch_counts(self, reset: bool = False) -> Dict[str, Dict[str, int]]:
        """Kernel launch counts of each healthy replica, ``{replica id:
        {kernel: launches}}``, zeroed after reading when ``reset``.  A
        process replica's come from its worker, over the wire (a PING);
        thread replicas share the root process's counts, so each shows
        the same dict."""
        from repro_torch.kernels.lut_gather import lut_gather as LG

        out: Dict[str, Dict[str, int]] = {}
        for rid in self.healthy_replicas():
            r = self._replica(rid)
            if isinstance(r, ProcessReplica):
                out[rid] = dict(r.registry.ping(
                    timeout=max(5.0, 4 * self.heartbeat_s),
                    reset_launches=reset)["launches"])
            else:
                out[rid] = LG.launch_counts()
        if reset and self.transport == "thread":
            LG.reset_launch_counts()
        return out


@dataclasses.dataclass
class FleetClient:
    fleet: LutFleet
    model_id: str

    def submit(self, x, tier: Optional[SLOTier] = None) -> FleetHandle:
        return self.fleet.submit(self.model_id, x, tier=tier)


def _flip_one_bit(path: str) -> None:
    """Deterministic transport-corruption injector: flip one bit in the
    middle of ``path`` (used by inject_fetch_corruption and the fault
    harness)."""
    size = os.path.getsize(path)
    off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x01]))
