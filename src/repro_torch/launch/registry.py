"""Multi-model LUT serving registry with zero-retrain hot-swap (port of
``repro.launch.registry``).

One process, many networks: each registered model id owns its own
engine (``kernels.lut_gather.ops.make_network_fn`` over a synthesised
table set, usually loaded from a ``repro_torch.artifact`` directory)
and its own threaded deadline-flush ``MicroBatcher``.
``submit(model_id, x)`` routes a request to the right queue; every
model serves concurrently on its own batcher thread.  The engine turns
each numpy microbatch into a tensor on the registry's device, runs the
network, and copies the result back to the host before returning.

Hot-swap contract (``swap`` = ``prepare`` + ``commit``): the NEW
artifact is loaded, its kernels built and launched on a warm-up
microbatch entirely OUTSIDE the routing lock (``prepare``); the swap
itself is one dict assignment under the lock (``commit`` — the
measured "blackout").  The old engine's batcher is then stopped: its
queued and in-flight requests finish on the OLD tables, and a producer
that races the drain gets the typed ``BatcherStopped`` rejection which
``submit`` absorbs by re-routing to the entry that replaced it — so a
swap under load completes with ZERO dropped or failed requests.

Accepted model sources, anywhere a model id is (re)bound:
  * an artifact directory path (str),
  * a loaded ``Artifact``,
  * a raw ``List[LayerTables]``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.batching import (BatcherStopped, MicroBatcher,
                                         RequestHandle)
from repro_torch.launch.scheduler import (ScoreboardScheduler, SLOTier,
                                          StealGroup)


@dataclasses.dataclass
class ModelEntry:
    """One registered model: its tables, engine, and request queue."""

    model_id: str
    version: int
    tables: List
    n_features: int
    artifact_id: Optional[str]
    serve_fn: Callable
    batcher: MicroBatcher
    warm_s: float
    # the engine's SegmentPlan (fused / segmented / per-layer), as
    # make_network_fn chose it
    plan: Optional[Any] = None

    @property
    def version_tag(self) -> str:
        """The tag echoed on every response this entry serves: the
        content-addressed artifact id when the model came from an
        artifact (fleet replicas compare THESE across hosts), else a
        registry-local synthetic tag."""
        return (self.artifact_id if self.artifact_id is not None
                else f"{self.model_id}#v{self.version}")


@dataclasses.dataclass
class SwapReport:
    """What a hot-swap cost: ``warm_s`` is off-path (old engine kept
    serving throughout), ``blackout_s`` is the routing-lock hold — the
    only interval during which a submit can neither reach the old nor
    the new engine."""

    model_id: str
    old_version: int
    new_version: int
    old_artifact_id: Optional[str]
    new_artifact_id: Optional[str]
    warm_s: float
    blackout_s: float
    drained_requests: int


class UnknownModelError(KeyError):
    """Request routed to a model id the registry does not hold."""


class ModelRegistry:
    """Routes requests to per-model microbatched engines; swaps any
    model's tables live without dropping requests."""

    def __init__(self, microbatch: int = 256, deadline_s: float = 2e-3,
                 *, device: DeviceLike = None, mesh=None,
                 engine_hook: Optional[Callable] = None,
                 slo_tiers: Optional[List[SLOTier]] = None,
                 work_stealing: bool = False):
        self.microbatch = microbatch
        self.deadline_s = deadline_s
        # every engine runs here: the CUDA card unless one is named; with
        # a mesh (parallel.sharding.Mesh) each microbatch is split over
        # its entries and the answers land on its first entry's device
        self.mesh = mesh
        if mesh is not None:
            first = mesh.device_list[0]
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"first entry {first}")
            device = first
        self.device = resolve_device(device)
        # SLO-tiered scheduling: when tiers are declared (or stealing
        # is on) every model's batcher gets a ScoreboardScheduler —
        # priority issue order + admission control — and, with
        # work_stealing, all batchers join one StealGroup so a hot
        # model borrows flush capacity from an idle sibling
        self.slo_tiers = list(slo_tiers) if slo_tiers else None
        self.work_stealing = work_stealing
        self.steal_group = StealGroup() if work_stealing else None
        # fault-injection surface: called as engine_hook(model_id,
        # batch) on the batcher thread BEFORE every engine dispatch; an
        # exception it raises fails that batch exactly like an engine
        # crash (handles complete failed, batcher survives).  The fleet
        # harness uses this to kill a "host" with requests in flight.
        self.engine_hook = engine_hook
        self._models: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- assembly -----------------------------------------------------
    def _resolve(self, source) -> tuple:
        """source -> (tables, n_features, artifact_id)."""
        if isinstance(source, str):
            from repro_torch.artifact import load_artifact
            # packed load: int4 slabs feed the kernels as they are
            source = load_artifact(source, unpack_int4=False,
                                   device=self.device)
        if hasattr(source, "tables"):            # a loaded Artifact
            return source.tables, source.n_in, source.artifact_id
        from repro_torch.artifact.store import _infer_n_in
        tables = list(source)
        return tables, _infer_n_in(tables), None

    def _build_entry(self, model_id: str, source,
                     version: int) -> ModelEntry:
        from repro_torch.kernels.lut_gather import ops as lg_ops

        tables, n_feat, artifact_id = self._resolve(source)
        device = self.device
        # the engine plans its own rows per block from the shared-memory
        # ledger; the microbatch size only sets the batch it is handed
        serve_fn = lg_ops.make_network_fn(tables, n_in0=n_feat,
                                          device=device, mesh=self.mesh)
        t0 = time.monotonic()
        # warm-up: builds the kernels on first use and launches them
        serve_fn(torch.zeros((self.microbatch, n_feat), dtype=torch.int32,
                             device=device)).cpu()
        warm_s = time.monotonic() - t0

        def engine(batch_np):
            if self.engine_hook is not None:
                self.engine_hook(model_id, batch_np)
            x = torch.from_numpy(np.ascontiguousarray(batch_np, np.int32))
            return serve_fn(x.to(device)).cpu().numpy()

        scheduler = (ScoreboardScheduler()
                     if (self.slo_tiers is not None or self.work_stealing)
                     else None)
        batcher = MicroBatcher(engine, self.microbatch, self.deadline_s,
                               n_features=n_feat, scheduler=scheduler,
                               steal_group=self.steal_group).start()
        entry = ModelEntry(model_id=model_id, version=version,
                           tables=tables, n_features=n_feat,
                           artifact_id=artifact_id, serve_fn=serve_fn,
                           batcher=batcher, warm_s=warm_s,
                           plan=getattr(serve_fn, "execution_plan", None))
        batcher.tag = entry.version_tag
        return entry

    # -- lifecycle ----------------------------------------------------
    def register(self, model_id: str, source) -> ModelEntry:
        """Bind ``model_id`` to a model source (warms the engine and
        starts its batcher before the id becomes routable)."""
        entry = self._build_entry(model_id, source, version=1)
        with self._lock:
            if self._closed:
                entry.batcher.stop()
                raise RuntimeError("registry is closed")
            if model_id in self._models:
                entry.batcher.stop()
                raise ValueError(
                    f"model id {model_id!r} already registered — "
                    f"use swap() to replace it live")
            self._models[model_id] = entry
        return entry

    def prepare(self, model_id: str, source) -> ModelEntry:
        """Phase 1 of a swap: build + warm the replacement engine
        entirely OFF-PATH (the old engine keeps serving; nothing is
        routable to the new one yet).  Returns the prepared entry for a
        later ``commit`` — or ``abandon`` if the swap is called off.
        The fleet coordinator runs this phase on EVERY replica before
        committing any, so a replica that fails to prepare aborts the
        whole fleet cutover while all hosts still serve the old
        version."""
        with self._lock:
            if model_id not in self._models:
                raise UnknownModelError(model_id)
            version = self._models[model_id].version + 1
        return self._build_entry(model_id, source, version=version)

    def abandon(self, entry: ModelEntry) -> None:
        """Stand down a prepared-but-uncommitted entry (stops its
        never-routed batcher and joins the thread)."""
        entry.batcher.stop()

    def commit(self, model_id: str, entry: ModelEntry) -> SwapReport:
        """Phase 2 of a swap: atomically cut ``model_id`` over to the
        prepared ``entry`` (one dict assignment under the routing lock
        — the measured blackout), then drain the old engine.  In-flight
        and racing requests finish on the old engine or re-route to the
        new one; none are dropped."""
        t0 = time.monotonic()
        with self._lock:
            # the id can vanish during the (long) warm-up — a racing
            # unregister()/close() wins and the new engine stands down;
            # a width-mismatched replacement is refused up front, since
            # re-routed in-flight rows would fail inside its batcher
            # and break the zero-failed-requests swap contract
            old = self._models.get(model_id)
            if old is not None and old.n_features == entry.n_features:
                entry.version = old.version + 1
                # re-stamp BEFORE the entry becomes routable: the
                # version may have moved during the warm-up and the tag
                # must name the version actually served
                entry.batcher.tag = entry.version_tag
                self._models[model_id] = entry
        if old is None:
            entry.batcher.stop()
            raise UnknownModelError(
                f"model {model_id!r} was removed while the replacement "
                f"engine warmed — swap abandoned")
        if old.n_features != entry.n_features:
            entry.batcher.stop()
            raise ValueError(
                f"swap({model_id!r}): replacement takes "
                f"{entry.n_features} features, serving entry takes "
                f"{old.n_features} — in-flight requests could not be "
                f"re-routed; register it under a new model id instead")
        blackout_s = time.monotonic() - t0
        flushed_before = sum(f.fill for f in old.batcher.flushes)
        old.batcher.stop()                 # serves every queued request
        drained = sum(f.fill for f in old.batcher.flushes) - flushed_before
        return SwapReport(
            model_id=model_id, old_version=old.version,
            new_version=entry.version, old_artifact_id=old.artifact_id,
            new_artifact_id=entry.artifact_id, warm_s=entry.warm_s,
            blackout_s=blackout_s, drained_requests=drained)

    def swap(self, model_id: str, source) -> SwapReport:
        """Atomically rebind ``model_id`` to a new model: ``prepare``
        (warm off-path) immediately followed by ``commit``.  In-flight
        and racing requests finish on the old engine's drain or are
        re-routed — none are dropped."""
        return self.commit(model_id, self.prepare(model_id, source))

    def unregister(self, model_id: str) -> None:
        with self._lock:
            entry = self._models.pop(model_id, None)
        if entry is None:
            raise UnknownModelError(model_id)
        entry.batcher.stop()

    def close(self) -> None:
        """Stop every batcher (each drains its queue first)."""
        with self._lock:
            self._closed = True
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e.batcher.stop()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request path -------------------------------------------------
    def submit(self, model_id: str, x,
               on_done: Optional[Callable] = None,
               tier: Optional[SLOTier] = None) -> RequestHandle:
        """Route one request.  A concurrent hot-swap can stop the entry
        we picked between lookup and enqueue; the typed rejection is
        absorbed by re-looking-up the (new) entry — bounded, since each
        retry observes a strictly newer version.  ``on_done`` rides the
        handle (see MicroBatcher.submit).  ``tier`` stamps the SLO
        class; a deadline-class request the scheduler can prove unmeet-
        able is shed with ``DeadlineUnmeetable`` (which propagates —
        admission rejection is an answer, not a routing failure)."""
        while True:
            with self._lock:
                entry = self._models.get(model_id)
                known = sorted(self._models) if entry is None else None
            if entry is None:
                raise UnknownModelError(
                    f"no model {model_id!r} registered (have: {known})")
            try:
                return entry.batcher.submit(x, on_done=on_done, tier=tier)
            except BatcherStopped:
                continue

    def client(self, model_id: str) -> "RegistryClient":
        """A single-model view that duck-types ``MicroBatcher.submit``
        so per-model load generators (batching.replay_open_loop) work
        unchanged against the registry."""
        return RegistryClient(self, model_id)

    # -- introspection ------------------------------------------------
    def model_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def get(self, model_id: str) -> ModelEntry:
        with self._lock:
            if model_id not in self._models:
                raise UnknownModelError(model_id)
            return self._models[model_id]

    def capacity(self, model_id: str) -> Dict[str, Any]:
        """Live capacity accounting for one model: current queue depth,
        the kernel-time estimate from flush history, the delay a new
        request would see, and the sustainable request rate — what the
        fleet router and admission control consult.  Estimates are None
        until the model's first flush lands."""
        entry = self.get(model_id)
        sched = entry.batcher.scheduler
        if sched is None:
            return {"queue_depth": entry.batcher._q.qsize(),
                    "kernel_est_s": None, "est_delay_s": None,
                    "sustainable_req_s": None, "sheds": 0}
        kest = sched.kernel_estimate_s()
        return {
            "queue_depth": sched.scoreboard.depth(),
            "kernel_est_s": kest,
            "est_delay_s": sched.estimate_delay_s(),
            "sustainable_req_s": (entry.batcher.microbatch / kest
                                  if kest else None),
            "sheds": sched.sheds,
        }

    def estimate_delay_s(self, model_id: str,
                         deadline_at: Optional[float] = None
                         ) -> Optional[float]:
        """Estimated service delay for a new request on ``model_id``
        (None when unscheduled or before any flush history exists) —
        the fleet's pre-dispatch shed check and tier-aware routing key
        on this."""
        try:
            entry = self.get(model_id)
        except UnknownModelError:
            return None
        sched = entry.batcher.scheduler
        return (None if sched is None
                else sched.estimate_delay_s(deadline_at))

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            entries = dict(self._models)
        out = {}
        for mid, e in entries.items():
            sched = e.batcher.scheduler
            out[mid] = {
                "version": e.version,
                "artifact_id": e.artifact_id,
                "n_features": e.n_features,
                "flushes": len(e.batcher.flushes),
                "served": sum(f.fill for f in e.batcher.flushes
                              if not f.failed),
                "failed_flushes": sum(1 for f in e.batcher.flushes
                                      if f.failed),
                "warm_s": round(e.warm_s, 4),
                "exec_mode": (e.plan.mode if e.plan is not None
                              else None),
                "exec_segments": (e.plan.n_segments
                                  if e.plan is not None else None),
                "sheds": 0 if sched is None else sched.sheds,
            }
            if self.steal_group is not None:
                out[mid]["steals"] = self.steal_group.steals
        return out


@dataclasses.dataclass
class RegistryClient:
    registry: ModelRegistry
    model_id: str

    def submit(self, x, on_done=None, tier=None) -> RequestHandle:
        return self.registry.submit(self.model_id, x, on_done=on_done,
                                    tier=tier)
