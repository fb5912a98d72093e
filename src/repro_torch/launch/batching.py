"""Async request queue with deadline-based microbatch flush.

The real serving front-end for the LUT engine (and any fixed-shape
batch function): producers ``submit`` single requests from any thread
and block on the returned handle; ONE batcher thread drains the queue
and flushes a microbatch to the engine when EITHER

  * the batch is full (``microbatch`` requests)   — no deadline wait, or
  * the OLDEST pending request has waited ``deadline_s``

so a lone straggler completes within ``deadline + one kernel time``
and a full microbatch never waits for the deadline.  Arrivals,
queueing and flushes all happen on the real clock with real threads.

The flush pads the tail batch to the fixed ``(microbatch, n_features)``
shape (repeating the first row) so the jitted engine never retraces;
padding rows are computed and discarded.

``replay_open_loop`` drives a batcher with a Poisson arrival process on
the real clock — the measurement harness used by examples/lut_serve.py
and benchmarks/lut_infer_bench.py.

While any batcher of the process serves, two settings of the whole
interpreter change; both go back when the last batcher stops.  The
first batcher to start frees the garbage on the heap (``gc.collect``)
and freezes what is left (``gc.freeze``): the collector's full pass
walks every object it tracks with the GIL held, so it stops the batcher
and every submitter until it ends, 233-237 ms on an H100's host over
the ~284k objects of a process that had timed and served the LUT
kernels (~650k once it has also trained a model).  Frozen, that heap is
not walked; a full pass during serving walks only what was allocated
since.  An object frozen there that becomes cyclic garbage while the
process serves waits for the last batcher to stop, so the serving
classes keep no cycles of their own (a scheduler holds its batcher
weakly, a stopped batcher leaves its steal group): a swapped-out
engine is freed by its reference count.  And the interpreter hands the
GIL to a waiting thread after ``SERVING_SWITCH_S`` instead of its
default 5 ms: a flush gives the GIL up at each copy and launch, and
beside a thread that runs Python (a swap loading and planning its
engine) each give-up cost up to the whole interval, 9.5-21.4 ms a
flush during swaps on that host.
"""
from __future__ import annotations

import dataclasses
import gc
import queue
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.launch.scheduler import DeadlineUnmeetable


@dataclasses.dataclass
class RequestHandle:
    """One in-flight request.  ``result()`` blocks until the batcher
    has flushed the microbatch containing it (re-raising the engine's
    exception if that flush failed).

    ``tag`` echoes the serving batcher's version tag (set at FLUSH
    time, so a request that races a hot-swap reports the engine that
    ACTUALLY served it) and ``flush_key`` identifies the exact
    microbatch it rode in — together they let the fleet consistency
    harness prove no batch ever mixes artifact versions.  ``on_done``
    (set at submit) fires once on the batcher thread when the handle
    completes, success or failure — the router's outstanding-count
    bookkeeping hook."""

    x: np.ndarray                       # (n_features,) input row
    t_submit: float                     # monotonic submit time
    t_done: float = 0.0                 # monotonic completion time
    tag: Optional[str] = None           # serving engine's version tag
    flush_key: Optional[tuple] = None   # (batcher id, flush seq)
    on_done: Optional[Callable] = None  # called with the handle, once
    tier: Optional[Any] = None          # scheduler.SLOTier, if tiered
    deadline_at: Optional[float] = None  # monotonic hard deadline
    _out: Optional[np.ndarray] = None   # (n_out,) engine output row
    _exc: Optional[BaseException] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._exc is not None:
            raise RuntimeError("engine failed for this batch") from self._exc
        return self._out

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def failed(self) -> bool:
        """True when the engine raised for this request's batch (the
        public accessor — callers count failures without touching
        ``_exc``)."""
        return self._exc is not None

    @property
    def latency_s(self) -> float:
        """Queueing delay + kernel time (valid once done)."""
        return self.t_done - self.t_submit


@dataclasses.dataclass
class FlushRecord:
    """Telemetry for one flush (for tail-latency attribution)."""

    fill: int           # real requests in the microbatch (<= capacity)
    waited_s: float     # oldest request's queueing delay at flush time
    kernel_s: float     # engine wall time (time-to-fault when failed)
    cause: str          # "full" | "deadline" | "stop" | "steal"
    tag: Optional[str] = None   # batcher's version tag at flush time
    failed: bool = False        # engine raised: the flush served nothing

    @property
    def deadline_hit(self) -> bool:
        return self.cause == "deadline"


_STOP = object()


SERVING_SWITCH_S = 5e-4     # the GIL's switch interval while serving
_serving_lock = threading.Lock()
_serving = 0                 # batchers started and not yet stopped
_switch_before = 0.0         # the interval the first batcher found


def _serving_started() -> None:
    """A batcher starts.  The first of the process frees the garbage on
    the heap, freezes the rest (``gc.freeze`` is O(1): the collector's
    lists are moved whole) and shortens the GIL's switch interval (never
    lengthens it); a later one, whose engine was built beside a serving
    batcher, changes nothing."""
    global _serving, _switch_before
    with _serving_lock:
        if _serving == 0:
            gc.collect()
            gc.freeze()
            _switch_before = sys.getswitchinterval()
            if _switch_before > SERVING_SWITCH_S:
                sys.setswitchinterval(SERVING_SWITCH_S)
        _serving += 1


def _serving_stopped() -> None:
    """A batcher stopped: the last one hands the frozen objects back to
    the collector and restores the switch interval."""
    global _serving
    with _serving_lock:
        _serving -= 1
        if _serving == 0:
            gc.unfreeze()
            if _switch_before > SERVING_SWITCH_S:
                sys.setswitchinterval(_switch_before)


class BatcherStopped(RuntimeError):
    """A request was submitted after drain began.  Subclasses
    RuntimeError so pre-existing callers keep working; the multi-model
    registry (launch/registry.py) catches THIS to retry a request on
    the engine that replaced a hot-swapped one."""


class MicroBatcher:
    """Threaded microbatcher with deadline flush.

    serve_fn: ``(microbatch, n_features) np/int32 -> (microbatch, n_out)``
    array-convertible; called on the batcher thread only, so a jitted
    (optionally shard_map'ed) engine fn needs no extra locking.  (With
    a steal group a SIBLING batcher's thread may also call it, into a
    private buffer — jitted fns are safe to call concurrently.)

    ``scheduler`` (a ``scheduler.ScoreboardScheduler``) switches the
    fill from FIFO to scoreboard issue order (earliest-deadline-first
    with best-effort backfill) and gates every submit through its
    admission control; ``steal_group`` lets this batcher execute a
    backlogged sibling's flushes while its own scoreboard is empty.

    From ``start`` to ``stop`` a batcher counts as serving, which sets
    the process's collector and GIL switch interval as the module's
    docstring says, for every thread of the process, until the last
    batcher stops.
    """

    def __init__(self, serve_fn: Callable, microbatch: int,
                 deadline_s: float, n_features: int,
                 dtype=np.int32, tag: Optional[str] = None,
                 scheduler=None, steal_group=None,
                 steal_poll_s: float = 2e-3):
        if microbatch < 1:
            raise ValueError("microbatch must be >= 1")
        self.serve_fn = serve_fn
        self.microbatch = microbatch
        self.deadline_s = float(deadline_s)
        # version tag echoed on every handle this batcher completes —
        # the registry stamps it with the serving artifact id so a
        # response always says WHICH engine version produced it
        self.tag = tag
        self._flush_seq = 0
        self._inflight = 0       # flushes currently executing
        # a stealing sibling flushes concurrently with this thread, so
        # the flush-key counter needs its own (tiny) lock
        self._seq_lock = threading.Lock()
        self._buf = np.zeros((microbatch, n_features), dtype)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._frozen_heap = False    # counted in _serving until stop()
        self._stopping = False
        # serializes submit()'s stopping-check-then-enqueue against
        # stop() raising the flag: a request either lands in the queue
        # BEFORE the flag flips (and is served by the loop or the final
        # drain) or sees the flag and gets BatcherStopped — it can
        # never slip into the queue after the drain and silently hang
        self._submit_lock = threading.Lock()
        self.flushes: List[FlushRecord] = []
        self.scheduler = scheduler
        self.steal_group = steal_group
        self._steal_poll_s = float(steal_poll_s)
        # scheduled mode bypasses the queue: submits land straight in
        # the scoreboard and wake the batcher through this condition
        self._cond = threading.Condition()
        if scheduler is not None:
            scheduler.bind(self)
        if steal_group is not None:
            steal_group.register(self)

    # -- lifecycle ---------------------------------------------------
    def start(self) -> "MicroBatcher":
        _serving_started()
        self._frozen_heap = True
        self._thread.start()
        return self

    def stop(self) -> None:
        """Flush whatever is pending, then join the batcher thread.
        Requests that raced past submit()'s stopping check are drained
        and served HERE (on the caller's thread) so no handle is ever
        left unset."""
        with self._submit_lock:
            self._stopping = True
        with self._cond:
            self._cond.notify_all()
        self._q.put(_STOP)
        self._thread.join()
        if self._frozen_heap:
            self._frozen_heap = False
            _serving_stopped()
        if self.steal_group is not None:
            self.steal_group.unregister(self)
        leftovers: List[RequestHandle] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        # scheduled mode: the scoreboard is the queue — drain any
        # remainder the loop's final issue raced past
        if self.scheduler is not None:
            while True:
                chunk = self.scheduler.scoreboard.issue(self.microbatch)
                if not chunk:
                    break
                leftovers.extend(chunk)
        while leftovers:
            chunk = leftovers[:self.microbatch]
            leftovers = leftovers[self.microbatch:]
            self._flush(chunk, cause="stop")

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- producer side -----------------------------------------------
    def submit(self, x, on_done: Optional[Callable] = None,
               tier=None) -> RequestHandle:
        """``tier`` (a ``scheduler.SLOTier``) stamps the request with
        its SLO class; in scheduled mode a deadline-class request is
        admission-checked here and may be shed with the typed
        ``DeadlineUnmeetable`` before it ever enters the scoreboard."""
        now = time.monotonic()
        deadline_at = (now + tier.deadline_s
                       if tier is not None and tier.deadline_s is not None
                       else None)
        h = RequestHandle(x=np.asarray(x), t_submit=now,
                          on_done=on_done, tier=tier,
                          deadline_at=deadline_at)
        with self._submit_lock:
            if self._stopping:
                raise BatcherStopped("batcher is stopping — request "
                                     "rejected, resubmit elsewhere")
            if self.scheduler is not None:
                self.scheduler.admit_or_raise(h, now)
                self.scheduler.scoreboard.insert(h)
            else:
                self._q.put(h)
        if self.scheduler is not None:
            with self._cond:
                self._cond.notify()
            # the board just went steal-eligible: wake idle siblings
            # NOW instead of leaving the overflow to their poll cadence
            if (self.steal_group is not None
                    and self.scheduler.scoreboard.depth() > self.microbatch):
                self.steal_group.notify_work(self)
        return h

    # -- batcher thread ----------------------------------------------
    def _collect(self):
        """Block for the first request, then fill the batch until it is
        full or the FIRST request's deadline expires.  Returns
        (pending, cause)."""
        first = self._q.get()
        if first is _STOP:
            return [], "stop"
        pending = [first]
        cause = "deadline"
        flush_at = first.t_submit + self.deadline_s
        while len(pending) < self.microbatch:
            # once stopping, never block on the deadline — a request
            # that raced past submit()'s stopping check must not make
            # stop() wait out a long deadline_s
            timeout = (0.0 if self._stopping
                       else flush_at - time.monotonic())
            try:
                # past the deadline, still drain the backlog that is
                # ALREADY queued (non-blocking) — under load the batch
                # fills instead of degenerating to one-request flushes
                item = (self._q.get(timeout=timeout) if timeout > 0
                        else self._q.get_nowait())
            except queue.Empty:
                break
            if item is _STOP:
                cause = "stop"
                break
            pending.append(item)
        if len(pending) == self.microbatch:
            cause = "full"
        return pending, cause

    def _collect_scheduled(self):
        """Scoreboard-mode collect: wait for pending work (stealing a
        backlogged sibling's flushes while idle), then fill until the
        board holds a full batch or the OLDEST pending request's flush
        deadline expires, then issue in priority order."""
        sb = self.scheduler.scoreboard
        # phase 1: wait for work; an idle scoreboard is the license to
        # steal (the poll doubles as the steal cadence)
        while not self._stopping and sb.depth() == 0:
            if (self.steal_group is not None
                    and self.steal_group.steal_into(self)):
                continue
            with self._cond:
                if sb.depth() == 0 and not self._stopping:
                    self._cond.wait(timeout=self._steal_poll_s)
        # phase 2: fill until full or the oldest pending deadline
        cause = "deadline"
        while True:
            depth = sb.depth()
            if depth >= self.microbatch:
                cause = "full"
                break
            if self._stopping:
                cause = "stop"
                break
            if depth == 0:       # a sibling stole everything we had
                return [], cause
            oldest = sb.oldest_t_submit()
            if oldest is None:
                return [], cause
            flush_at = oldest + self.deadline_s
            # an admitted deadline-class request must not wait out the
            # full batcher flush deadline: flush early enough that its
            # HARD deadline_at is still met after one service interval
            # (fill-normalized estimate of the flush we would issue)
            edl = sb.earliest_deadline_at()
            if edl is not None:
                est = (self.scheduler.service_estimate_s(fill=depth)
                       or self.scheduler.kernel_estimate_s() or 0.0)
                flush_at = min(flush_at, edl - est)
            timeout = flush_at - time.monotonic()
            if timeout <= 0:
                break
            with self._cond:
                self._cond.wait(timeout=timeout)
        return sb.issue(self.microbatch), cause

    def _complete(self, h: RequestHandle) -> None:
        h._event.set()
        if h.on_done is not None:
            try:
                h.on_done(h)
            except Exception:
                pass           # bookkeeping must never kill the batcher

    def _flush(self, pending: Sequence[RequestHandle],
               cause: str, buf: Optional[np.ndarray] = None) -> None:
        """Serve one microbatch.  ``buf`` defaults to the batcher's own
        buffer; a stealing sibling passes a private one so both threads
        can flush concurrently."""
        n = len(pending)
        t_enter = time.monotonic()
        with self._seq_lock:
            self._flush_seq += 1
            fkey = (id(self), self._flush_seq)
            self._inflight += 1
        try:
            ok = self._flush_inner(pending, cause, buf, n, fkey)
        finally:
            with self._seq_lock:
                self._inflight -= 1
        if ok and self.scheduler is not None:
            # whole-flush service interval (fill + engine + completion)
            # feeds the admission estimator — the kernel time alone
            # under-counts by the per-flush overhead.  The FILL rides
            # along so the estimator can normalize by batch size.
            self.scheduler.note_service(time.monotonic() - t_enter,
                                        fill=n)

    def _flush_inner(self, pending, cause, buf, n, fkey) -> bool:
        if buf is None:
            buf = self._buf
        t0 = time.monotonic()
        waited = t0 - pending[0].t_submit
        try:
            # the buffer fill is INSIDE the try: a malformed row (wrong
            # width/dtype) must fail its batch like an engine error,
            # not kill the batcher thread and hang everything behind it
            for i, h in enumerate(pending):
                buf[i] = h.x
            buf[n:] = buf[0]          # pad: fixed shape, no retrace
            out = np.asarray(self.serve_fn(buf))
        except BaseException as e:
            # the engine failed: fail THIS batch's handles (result()
            # re-raises) and keep the batcher alive for later batches.
            # The flush still gets a (failed) record — dropping it
            # would hide exactly the flushes tail-latency attribution
            # cares about most, and kernel_s records time-to-fault.
            t_fail = time.monotonic()
            self.flushes.append(FlushRecord(
                fill=n, waited_s=waited, kernel_s=t_fail - t0,
                cause=cause, tag=self.tag, failed=True))
            for h in pending:
                h._exc = e
                h.tag = self.tag
                h.flush_key = fkey
                h.t_done = time.monotonic()
                self._complete(h)
            return False
        t1 = time.monotonic()
        self.flushes.append(FlushRecord(
            fill=n, waited_s=waited, kernel_s=t1 - t0, cause=cause,
            tag=self.tag))
        for i, h in enumerate(pending):
            h._out = out[i]
            h.tag = self.tag
            h.flush_key = fkey
            h.t_done = t1
            self._complete(h)
        return True

    def _pending_empty(self) -> bool:
        return (self.scheduler.scoreboard.depth() == 0
                if self.scheduler is not None else self._q.empty())

    def _loop(self) -> None:
        while True:
            pending, cause = (self._collect_scheduled()
                              if self.scheduler is not None
                              else self._collect())
            if pending:
                self._flush(pending, cause)
            if self._stopping and self._pending_empty():
                return


class ReplayResult(List[Optional[RequestHandle]]):
    """Handles from one open-loop replay — a ``list`` (backward
    compatible with every pre-tier caller) with the replay's accounting
    riding along.  Entry ``i`` is ``None`` exactly when request ``i``
    was SHED by admission control with the typed ``DeadlineUnmeetable``
    (possible only when ``tiers`` were supplied) — a shed is a typed
    rejection, never a silent drop."""

    def __init__(self, handles, tiers=None, sheds: int = 0,
                 span_s: float = 0.0):
        super().__init__(handles)
        self.tiers = tiers          # per-request SLO tier (or None)
        self.sheds = sheds          # typed admission rejections
        self.span_s = span_s        # first submit -> last completion


def replay_open_loop(batcher, rows: np.ndarray,
                     rate: float, seed: int = 0,
                     timeout_s: float = 120.0,
                     tiers: Optional[Sequence] = None) -> ReplayResult:
    """Submit ``rows`` as a Poisson open-loop arrival process on the
    REAL clock (exponential inter-arrival gaps at ``rate`` req/s; gaps
    the OS cannot sleep are submitted immediately, i.e. the offered
    load saturates at the submitter's speed).  Blocks until every
    ADMITTED request COMPLETES and returns the handles for latency
    analysis.  Engine failures do not raise here — they stay recorded
    on the affected handles (``h.failed``) so callers can count them;
    only a genuine hang (nothing completing within ``timeout_s``)
    raises.

    ``tiers`` (a sequence of ``scheduler.SLOTier``) makes the stream
    mixed-tier: request ``i`` carries ``tiers[i % len(tiers)]``, and a
    deadline-class request the target sheds with the typed
    ``DeadlineUnmeetable`` is absorbed into the accounting (``None``
    handle + ``sheds``) instead of escaping mid-replay — this is the
    ONE Poisson load generator the plain, tiered, and fleet harnesses
    share.
    ``batcher`` is anything with ``submit(x, tier=...)``: a
    ``MicroBatcher``, a ``RegistryClient``, or a ``FleetClient``.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, len(rows))
    handles: List[Optional[RequestHandle]] = []
    tier_of = []
    sheds = 0
    t0 = time.monotonic()
    t_next = t0
    for i, (row, gap) in enumerate(zip(rows, gaps)):
        t_next += gap
        dt = t_next - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        tier = tiers[i % len(tiers)] if tiers else None
        tier_of.append(tier)
        try:
            handles.append(batcher.submit(row, tier=tier))
        except DeadlineUnmeetable:
            handles.append(None)
            sheds += 1
    for h in handles:
        if h is None:
            continue
        try:
            h.result(timeout=timeout_s)
        except RuntimeError:
            pass                 # failed batch: counted by the caller
    return ReplayResult(handles, tiers=tier_of, sheds=sheds,
                        span_s=time.monotonic() - t0)


def latency_percentiles_ms(handles: Sequence[RequestHandle],
                           qs=(50, 95, 99),
                           include_failed: bool = False) -> List[float]:
    """Latency percentiles over SERVED requests.  Failed handles are
    excluded by default: a crashed batch completes at fault time, which
    would silently IMPROVE the reported tail under fault injection.
    ``include_failed=True`` restores the raw population (the soak
    harness uses it to bound time-to-failure).  Returns NaNs when the
    selected population is empty."""
    picked = [h for h in handles
              if include_failed or not h.failed]
    if not picked:
        return [float("nan")] * len(qs)
    lats = np.asarray([h.latency_s for h in picked]) * 1e3
    return [float(v) for v in np.percentile(lats, qs)]
