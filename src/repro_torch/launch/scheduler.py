"""SLO-tiered scoreboard scheduler: priority issue, admission control,
and work-stealing for the microbatched serving stack.

The serving layers below this one (batching/registry/fleet) can
*execute* at hardware speed but treat every request as equal: the
batcher fills FIFO and overload degrades everyone uniformly.  This
module is where overload POLICY lives:

* **SLO tiers** — every request carries an ``SLOTier``: ``interactive``
  requests have a hard per-request deadline, ``batch`` requests are
  best-effort.  The tier rides the request handle end to end
  (``RequestHandle.tier`` / ``deadline_at``).

* **Scoreboard issue order** — a ``Scoreboard`` replaces the FIFO fill
  in ``MicroBatcher._collect``.  It is the software analogue of a
  hardware scoreboard's pending matrix: a slot array where each slot
  holds one waiting request with explicit per-slot state (busy bit,
  urgency line, deadline, age counter) and an issue scan picks the
  microbatch — deadline-class requests earliest-deadline-first, then
  best-effort requests oldest-first as backfill.  Requests that do not
  fit stay in their slots for the next issue round.

* **Admission control** — ``ScoreboardScheduler.admit_or_raise`` sheds
  a deadline-class request with the typed ``DeadlineUnmeetable`` when
  service provably cannot meet its deadline: the estimate multiplies
  the number of same-or-more-urgent pending requests (full microbatch
  flushes ahead of it in issue order) by a live per-flush service
  estimate — the p90 of recent whole-flush wall times (noted by the
  batcher), falling back to the ``FlushRecord.kernel_s`` median before
  any service interval lands.  Only urgent work ahead counts, so a
  shed is a provable miss, not a guess — and it costs microseconds at
  submit, never a queue traversal.

* **Work-stealing** — a ``StealGroup`` spans the batchers of one
  ``ModelRegistry``: a batcher whose own scoreboard is empty polls the
  group and, when a sibling's backlog exceeds one full microbatch,
  executes one of the sibling's flushes on its own thread (with the
  SIBLING's engine and a private buffer — results are bit-identical,
  only the thread doing the work changes).  A hot model thereby borrows
  the flush capacity of an idle one.

``replay_tiered_open_loop`` / ``tier_report`` drive and score a mixed
two-tier Poisson load — the measurement harness used by
``serve --lut --slo-tiers``, tests/test_scheduler.py, and the
``scheduler`` section of BENCH_lut_infer.json.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# SLO tiers + typed rejection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOTier:
    """One priority/SLO class.  ``deadline_s`` is the per-request hard
    deadline (submit-to-completion); ``None`` marks a best-effort tier
    that is never shed and backfills after every deadline-class
    request."""

    name: str
    deadline_s: Optional[float] = None

    @property
    def has_deadline(self) -> bool:
        return self.deadline_s is not None


#: The canonical two tiers.  ``INTERACTIVE`` carries a default deadline
#: callers usually override via ``interactive_tier``.
INTERACTIVE = SLOTier("interactive", deadline_s=0.050)
BATCH = SLOTier("batch", deadline_s=None)


def interactive_tier(deadline_s: float) -> SLOTier:
    """An interactive-class tier with an explicit hard deadline."""
    return SLOTier("interactive", deadline_s=float(deadline_s))


class DeadlineUnmeetable(RuntimeError):
    """Typed admission-control rejection: queue depth x kernel time
    provably exceeds the request's deadline, so serving it would only
    burn capacity on a guaranteed SLO miss.  Raised AT SUBMIT (the
    request never enters a queue); callers count these as sheds, never
    as silent drops."""


# ---------------------------------------------------------------------------
# the scoreboard: slot array with explicit per-slot issue state
# ---------------------------------------------------------------------------

class _Slot:
    """One scoreboard slot — the software row of a pending matrix:
    ``busy`` is the valid bit, ``urgent`` the priority-class line, and
    ``deadline_at``/``seq`` the state the issue scan compares (seq is
    the age counter: lower = older)."""

    __slots__ = ("busy", "urgent", "deadline_at", "seq", "handle")

    def __init__(self):
        self.busy = False
        self.urgent = False
        self.deadline_at = 0.0
        self.seq = 0
        self.handle = None


class Scoreboard:
    """Pending-request scoreboard deciding microbatch issue order.

    Issue order: deadline-class (urgent) slots earliest-deadline-first,
    then best-effort slots oldest-first as backfill.  The slot array
    grows by doubling when full, so the board never refuses an insert —
    backpressure is admission control's job, not the board's."""

    def __init__(self, n_slots: int = 64):
        self._slots = [_Slot() for _ in range(max(1, n_slots))]
        self._free = list(range(len(self._slots) - 1, -1, -1))
        self._lock = threading.Lock()
        self._next_seq = 0
        self._n_busy = 0

    def insert(self, handle) -> None:
        """File a request into a free slot (growing if none is free)."""
        with self._lock:
            if not self._free:
                base = len(self._slots)
                self._slots.extend(_Slot() for _ in range(base))
                self._free = list(range(2 * base - 1, base - 1, -1))
            s = self._slots[self._free.pop()]
            s.busy = True
            s.handle = handle
            s.urgent = handle.deadline_at is not None
            s.deadline_at = handle.deadline_at or 0.0
            s.seq = self._next_seq
            self._next_seq += 1
            self._n_busy += 1

    def depth(self) -> int:
        with self._lock:
            return self._n_busy

    def urgent_ahead(self, deadline_at: float) -> int:
        """How many pending deadline-class requests would issue before
        a request with this deadline — the quantity admission control
        multiplies by the kernel-time estimate.  Best-effort slots are
        excluded: they backfill, they never displace urgent work."""
        with self._lock:
            return sum(1 for s in self._slots
                       if s.busy and s.urgent and s.deadline_at <= deadline_at)

    def oldest_t_submit(self) -> Optional[float]:
        """Submit time of the oldest pending request (drives the
        batcher's deadline-flush timer), or None when empty."""
        with self._lock:
            oldest = None
            for s in self._slots:
                if s.busy and (oldest is None or s.seq < oldest.seq):
                    oldest = s
            return None if oldest is None else oldest.handle.t_submit

    def earliest_deadline_at(self) -> Optional[float]:
        """Earliest hard deadline among pending deadline-class requests
        (drives the batcher's SLO-aware flush timer — a non-full board
        must still flush early enough for the tightest admitted
        deadline), or None when no urgent work is pending."""
        with self._lock:
            edl = None
            for s in self._slots:
                if s.busy and s.urgent and (edl is None
                                            or s.deadline_at < edl):
                    edl = s.deadline_at
            return edl

    def issue(self, n: int) -> List:
        """Issue scan: pop up to ``n`` requests in priority order
        (urgent by earliest deadline then age; best-effort by age).
        Requests that don't fit keep their slots for the next round."""
        with self._lock:
            busy = [(0, s.deadline_at, s.seq) if s.urgent
                    else (1, 0.0, s.seq) for s in self._slots if s.busy]
            if not busy:
                return []
            by_key = sorted(range(len(busy)), key=busy.__getitem__)
            # map sorted positions back to slot indices
            slot_idx = [i for i, s in enumerate(self._slots) if s.busy]
            picked = [slot_idx[j] for j in by_key[:n]]
            out = []
            for i in picked:
                s = self._slots[i]
                out.append(s.handle)
                s.busy = False
                s.handle = None
                self._free.append(i)
                self._n_busy -= 1
            return out


# ---------------------------------------------------------------------------
# kernel-time estimation + admission control
# ---------------------------------------------------------------------------

def kernel_estimate_s(flushes: Sequence, window: int = 32) -> Optional[float]:
    """Median kernel time over the last ``window`` SUCCESSFUL flushes
    (failed flushes record the time-to-fault, which would poison the
    estimate), or None when there is no history yet."""
    ks = [f.kernel_s for f in list(flushes)[-window:] if not f.failed]
    return float(np.median(ks)) if ks else None


class ScoreboardScheduler:
    """Per-batcher scheduling state: the scoreboard, the kernel-time
    estimator over the batcher's own flush history, and the admission
    gate.  Bound to its ``MicroBatcher`` at construction time
    (``MicroBatcher(scheduler=...)`` calls ``bind``)."""

    def __init__(self, window: int = 32):
        self.scoreboard = Scoreboard()
        self.window = window
        self.sheds = 0                       # typed rejections issued
        self._batcher = None
        # whole-flush (fill, seconds) service intervals (buffer fill +
        # engine + completion), noted by the batcher after each
        # successful flush.  Admission estimates from a HIGH quantile
        # of these — the kernel median alone under-estimates by the
        # per-flush overhead, and under steady-state overload the queue
        # pins at the admission ceiling, so that bias turns every
        # boundary admit into a deadline miss.  Keeping the FILL lets
        # the estimate normalize: a history of lone-straggler flushes
        # must not mis-price a full-batch flush, nor vice versa.
        self._service_s: List[Tuple[Optional[int], float]] = []
        # the estimator sits on the submit hot path (admission + the
        # fleet router call it per request), but its inputs only change
        # when a flush lands: memoize the quantile/fit per history
        # version so steady-state estimates are pure arithmetic
        self._est_version = 0
        self._est_cache: Optional[Tuple[int, float, Optional[Tuple[
            float, float, float]]]] = None

    def bind(self, batcher) -> None:
        # a weak reference: the batcher owns its scheduler, and a cycle
        # between them would leave a stopped batcher (its engine, its
        # tables on the card) to the collector's full pass, which does
        # not walk the heap frozen while serving (batching.py)
        self._batcher = weakref.proxy(batcher)

    def kernel_estimate_s(self) -> Optional[float]:
        return kernel_estimate_s(self._batcher.flushes, self.window)

    def note_service(self, seconds: float,
                     fill: Optional[int] = None) -> None:
        """Record one successful flush's wall time and its FILL (real
        requests served — called by the batcher; list append is atomic
        under the GIL)."""
        self._service_s.append((fill, float(seconds)))
        if len(self._service_s) > 4 * self.window:
            del self._service_s[:-self.window]
        self._est_version += 1

    def service_estimate_s(self, fill: Optional[int] = None
                           ) -> Optional[float]:
        """Per-flush service estimate — deliberately conservative, so
        admission sheds the coin-flip boundary requests instead of
        admitting them into a miss.

        Without ``fill``: the fill-blind p90 of recent whole-flush wall
        times (the pre-normalization behavior — still what the generic
        "one more flush ahead of you" terms price with).  With
        ``fill``: a least-squares ``a + b*fill`` over the recent
        ``(fill, seconds)`` pairs, padded by the p90 residual so the
        conservative-quantile character survives normalization.  Falls
        back to the fill-blind p90 while the history is too small or
        too degenerate (a single distinct fill, or a nonsensical
        negative slope) to support a fit."""
        cache = self._est_cache
        if cache is None or cache[0] != self._est_version:
            cache = self._fit_service(self._est_version)
            self._est_cache = cache
        if cache is None:
            return None
        _, p90, fit = cache
        if fill is None or fit is None:
            return p90
        a, b, pad = fit
        return a + b * fill + pad

    def _fit_service(self, version: int
                     ) -> Optional[Tuple[int, float, Optional[Tuple[
                         float, float, float]]]]:
        """Recompute the memoized (p90, fit) for one history version —
        off the per-request path; runs once per noted flush."""
        recent = self._service_s[-self.window:]
        if not recent:
            return None
        secs = [s for _, s in recent]
        p90 = float(np.quantile(secs, 0.9))
        pairs = [(f, s) for f, s in recent if f is not None]
        if len(pairs) < 4 or len({f for f, _ in pairs}) < 2:
            return (version, p90, None)
        fs = np.asarray([f for f, _ in pairs], dtype=np.float64)
        ss = np.asarray([s for _, s in pairs], dtype=np.float64)
        b, a = np.polyfit(fs, ss, 1)
        if b < 0 or a < 0:
            # noise-dominated fit (service should never shrink with
            # fill, nor cost negative overhead at fill 0): the
            # fill-blind conservative quantile is the honest answer
            return (version, p90, None)
        pad = max(0.0, float(np.quantile(ss - (a + b * fs), 0.9)))
        return (version, p90, (float(a), float(b), pad))

    def estimate_delay_s(self,
                         deadline_at: Optional[float] = None
                         ) -> Optional[float]:
        """Estimated queueing delay a new request would see: the
        full-microbatch flushes ahead of it in issue order (urgent work
        only when the request itself is deadline-class) priced at the
        full-fill service estimate, plus its OWN flush priced at the
        tail fill it would actually ride in — fill-normalized where the
        history supports it, the fill-blind conservative p90 otherwise,
        and the kernel median before any service interval has been
        noted.  None until the first flush lands (no history — always
        admit)."""
        mb = self._batcher.microbatch
        ahead = (self.scoreboard.urgent_ahead(deadline_at)
                 if deadline_at is not None else self.scoreboard.depth())
        est_full = self.service_estimate_s(fill=mb)
        if est_full is None:
            kest = self.kernel_estimate_s()
            if kest is None:
                return None
            est_full = est_tail = est_blind = kest
        else:
            est_tail = self.service_estimate_s(fill=ahead % mb + 1)
            est_blind = self.service_estimate_s()
        total = (ahead // mb) * est_full + est_tail
        # a flush already executing must complete before anything in
        # the scoreboard issues — without this term, steady-state
        # overload admits boundary requests that miss by one kernel.
        # Its fill is unknown, so it is priced fill-blind.
        if self._batcher._inflight > 0:
            total += est_blind
        return total

    def admit_or_raise(self, handle, now: float) -> None:
        """Shed ``handle`` with the typed ``DeadlineUnmeetable`` when
        even the optimistic service estimate misses its deadline.
        Best-effort requests always admit.  Called under the batcher's
        submit lock, so the shed counter needs no extra locking."""
        if handle.deadline_at is None:
            return
        est = self.estimate_delay_s(handle.deadline_at)
        if est is None:
            return
        if now + est > handle.deadline_at:
            self.sheds += 1
            per_flush = self.service_estimate_s() or self.kernel_estimate_s()
            raise DeadlineUnmeetable(
                f"deadline in {(handle.deadline_at - now) * 1e3:.2f} ms "
                f"but estimated service is {est * 1e3:.2f} ms "
                f"({self.scoreboard.depth()} queued x "
                f"{per_flush * 1e3:.2f} ms per flush) — "
                f"request shed at admission")


# ---------------------------------------------------------------------------
# work-stealing across the batchers of one registry
# ---------------------------------------------------------------------------

class StealGroup:
    """Sibling batchers that may execute each other's flushes.  A
    batcher polls ``steal_into`` while its own scoreboard is empty; the
    group picks the sibling with the deepest backlog beyond one full
    microbatch (its own next flush is already covered — stealing takes
    the OVERFLOW) and runs one flush of that sibling's work on the
    idle thread, with the sibling's engine and a private buffer."""

    def __init__(self):
        self._members: List = []
        self._lock = threading.Lock()
        self.steals = 0                      # stolen flushes executed
        self.stolen_requests = 0             # requests served by thieves

    def register(self, batcher) -> None:
        with self._lock:
            if batcher not in self._members:
                self._members.append(batcher)

    def unregister(self, batcher) -> None:
        with self._lock:
            if batcher in self._members:
                self._members.remove(batcher)

    def notify_work(self, victim) -> None:
        """Wake the group's idle batchers NOW: ``victim``'s scoreboard
        just went steal-eligible (backlog beyond one full microbatch).
        Called by the victim's ``submit`` path, so steals start on
        notification latency instead of the idle-poll cadence; the poll
        in ``MicroBatcher._collect_scheduled`` stays as the fallback
        for notifications lost to races."""
        with self._lock:
            members = list(self._members)
        for m in members:
            if m is victim:
                continue
            with m._cond:
                m._cond.notify()

    def steal_into(self, thief) -> bool:
        """Execute one flush of the most-backlogged sibling's overflow
        on the thief's thread.  Returns True when work was stolen."""
        with self._lock:
            members = list(self._members)
        victim, backlog = None, 0
        for m in members:
            if m is thief or m._stopping or m.scheduler is None:
                continue
            d = m.scheduler.scoreboard.depth()
            if d > m.microbatch and d > backlog:
                victim, backlog = m, d
        if victim is None:
            return False
        n = min(victim.microbatch, backlog - victim.microbatch)
        pending = victim.scheduler.scoreboard.issue(n)
        if not pending:
            return False
        # private buffer: the victim's own thread may be flushing into
        # victim._buf concurrently
        buf = np.zeros_like(victim._buf)
        victim._flush(pending, cause="steal", buf=buf)
        with self._lock:
            self.steals += 1
            self.stolen_requests += len(pending)
        return True


# ---------------------------------------------------------------------------
# tiered open-loop load generator + per-tier scoring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TieredReplay:
    """Outcome of one mixed-tier open-loop run.  ``handles[i]`` is None
    exactly when request ``i`` was shed with a typed
    ``DeadlineUnmeetable`` — a shed is never a silent drop."""

    handles: List                    # per request; None = shed
    tiers: List[SLOTier]             # per request
    sheds: int
    span_s: float                    # first submit -> last completion


def replay_tiered_open_loop(client, rows: np.ndarray,
                            rate: float, tiers: Sequence[SLOTier],
                            seed: int = 0,
                            timeout_s: float = 120.0) -> TieredReplay:
    """Poisson open-loop load generator for a mixed-tier stream:
    request ``i`` carries ``tiers[i % len(tiers)]`` (interleave the list
    to set the mix).  ``client.submit(x, tier=...)`` may raise the typed
    ``DeadlineUnmeetable`` — recorded as a shed.  Blocks until every
    ADMITTED request completes; engine failures stay on the handles
    (``h.failed``), only a genuine hang raises.

    Thin adapter over the SHARED Poisson load generator
    (``batching.replay_open_loop``) — one arrival process, one shed
    accounting, used by the plain, tiered, and fleet benches alike."""
    from repro_torch.launch.batching import replay_open_loop

    res = replay_open_loop(client, rows, rate, seed=seed,
                           timeout_s=timeout_s, tiers=list(tiers))
    return TieredReplay(handles=list(res), tiers=res.tiers,
                        sheds=res.sheds, span_s=res.span_s)


def tier_report(replay: TieredReplay) -> Dict[str, Dict[str, float]]:
    """Per-tier scoring of a mixed run: latency percentiles over the
    admitted+served requests, deadline attainment for deadline-class
    tiers (fraction of ADMITTED requests completing within their
    deadline — sheds are typed rejections, not misses), shed rate over
    the OFFERED requests, and throughput over the run span."""
    out: Dict[str, Dict[str, float]] = {}
    by_name: Dict[str, Tuple[SLOTier, List]] = {}
    for h, tier in zip(replay.handles, replay.tiers):
        by_name.setdefault(tier.name, (tier, []))[1].append(h)
    for name, (tier, hs) in by_name.items():
        offered = len(hs)
        shed = sum(1 for h in hs if h is None)
        served = [h for h in hs if h is not None and h.done and not h.failed]
        lats = np.asarray([h.latency_s for h in served]) * 1e3
        entry = {
            "offered": offered,
            "shed": shed,
            "shed_rate": shed / offered if offered else 0.0,
            "served": len(served),
            "p50_ms": float(np.percentile(lats, 50)) if len(lats) else
            float("nan"),
            "p99_ms": float(np.percentile(lats, 99)) if len(lats) else
            float("nan"),
            "throughput_req_s": (len(served) / replay.span_s
                                 if replay.span_s > 0 else 0.0),
        }
        if tier.has_deadline:
            admitted = offered - shed
            met = sum(1 for h in served
                      if h.latency_s <= tier.deadline_s)
            entry["deadline_ms"] = tier.deadline_s * 1e3
            entry["attainment"] = met / admitted if admitted else 1.0
        out[name] = entry
    return out
