"""Public entry point for LUT-mode inference (port of
``repro.kernels.lut_gather.ops``).

``lut_layer`` runs one synthesised layer through the per-layer kernel;
``lut_network`` chains it over a whole network (one launch a layer, all
from one host call, as the reference's jitted ``lut_network`` is one
dispatch); ``lut_network_fused``
runs every layer in ONE launch with the inter-layer codes in shared
memory.  ``plan_segments`` decides how a network runs: one fused launch
when a block of it fits the card's shared memory (every network of the
paper does, at any batch), a chain of fused segments when it does not,
the per-layer kernel as the last resort.  ``make_network_fn`` closes
over a network (or a loaded artifact) once and returns the serving
callable, with the chosen plan as ``fn.execution_plan``.

``lut_network_fused_sharded`` splits the batch over a device mesh
(``parallel.sharding.Mesh``) with the tables replicated on each of its
devices: each shard runs the plan on its entry's device and stream, and
the shards never communicate.  ``tune_block_b`` sweeps a fused plan's
cap on rows per block (each launch picks its rows from its batch
within the cap: ``lut_gather.fused_geometry``);
``make_network_fn(block_b="auto")`` runs it for each segment.

All paths match ``repro_torch.core.lut_synth.lut_forward`` and the
reference package bit for bit (tests/test_torch_lut.py,
tests/test_torch_sharded.py; on the card, chip_smoke.py).  On CPU
tensors every path runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_gather import lut_gather as K
from repro_torch.kernels.lut_gather.lut_gather import SMEM_BUDGET_BYTES


def _infer_n_in0(tables: List, n_in0: Optional[int]) -> int:
    """Network input width: as given, else from the first layer's
    routing slab, else the highest conn index + 1 (an under-count when
    connectivity never touches the top input features)."""
    if n_in0 is not None:
        return int(n_in0)
    t0 = tables[0]
    if t0.routing is not None:
        return int(t0.routing.shape[0])
    return int(t0.conn.max().item()) + 1


def _layer_args(tables: Sequence, n_in0: int,
                check_conn: bool = False) -> List[K.LayerArgs]:
    out, n_in = [], n_in0
    for t in tables:
        out.append(K.layer_args(t.conn, t.sub_table, t.add_table,
                                t.in_bits, t.sub_bits, t.sub_packed,
                                t.add_packed, n_in=n_in,
                                check_conn=check_conn))
        n_in = t.conn.shape[0]
    return out


def lut_layer(codes: torch.Tensor, conn: torch.Tensor,
              sub_table: torch.Tensor, add_table: torch.Tensor,
              in_bits: int, sub_bits: int, sub_packed: bool = False,
              add_packed: bool = False) -> torch.Tensor:
    """One layer: (B, n_in) int32 codes -> (B, n_out) int32."""
    return K.lut_gather(codes, K.layer_args(
        conn, sub_table, add_table, in_bits, sub_bits, sub_packed,
        add_packed, n_in=codes.shape[1]))


def lut_network(tables: List, codes: torch.Tensor) -> torch.Tensor:
    """Per-layer path: one launch per layer, codes through device memory
    between layers, every launch from one host call."""
    return K.lut_layers(codes, K.FusedNet(_layer_args(tables,
                                                      codes.shape[1])))


def lut_network_fused(tables: List, codes: torch.Tensor,
                      block_b: Optional[int] = None,
                      pipeline: bool = False) -> torch.Tensor:
    """Fused path: the whole network in one launch.  ``block_b`` forces
    the rows per block (default: chosen from the batch within the
    shared-memory ledger's cap); ``pipeline=True`` selects the
    persistent double-buffered kernel."""
    net = K.FusedNet(_layer_args(tables, codes.shape[1]))
    return K.lut_network_fused(codes, net, rows=block_b, pipeline=pipeline)


def fused_smem_bytes(tables: List, block_b: int,
                     n_in0: Optional[int] = None,
                     pipeline: bool = False) -> int:
    """Shared memory of one fused block of ``block_b`` rows (the ledger
    of ``lut_gather.fused_smem_bytes``)."""
    return K.fused_smem_bytes(_infer_n_in0(tables, n_in0),
                              [t.conn.shape[0] for t in tables],
                              block_b, pipeline)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """How one network runs on the card.

    ``mode`` is ``"fused"`` (one launch for the whole network),
    ``"segmented"`` (a chain of fused launches, the cut layer's codes
    passing through device memory) or ``"per_layer"`` (some single layer
    does not fit a block's shared memory even at one row).  ``bounds``
    are half-open ``(start, end)`` layer ranges; ``block_b`` and
    ``smem_bytes`` are each segment's cap on rows per block and the
    ledger at the cap (each launch chooses its rows from the batch, up to
    the cap: ``lut_gather.fused_geometry``); ``cut_widths`` are the code
    widths crossing each cut."""
    mode: str
    bounds: Tuple[Tuple[int, int], ...]
    block_b: Tuple[int, ...]
    smem_bytes: Tuple[int, ...]
    cut_widths: Tuple[int, ...]
    seg_widths: Tuple[Tuple[int, int], ...]   # (n_in, n_out) per segment
    n_in0: int
    budget: int
    pipeline: bool

    @property
    def n_segments(self) -> int:
        return len(self.bounds)

    def describe(self) -> str:
        """One-line human summary for model-load logging."""
        if self.mode == "per_layer":
            return (f"plan: per-layer (a single layer exceeds the "
                    f"{self.budget}-byte shared-memory budget)")
        segs = " ".join(
            f"[L{s}..L{e - 1} rows<={bb} smem<={v}B]"
            for (s, e), bb, v in zip(self.bounds, self.block_b,
                                     self.smem_bytes))
        extra = (f" cuts={list(self.cut_widths)}"
                 if self.mode == "segmented" else "")
        return (f"plan: {self.mode} x{self.n_segments} pipeline="
                f"{self.pipeline}{extra} {segs}; rows per block chosen "
                f"per batch up to the cap")


def _per_layer_plan(n_in0: int, budget: int) -> SegmentPlan:
    return SegmentPlan(mode="per_layer", bounds=(), block_b=(),
                       smem_bytes=(), cut_widths=(), seg_widths=(),
                       n_in0=n_in0, budget=budget, pipeline=False)


def _plan_bounds(widths: List[int], n_in0: int, pipeline: bool,
                 budget: int, block_b: Optional[int]):
    """Fewest-segment cover of the layers such that every segment fits
    ``budget`` at one row or more (at ``block_b`` rows when given),
    tie-broken on the total width of the cut layers, whose codes cross
    device memory.  Returns ``(bounds, rows, cuts, seg_widths)`` or None
    when some single layer does not fit."""
    L = len(widths)

    def seg_in(i: int) -> int:
        return n_in0 if i == 0 else widths[i - 1]

    def rows(i: int, j: int) -> int:
        if block_b is not None:
            fits = K.fused_smem_bytes(seg_in(i), widths[i:j], block_b,
                                      pipeline) <= budget
            return block_b if fits else 0
        return K.block_rows(seg_in(i), widths[i:j], pipeline, budget)

    INF = (float("inf"), float("inf"), -1)
    # best[i] = (segments, total cut width, next boundary) for layers i..L
    best = [INF] * L + [(0, 0, L)]
    for i in range(L - 1, -1, -1):
        for j in range(i + 1, L + 1):
            if rows(i, j) < 1:
                continue
            segs, cutw, _ = best[j]
            cand = (1 + segs, cutw + (widths[j - 1] if j < L else 0), j)
            if cand[:2] < best[i][:2]:
                best[i] = cand
    if best[0][2] < 0:
        return None
    bounds, i = [], 0
    while i < L:
        j = best[i][2]
        bounds.append((i, j))
        i = j
    return (tuple(bounds), tuple(rows(s, e) for s, e in bounds),
            tuple(widths[e - 1] for _, e in bounds[:-1]),
            tuple((seg_in(s), widths[e - 1]) for s, e in bounds))


def plan_segments(tables: List, block_b: Optional[int] = None,
                  n_in0: Optional[int] = None, pipeline: bool = False,
                  budget: Optional[int] = None) -> SegmentPlan:
    """Partition a network into the fewest fused segments whose blocks
    fit ``budget`` bytes of shared memory (the H100's 232,448 by
    default).  The ledger counts the block's codes, not the slabs, so at
    the default budget every network narrower than ~58,000 input codes
    plans to one segment; multi-segment plans arise under a smaller
    forced ``budget``.  They run each segment through the pipelined
    kernel unless its larger claim would cost an extra cut."""
    budget = SMEM_BUDGET_BYTES if budget is None else int(budget)
    if hasattr(tables, "tables"):          # a loaded Artifact
        n_in0 = tables.n_in if n_in0 is None else n_in0
        tables = tables.tables
    tables = list(tables)
    n_in0 = _infer_n_in0(tables, n_in0)
    widths = [t.conn.shape[0] for t in tables]
    r = _plan_bounds(widths, n_in0, pipeline, budget, block_b)
    if r is None:
        return _per_layer_plan(n_in0, budget)
    pipe = pipeline
    if len(r[0]) > 1 and not pipe:
        r2 = _plan_bounds(widths, n_in0, True, budget, block_b)
        if r2 is not None and len(r2[0]) == len(r[0]):
            r, pipe = r2, True
    bounds, rows, cuts, segw = r
    return SegmentPlan(
        mode="fused" if len(bounds) == 1 else "segmented", bounds=bounds,
        block_b=rows,
        smem_bytes=tuple(K.fused_smem_bytes(wi, widths[s:e], bb, pipe)
                         for (s, e), bb, (wi, _) in zip(bounds, rows, segw)),
        cut_widths=cuts, seg_widths=segw, n_in0=n_in0, budget=budget,
        pipeline=pipe)


def _compile_plan(tables: List, plan: SegmentPlan) -> Callable:
    """Check the tables once (conn ranges included), build each
    segment's descriptor array, and return ``run(codes)``.  Each
    segment's ``block_b`` is a cap: every call picks its rows per block
    from its batch (``lut_gather.fused_geometry``).  A ``per_layer`` run
    is one host call a forward (``lut_gather.lut_layers``)."""
    args = _layer_args(tables, plan.n_in0, check_conn=True)
    if plan.mode == "per_layer":
        chain = K.FusedNet(args)
        return lambda codes: K.lut_layers(codes, chain)
    segs = [(K.FusedNet(args[s:e]), bb)
            for (s, e), bb in zip(plan.bounds, plan.block_b)]

    def run(codes):
        for net, bb in segs:
            codes = K.lut_network_fused(codes, net, max_rows=bb,
                                        pipeline=plan.pipeline)
        return codes
    return run


def lut_network_segmented(tables: List, codes: torch.Tensor,
                          plan: Optional[SegmentPlan] = None,
                          block_b: Optional[int] = None,
                          budget: Optional[int] = None) -> torch.Tensor:
    """Plan (or take a plan) and run the chain of fused segments."""
    if plan is None:
        plan = plan_segments(tables, block_b=block_b,
                             n_in0=codes.shape[1], budget=budget)
    return _compile_plan(list(tables), plan)(codes)


def _fused_plan(n_in0: int, widths: List[int], block_b: Optional[int],
                pipeline: bool, budget: int) -> SegmentPlan:
    """The whole network as one fused segment, its rows per block capped
    at ``block_b`` (the ledger's cap when None)."""
    rows = (K.block_rows(n_in0, widths, pipeline, budget)
            if block_b is None else int(block_b))
    smem = K.fused_smem_bytes(n_in0, widths, rows, pipeline)
    if rows < 1 or smem > budget:
        raise ValueError(
            f"the whole network does not fit one block's shared "
            f"memory ({smem} > {budget} bytes); use fused=None")
    return SegmentPlan(
        mode="fused", bounds=((0, len(widths)),), block_b=(rows,),
        smem_bytes=(smem,), cut_widths=(), seg_widths=((n_in0, widths[-1]),),
        n_in0=n_in0, budget=budget, pipeline=pipeline)


# ---------------------------------------------------------------------------
# the batch split over a device mesh
# ---------------------------------------------------------------------------

def _mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a serving mesh splits the batch over: every axis except
    ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _mesh_batch_shards(mesh) -> int:
    """Number of batch shards a serving mesh yields: the product of its
    data-parallel axes (every axis except ``model``)."""
    n = 1
    for a in _mesh_batch_axes(mesh):
        n *= mesh.shape[a]
    return n


# networks a mesh keeps replicated for direct calls of
# lut_network_fused_sharded (make_network_fn keeps its own engine)
_MESH_CACHE_NETWORKS = 8


class ShardedEngine:
    """One network served over a mesh.  Its tables are replicated once on
    each distinct device of the shards' entries and the plan compiled
    there (``_compile_plan``); a call pads the batch to a multiple of the
    shard count, runs shard k on entry k's device and CUDA stream, joins
    the shards with events on the caller's stream of the first entry's
    device, and slices the result back to the batch.  Shards never
    communicate.

    CUDA entries: input codes on the CPU or on another card are copied
    to each shard's device (never served on the CPU); a tensor a side
    stream uses is recorded on it, so the caching allocator does not
    hand its memory out early.  CPU entries run the plain versions one
    shard after another."""

    def __init__(self, tables: List, plan: SegmentPlan, mesh):
        self.mesh = mesh
        self.plan = plan
        self.entries = mesh.shard_entries(_mesh_batch_axes(mesh))
        self.devices = [mesh.device_list[i] for i in self.entries]
        self.device = self.devices[0]
        self._runs: Dict[torch.device, Callable] = {}
        for dev in self.devices:
            if dev not in self._runs:
                self._runs[dev] = _compile_plan(
                    [t.to(dev) for t in tables], plan)

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        n_in = self.plan.n_in0
        if self.device.type == "cpu" and codes.device.type != "cpu":
            raise ValueError(f"codes on {codes.device}, mesh on the CPU")
        codes = K._codes_arg(codes, n_in)
        B, n = codes.shape[0], len(self.entries)
        pad = (-B) % n
        if pad:
            codes = torch.cat([codes, codes.new_zeros((pad, n_in))])
        per = (B + pad) // n
        if self.device.type == "cpu":
            parts = [self._runs[d](codes[k * per:(k + 1) * per])
                     for k, d in enumerate(self.devices)]
            return torch.cat(parts)[:B]
        main = torch.cuda.current_stream(self.device)
        src = (torch.cuda.current_stream(codes.device)
               if codes.device.type == "cuda" else None)
        parts = []
        for k, (entry, dev) in enumerate(zip(self.entries, self.devices)):
            s = self.mesh.stream(entry)
            with torch.cuda.device(dev), torch.cuda.stream(s):
                if src is not None:
                    s.wait_stream(src)
                c = codes[k * per:(k + 1) * per]
                if c.device == dev:
                    codes.record_stream(s)
                else:
                    c = c.to(dev)
                o = self._runs[dev](c)
                if dev == self.device:
                    o.record_stream(main)
                else:
                    o = o.to(self.device)
            main.wait_stream(s)
            parts.append(o)
        return torch.cat(parts)[:B]


def lut_network_fused_sharded(tables: List, codes: torch.Tensor, mesh,
                              block_b: Optional[int] = None,
                              fused: bool = True, pipeline: bool = False,
                              plan: Optional[SegmentPlan] = None
                              ) -> torch.Tensor:
    """Data-parallel inference: the batch split over the mesh's every
    axis but ``model``, the tables replicated on each device, each shard
    running the fused kernel (``fused``; ``pipeline`` for the persistent
    one; ``block_b`` caps its rows per block), the per-layer chain
    (``fused=False``) or ``plan``'s segment chain on its entry's device
    and stream, with no communication between devices.  Any B works on
    any shard count: the batch is padded to a multiple of it and the
    result sliced back.

    The result is one (B, n_out) int32 tensor on the first entry's
    device; the reference's stays sharded over the mesh
    (tests/test_lut_sharded.py) and the port joins it.  The mesh keeps
    the replicas of the last few networks it served this way, so a
    repeated call copies no table; ``make_network_fn(mesh=)`` builds
    its engine once."""
    if hasattr(tables, "tables"):          # a loaded Artifact
        tables = tables.tables
    tables = list(tables)
    if plan is None:
        n_in0 = _infer_n_in0(tables, codes.shape[1] if codes.dim() == 2
                             else None)
        widths = [t.conn.shape[0] for t in tables]
        plan = (_fused_plan(n_in0, widths, block_b, pipeline,
                            SMEM_BUDGET_BYTES) if fused
                else _per_layer_plan(n_in0, SMEM_BUDGET_BYTES))
    key = (tuple(id(t.conn) for t in tables), plan)
    hit = mesh.cache.get(key)
    if hit is None:
        # the tables ride along so their ids stay theirs while cached
        hit = mesh.cache[key] = (tables, ShardedEngine(tables, plan, mesh))
        while len(mesh.cache) > _MESH_CACHE_NETWORKS:
            mesh.cache.popitem(last=False)
    else:
        mesh.cache.move_to_end(key)
    return hit[1](codes)


# ---------------------------------------------------------------------------
# the cap on rows per block
# ---------------------------------------------------------------------------

# caps swept by default: every power of two a fused block may take
# (MAX_BLOCK_ROWS is the ledger's most).  The reference sweeps TPU batch
# tiles of 128 to 2048 rows; past MAX_BLOCK_ROWS every cap is the same
# launch here (fused_geometry clamps to the ledger), so those would time
# one geometry five times.
TUNE_CANDIDATES = tuple(1 << i for i in range(
    K.MAX_BLOCK_ROWS.bit_length()))


# Launches that time within this share of the fastest count as level,
# and among level ones the tuner keeps the largest cap (a cap binds every
# batch a plan serves, and a larger one lets big batches take the rows
# fused_geometry wants).  Identical launches timed over 20 host-bound
# calls on an H100 spread by up to 50% (PERF.md, section 6), so a margin
# narrower than that would pick by noise.
TUNE_LEVEL_MARGIN = 0.5


def _time_calls(fn, codes: torch.Tensor, iters: int) -> float:
    """Seconds a call of ``fn(codes)`` after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn(codes)
    if codes.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(codes)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(codes.device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(codes)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _time_cap(net, codes: torch.Tensor, cap: int, pipeline: bool,
              iters: int) -> float:
    """Seconds a fused call of ``net`` under ``cap`` rows a block."""
    return _time_calls(
        lambda c: K.lut_network_fused(c, net, pipeline=pipeline,
                                      max_rows=cap), codes, iters)


def tune_block_b(tables: List, batch: int = 2048,
                 candidates: Sequence[int] = TUNE_CANDIDATES,
                 iters: int = 20, n_in0: Optional[int] = None,
                 pipeline: bool = False, budget: Optional[int] = None,
                 device: DeviceLike = None):
    """Choose the fused kernel's cap on rows per block; return
    ``(best_cap, {cap: seconds a call})``.

    Candidates are clamped to the probe ``batch`` and kept where the
    shared-memory ledger at that many rows fits ``budget`` (and no more
    than MAX_BLOCK_ROWS, the ledger's cap); none left raises the
    reference's ValueError.  Caps that give the same launch at the
    probe (``fused_geometry`` on the SMs of the tables' card, or the
    H100's on the CPU) form a group, and one cap a group
    is timed: ``iters`` calls on random codes after a warm-up call, with
    CUDA events on the tables' card.  Every cap reports its group's
    time.  Among the groups within TUNE_LEVEL_MARGIN of the fastest the
    largest cap wins.  On CPU tables every cap runs the same plain
    version, so the host-clock times there rank nothing."""
    budget = SMEM_BUDGET_BYTES if budget is None else int(budget)
    dev = tables[0].conn.device if device is None else resolve_device(
        device)
    tables = [t.to(dev) for t in tables]
    n_in = _infer_n_in0(tables, n_in0)
    widths = [t.conn.shape[0] for t in tables]
    cand = sorted({min(int(c), int(batch), K.MAX_BLOCK_ROWS)
                   for c in candidates})
    cand = [c for c in cand if c >= 1 and K.fused_smem_bytes(
        n_in, widths, c, pipeline) <= budget]
    if not cand:
        raise ValueError(
            "no block_b candidate fits the fused shared-memory budget for "
            "this network — serve it through the per-layer engine "
            "(make_network_fn(fused=False))")
    n_sms = (K._sm_count(dev.index) if dev.type == "cuda"
             else K.H100_SM_COUNT)
    groups: Dict[K.FusedGeometry, List[int]] = {}
    for cap in cand:
        g = K.fused_geometry(int(batch), n_sms, n_in, widths, pipeline,
                             max_rows=cap, budget=budget)
        groups.setdefault(g, []).append(cap)
    gen = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 2 ** tables[0].in_bits, (int(batch), n_in),
                          generator=gen, dtype=torch.int32).to(dev)
    net = K.FusedNet(_layer_args(tables, n_in))
    timings, group_s = {}, []
    for caps in groups.values():
        secs = _time_cap(net, codes, caps[-1], pipeline, iters)
        group_s.append((secs, caps[-1]))
        timings.update({c: secs for c in caps})
    fastest = min(s for s, _ in group_s)
    best = max(cap for s, cap in group_s
               if s <= fastest * (1.0 + TUNE_LEVEL_MARGIN))
    return best, dict(sorted(timings.items()))


def _tune_plan(tables: List, plan: SegmentPlan, tune_batch: int
               ) -> SegmentPlan:
    """``tune_block_b`` for each segment of ``plan``: each gets its own
    cap, from candidates the segment's ledger admits under the plan's
    budget."""
    widths = [t.conn.shape[0] for t in tables]
    caps, smem = [], []
    for s, e in plan.bounds:
        seg_in = plan.n_in0 if s == 0 else widths[s - 1]
        cap, _ = tune_block_b(tables[s:e], batch=tune_batch, n_in0=seg_in,
                              pipeline=plan.pipeline, budget=plan.budget)
        caps.append(cap)
        smem.append(K.fused_smem_bytes(seg_in, widths[s:e], cap,
                                       plan.pipeline))
    return dataclasses.replace(plan, block_b=tuple(caps),
                               smem_bytes=tuple(smem))


def make_network_fn(tables, fused: Optional[bool] = None,
                    block_b=None, n_in0: Optional[int] = None,
                    pipeline: bool = False,
                    plan: Optional[SegmentPlan] = None,
                    budget: Optional[int] = None,
                    device: DeviceLike = None, mesh=None,
                    tune_batch: int = 2048) -> Callable:
    """Close over a network once and return ``fn(codes) -> out_codes``
    for serving, on ``device`` (the CUDA card unless one is named; the
    tables are moved there).  ``fused=None`` lets ``plan_segments``
    choose; ``fused=True`` / ``False`` force the whole-network fused /
    per-layer engines.  ``pipeline=True`` selects the persistent
    double-buffered fused kernel.  ``block_b`` caps the rows per block
    (default: the ledger's cap); each call picks its rows from its batch
    within the cap.  ``block_b="auto"`` runs ``tune_block_b`` for each
    fused segment on a probe batch of ``tune_batch`` rows.  The plan
    rides on the callable as ``fn.execution_plan``.

    ``mesh`` serves the batch split over the mesh
    (``ShardedEngine``: the tables replicated on each of its devices,
    one shard an entry); the result lands on its first entry's device,
    which is ``fn.device``.  With a mesh, ``device`` may only name that
    device, and the tuner probes at the batch each shard gets
    (``tune_batch`` // shards).

    ``tables`` may be a loaded ``repro_torch.artifact`` bundle: its
    manifest's input width feeds the planner.  Its ``execution_plan``
    (a plan for the reference's TPU kernels) is ignored."""
    if mesh is not None:
        dev = mesh.device_list[0]
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"entry {dev}")
    else:
        dev = resolve_device(device)
    if hasattr(tables, "tables"):          # a loaded Artifact
        n_in0 = tables.n_in if n_in0 is None else n_in0
        tables = tables.tables
    tables = [t.to(dev) for t in tables]
    n_in0 = _infer_n_in0(tables, n_in0)
    budget = SMEM_BUDGET_BYTES if budget is None else int(budget)
    widths = [t.conn.shape[0] for t in tables]
    auto = isinstance(block_b, str)
    if auto and block_b != "auto":
        raise ValueError(f"block_b={block_b!r}: an int, None or 'auto'")
    probe = (max(1, tune_batch // _mesh_batch_shards(mesh))
             if mesh is not None else tune_batch)
    if plan is None:
        if fused is True:
            cap = (tune_block_b(tables, batch=probe, n_in0=n_in0,
                                pipeline=pipeline, budget=budget)[0]
                   if auto else block_b)
            plan = _fused_plan(n_in0, widths, cap, pipeline, budget)
        elif fused is False:
            plan = _per_layer_plan(n_in0, budget)
        else:
            plan = plan_segments(tables, block_b=None if auto else block_b,
                                 n_in0=n_in0, pipeline=pipeline,
                                 budget=budget)
            if auto and plan.mode != "per_layer":
                plan = _tune_plan(tables, plan, probe)
    fn = (ShardedEngine(tables, plan, mesh) if mesh is not None
          else _compile_plan(tables, plan))
    fn.execution_plan = plan
    fn.device = dev
    return fn
