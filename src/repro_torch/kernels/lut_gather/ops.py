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

All paths match ``repro_torch.core.lut_synth.lut_forward`` and the
reference package bit for bit (tests/test_torch_lut.py; on the card,
chip_smoke.py).  On CPU tensors every path runs the kernels' plain
versions.

Not yet ported: ``tune_block_b`` (each launch picks its rows per block
from the batch, within the shared-memory ledger's cap:
``lut_gather.fused_geometry``) and ``lut_network_fused_sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

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


def make_network_fn(tables, fused: Optional[bool] = None,
                    block_b: Optional[int] = None,
                    n_in0: Optional[int] = None, pipeline: bool = False,
                    plan: Optional[SegmentPlan] = None,
                    budget: Optional[int] = None,
                    device: DeviceLike = None) -> Callable:
    """Close over a network once and return ``fn(codes) -> out_codes``
    for serving, on ``device`` (the CUDA card unless one is named; the
    tables are moved there).  ``fused=None`` lets ``plan_segments``
    choose; ``fused=True`` / ``False`` force the whole-network fused /
    per-layer engines.  ``pipeline=True`` selects the persistent
    double-buffered fused kernel.  ``block_b`` caps the rows per block
    (default: the ledger's cap); each call picks its rows from its batch
    within the cap.  The plan rides on the callable as
    ``fn.execution_plan``.

    ``tables`` may be a loaded ``repro_torch.artifact`` bundle: its
    manifest's input width feeds the planner.  Its ``execution_plan``
    (a plan for the reference's TPU kernels) is ignored."""
    dev = resolve_device(device)
    if hasattr(tables, "tables"):          # a loaded Artifact
        n_in0 = tables.n_in if n_in0 is None else n_in0
        tables = tables.tables
    tables = [t.to(dev) for t in tables]
    n_in0 = _infer_n_in0(tables, n_in0)
    budget = SMEM_BUDGET_BYTES if budget is None else int(budget)
    widths = [t.conn.shape[0] for t in tables]
    if plan is None:
        if fused is True:
            rows = (K.block_rows(n_in0, widths, pipeline, budget)
                    if block_b is None else int(block_b))
            smem = K.fused_smem_bytes(n_in0, widths, rows, pipeline)
            if rows < 1 or smem > budget:
                raise ValueError(
                    f"the whole network does not fit one block's shared "
                    f"memory ({smem} > {budget} bytes); use fused=None")
            plan = SegmentPlan(
                mode="fused", bounds=((0, len(tables)),), block_b=(rows,),
                smem_bytes=(smem,), cut_widths=(),
                seg_widths=((n_in0, widths[-1]),), n_in0=n_in0,
                budget=budget, pipeline=pipeline)
        elif fused is False:
            plan = _per_layer_plan(n_in0, budget)
        else:
            plan = plan_segments(tables, block_b=block_b, n_in0=n_in0,
                                 pipeline=pipeline, budget=budget)
    fn = _compile_plan(tables, plan)
    fn.execution_plan = plan
    fn.device = dev
    return fn
