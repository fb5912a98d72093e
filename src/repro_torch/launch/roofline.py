"""Roofline terms of a dry-run cell (port of ``repro.launch.roofline``).

Three terms, in seconds, per chip, against the NVIDIA H100 SXM's
datasheet figures (the reference's are a TPU v5e's):

    compute    = FLOPs_per_chip            / PEAK_FLOPS   (989 TFLOP/s bf16)
    memory     = bytes_per_chip            / HBM_BW       (3.35 TB/s)
    collective = collective_wire_bytes     / LINK_BW      (900 GB/s NVLink)

The reference reads its FLOPs and bytes from XLA's cost analysis of the
compiled program and parses the optimised HLO for its collectives.  The
port has no HLO: ``launch/dryrun.py`` counts the step's operators as
they run on ``meta`` tensors, and ``model_collectives`` derives the
collectives from the cell's shardings by the stated cost model below.
Both are models, not measurements; the compute term counts matrix
products only (``torch.utils.flop_counter``), where XLA also counts
elementwise work, so it is a lower bound of the reference's.

Collective model (per chip; result bytes are the op's per-chip result
shape, wire bytes the ring-algorithm factor of ``_wire_factor`` times
that over the op's group).  One line an op:

* train, every parameter leaf replicated over data axes of total size
  G > 1: its gradient's all-reduce over them (result: the leaf's shard),
  or, where ZeRO-1 shards its optimizer moments over those axes, a
  reduce-scatter (result: shard / G) plus the all-gather of the updated
  leaf (result: the shard);
* train, every parameter leaf sharded over data axes of size F (FSDP):
  its all-gather in the forward pass and again in the backward pass
  (result: shard x F), and its gradient's reduce-scatter (result: the
  shard);
* every layer whose output projection (``wo``, ``w_out``, ``w_o``,
  ``cm_v``) is split over ``model`` on its contracted dim (tensor
  parallelism): an all-reduce of the layer's (tokens on a chip, d_model)
  output in the model's dtype over ``model``, twice in training (the
  backward pass's all-reduce of the input gradient);
* every MoE layer whose experts are split over ``model``: the
  expert-parallel dispatch's psum of its (T_loc, d_model) output over
  ``model`` (an all-reduce), twice in training.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, Iterable, List, Tuple

# NVIDIA H100 SXM datasheet (dense rates, no sparsity, at 700 W)
PEAK_FLOPS = 989e12        # bf16 FLOP/s per chip
HBM_BW = 3.35e12           # bytes/s per chip
LINK_BW = 900e9            # bytes/s per chip, NVLink
HBM_GB = 80.0              # HBM capacity (for fit reporting)
DEVICE = "H100 SXM (datasheet constants)"

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_type: Dict[str, float]     # summed result-shape bytes (per chip)
    wire_bytes_by_type: Dict[str, float]  # modeled ring wire bytes per chip
    total_bytes: float
    total_wire_bytes: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _wire_factor(op: str, group: int) -> float:
    """Ring-algorithm bytes-on-wire per chip, as a multiple of the
    op's result-shape bytes (the per-chip shard)."""
    g = max(group, 2)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g        # reduce-scatter + all-gather
    if op == "all-gather":
        return (g - 1) / g              # result is the gathered tensor
    if op == "reduce-scatter":
        return float(g - 1)             # result is the scattered shard
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


def collective_stats(ops: Iterable[Tuple[str, float, int]]
                     ) -> CollectiveStats:
    """(op, result bytes per chip, group size) rows -> the totals."""
    counts = {op: 0 for op in COLLECTIVE_OPS}
    by_type = {op: 0.0 for op in COLLECTIVE_OPS}
    wire = {op: 0.0 for op in COLLECTIVE_OPS}
    for op, nbytes, group in ops:
        if group <= 1 or nbytes <= 0:
            continue
        counts[op] += 1
        by_type[op] += nbytes
        wire[op] += nbytes * _wire_factor(op, group)
    return CollectiveStats(
        counts=counts, bytes_by_type=by_type, wire_bytes_by_type=wire,
        total_bytes=sum(by_type.values()),
        total_wire_bytes=sum(wire.values()))


# output projections whose contracted dim a tensor-parallel layout splits
_ROW_PARALLEL = re.compile(r"(^|/)(attn/wo|ffn/w_out|rglru/w_out|rwkv/w_o|"
                           r"rwkv/cm_v|shared/w_out|self_attn/wo|"
                           r"cross_attn/wo)$")
_EXPERTS_OUT = re.compile(r"(^|/)experts/w_out$")


def _axes(names) -> Tuple[str, ...]:
    if names is None:
        return ()
    return names if isinstance(names, tuple) else (names,)


def _size(sizes: Dict[str, int], axes: Iterable[str]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def model_collectives(kind: str, params: List[Tuple[str, object]],
                      moments: Dict[str, object], sizes: Dict[str, int],
                      tokens: Callable[[str], int], act_bytes: int
                      ) -> CollectiveStats:
    """The collective model of the module docstring for one cell.

    ``params``: (path, leaf) of every parameter, each leaf a
    ``ShapeDtypeStruct`` with its sharding, in the reference's layout
    (a stacked leaf's leading dim counts its layers); ``moments``: path
    -> the sharding of its AdamW first moment (train); ``sizes``: the
    mesh's axis sizes; ``tokens(path)``: the tokens a chip runs through
    the layer of that path; ``act_bytes``: bytes of one activation
    element."""
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    model = sizes.get("model", 1)
    train = kind == "train"
    ops: List[Tuple[str, float, int]] = []
    for path, leaf in params:
        spec = list(leaf.sharding.spec) if leaf.sharding is not None else []
        used = {a for e in spec for a in _axes(e)}
        shard = leaf.nbytes / _size(sizes, used)
        if train:
            repl = [a for a in data_axes if a not in used]
            G = _size(sizes, repl)
            mom = moments.get(path)
            mom_axes = ({a for e in mom.spec for a in _axes(e)}
                        if mom is not None else set())
            if G > 1 and set(repl) <= mom_axes:
                ops += [("reduce-scatter", shard / G, G),
                        ("all-gather", shard, G)]
            elif G > 1:
                ops.append(("all-reduce", shard, G))
            F = _size(sizes, [a for a in data_axes if a in used])
            if F > 1:
                ops += [("all-gather", shard * F, F)] * 2
                ops.append(("reduce-scatter", shard, F))
        stacked = re.search(r"(^|/)stacks/", path) is not None
        layers = leaf.shape[0] if stacked else 1
        math = spec[1:] if stacked else spec
        first = _axes(math[0]) if math else ()
        row = _ROW_PARALLEL.search(path) and "model" in first
        ep = _EXPERTS_OUT.search(path) and "model" in first
        if model > 1 and (row or ep):
            out = tokens(path) * leaf.shape[-1] * act_bytes
            ops += [("all-reduce", out, model)] * (layers * (2 if train
                                                            else 1))
    return collective_stats(ops)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    chips: int
    useful_ratio: float         # MODEL_FLOPS / (counted FLOPs * chips)
    roofline_fraction: float    # best-possible time / bound time

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll: CollectiveStats, chips: int,
                   model_flops_global: float) -> Roofline:
    compute_s = flops_per_chip / PEAK_FLOPS
    memory_s = bytes_per_chip / HBM_BW
    collective_s = coll.total_wire_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    counted_global = flops_per_chip * chips
    useful = model_flops_global / counted_global if counted_global else 0.0
    # roofline fraction: time the USEFUL flops would take at peak vs the
    # bound (max of the three terms)
    ideal_s = model_flops_global / (chips * PEAK_FLOPS)
    bound_s = max(terms.values())
    frac = ideal_s / bound_s if bound_s > 0 else 0.0
    return Roofline(
        flops_per_chip=flops_per_chip, bytes_per_chip=bytes_per_chip,
        coll_bytes_per_chip=coll.total_bytes,
        coll_wire_bytes_per_chip=coll.total_wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_global=model_flops_global,
        chips=chips, useful_ratio=useful, roofline_fraction=frac)


def summarize_cell(record: Dict) -> str:
    r = record["roofline"]
    return (f"{record['arch']:>22s} x {record['shape']:<12s} "
            f"[{record['mesh']}] "
            f"comp={r['compute_s']*1e3:9.3f}ms "
            f"mem={r['memory_s']*1e3:9.3f}ms "
            f"coll={r['collective_s']*1e3:9.3f}ms "
            f"dom={r['dominant']:<10s} "
            f"useful={r['useful_ratio']:6.1%} "
            f"roofline={r['roofline_fraction']:6.1%}")


def load_records(paths: List[str]) -> List[Dict]:
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out
