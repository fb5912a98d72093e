"""Dry-run cost pass: every (arch x shape x mesh) cell, without hardware
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA over 256 or 512
placeholder devices and reads ``memory_analysis()``, ``cost_analysis()``
and the HLO's collectives.  The port has no compiler to ask: it runs
the cell's step (``models.registry.dryrun_cell``) eagerly on ``meta``
tensors (shapes and dtypes, no storage, no device), over a mesh of meta
entries (``launch.mesh.placeholder_devices``), and counts what runs:

* FLOPs: the formulas of ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products only; XLA also counts elementwise work, so the
  compute term is a lower bound of the reference's);
* bytes: ``CostCounter``, a ``TorchDispatchMode`` summing each
  operator's input and output bytes (views move none; a fresh buffer
  that no split tensor feeds is charged at its first use, split as that
  use is), the port's counterpart of XLA's "bytes accessed";
* peak activation bytes: the same mode's live op outputs (by storage);
* per chip: each operator's counts divided by the sizes of the mesh
  axes its operands are split over.  Inputs carry their specs dim by
  dim; an output's dims carry the axes of the input dims they come from
  (views by strides; ``mm``/``bmm`` by their index map, where a split
  contracted dim leaves the output whole, as after an all-reduce,
  unless its axis also splits an output dim, as FSDP's weights' does;
  gathers by their indices, or, where the indices are whole and the
  rows split, as their rows; rows put by split indices as those; a
  select's gradient as the gradient it widens; elementwise ops and reductions by aligned dims).  Where a
  rule fell back to replication (qwen1.5's 40 heads on a 16-wide
  ``model`` axis) the work counts in full on every chip and
  ``useful_ratio`` shows the waste;
* memory: the sharded state an entry holds (parameters, moments, cache,
  batch) plus the activation peak split over the data axes where the
  batch splits over them;
* collectives: ``roofline.model_collectives``, a stated model of the
  cell's shardings.

Eager counting sees every layer, so no depth extrapolation is needed
(``cost_method: "meta-direct"``); ``--exact`` is accepted and changes
nothing, and the record says so.  No card and no compiler is needed:
the pass runs the same on a CPU-only machine and beside an H100.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --driver --out runs/dryrun   # all cells
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (make_mesh, mesh_chip_count,
                                     placeholder_devices,
                                     host_device_count_needed)
from repro_torch.models import registry as R
from repro_torch.parallel import sharding as SH

_NONE = frozenset()
_aten = torch.ops.aten
# mm-class operators: (index of the first matrix operand, its dims)
# operators that make a buffer without reading one
_FILLS = frozenset((_aten.new_zeros, _aten.new_empty, _aten.new_full,
                    _aten.new_ones, _aten.new_empty_strided,
                    _aten.zeros_like, _aten.empty_like, _aten.ones_like,
                    _aten.full_like, _aten.zeros, _aten.empty, _aten.ones,
                    _aten.full, _aten.empty_strided))
_MM = {_aten.mm.default: (0, 2), _aten.addmm.default: (1, 2),
       _aten.bmm.default: (0, 3), _aten.baddbmm.default: (1, 3)}


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: List) -> List:
    """The tensors of an operator's arguments or results (nested in
    lists, tuples and dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


class CostCounter(TorchDispatchMode):
    """Counts every operator that runs under it: FLOPs (the formulas of
    ``torch.utils.flop_counter.FlopCounterMode``), bytes (inputs read and
    outputs written; views none) and live output bytes, in total and per
    chip of a mesh of ``sizes`` (axis -> size).  Each storage's dims
    carry the mesh axes that split them (module docstring); ``place``
    gives an input its spec."""

    def __init__(self, sizes: Dict[str, int]):
        super().__init__()
        self.sizes = dict(sizes)
        self._dims: Dict[int, List] = {}     # storage -> [(stride, size, axes)]
        self._memo: Dict[int, Dict] = {}     # storage -> {(stride, shape): axes}
        self._ops: Dict = {}                 # operator -> (view?, flops, name)
        self._pending: Dict[int, tuple] = {}  # storage -> (bytes, name)
        self.flops = self.flops_chip = 0.0
        self.bytes = self.bytes_chip = 0.0
        self.live = self.peak = 0
        self.by_op: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0, 0.0, 0.0])           # name -> [count, flops, bytes]

    # -- dims of a tensor -------------------------------------------------
    def place(self, t: torch.Tensor, spec) -> None:
        """Give an input tensor its ``PartitionSpec`` (None: whole)."""
        entries = list(spec or ()) + [None] * t.dim()
        self._record(t, [frozenset(n if isinstance(n, tuple) else (n,))
                         if n is not None else _NONE
                         for n in entries[:t.dim()]])

    def _record(self, t: torch.Tensor, axes: List[frozenset]) -> None:
        key = _key(t)
        self._memo.pop(key, None)
        if any(axes):
            self._dims[key] = [(st, sz, ax) for st, sz, ax in zip(
                t.stride(), t.shape, axes)]
        else:
            self._dims.pop(key, None)

    def axes(self, t: torch.Tensor) -> List[frozenset]:
        """The mesh axes splitting each dim of ``t``: its storage's dims
        mapped by strides (a split dim's axes go to the outermost dim
        cut from it, a merged dim takes the axes of what it covers)."""
        key = _key(t)
        base = self._dims.get(key)
        if base is None:
            return [_NONE] * t.dim()
        memo = self._memo.setdefault(key, {})
        geo = (t.stride(), t.shape)
        hit = memo.get(geo)
        if hit is not None:
            return hit
        out = [set() for _ in range(t.dim())]
        dims = [(st, sz, d) for d, (st, sz) in enumerate(zip(*geo))
                if sz > 1 and st > 0]
        for bst, bsz, ax in base:
            if not ax or bsz <= 1 or bst <= 0:
                continue
            inner = [(st, d) for st, sz, d in dims
                     if bst <= st < bst * bsz]
            if inner:
                out[max(inner)[1]] |= ax
                continue
            for st, sz, d in dims:
                if st <= bst < st * sz:
                    out[d] |= ax
                    break
        memo[geo] = hit = [frozenset(a) for a in out]
        return hit

    # -- output dims of an operator -----------------------------------------
    def _out_axes(self, func, args, kwargs, ins, in_axes, outs):
        """The axes of each output's dims, and those of a contracted dim
        (which split the work, not the result)."""
        if func in _MM:
            first, nd = _MM[func]
            a, b = self.axes(args[first]), self.axes(args[first + 1])
            lead = [a[0] | b[0]] if nd == 3 else []
            dims = lead + [a[-2], b[-1]]
            # an axis splitting an output dim too (FSDP's data axis on a
            # weight's contracted dim, the tokens' on their rows) splits
            # that dim: the weight is gathered, not the product reduced
            contr = (a[-1] | b[-2]) - frozenset().union(*dims)
            return [[x - contr for x in dims]], contr
        if func is _aten.embedding.default:
            w, idx = args[0], args[1]
            return [self.axes(idx) + [self.axes(w)[-1]]], _NONE
        if func is _aten.index.Tensor:
            src, idx = args[0], args[1]
            if idx and all(i is not None for i in idx):
                lead = _broadcast(outs[0].dim() - src.dim() + len(idx),
                                  [(i, self.axes(i)) for i in idx])
                rows = frozenset().union(*self.axes(src)[:len(idx)])
                if lead and not any(lead) and rows:
                    # unsplit indices into split rows (the MoE dispatch's
                    # slots, from a sort over every token): the gathered
                    # rows lie as their source's
                    lead[-1] = rows
                return [lead + self.axes(src)[len(idx):]], _NONE
        if func is _aten.index_put.default:
            # rows written by split indices (a gather's gradient, the MoE
            # combine's into its slots) lie as those indices
            dst, idx, vals = args[0], args[1], args[2]
            if idx and all(i is not None for i in idx):
                out = list(self.axes(dst))
                out[0] = out[0].union(*(a for i in idx
                                        for a in self.axes(i)))
                va = self.axes(vals)
                for j in range(1, min(len(out) - len(idx), vals.dim()) + 1):
                    if vals.shape[-j] == dst.shape[-j]:
                        out[-j] = out[-j] | va[-j]
                return [out], _NONE
        if func is _aten.gather.default:
            return [self.axes(args[2])], _NONE
        if func is _aten.select_backward.default:
            # the grad of a select: its dims with the selected one put back
            ax = self.axes(args[0])
            dim = args[2] % (len(ax) + 1)
            return [ax[:dim] + [_NONE] + ax[dim:]], _NONE
        if func is _aten.stack.default:
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            ax = self.axes(args[0][0])
            dim = dim % (len(ax) + 1)
            return [ax[:dim] + [_NONE] + ax[dim:]], _NONE
        items = list(zip(ins, in_axes))
        return [_generic(o, items) for o in outs], _NONE

    # -- the mode -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = (
                any(r.alias_info is not None for r in func._schema.returns),
                flop_registry.get(func._overloadpacket),
                str(func._overloadpacket))
        view, flop_fn, name = info
        if view:                       # a view moves nothing
            return out
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs, ins)
        outs = _tensors(out, [])
        in_axes = [self.axes(t) for t in ins]
        used = set()
        for ax in in_axes:
            for a in ax:
                used |= a
        in_keys = {_key(t) for t in ins}
        fresh = [o for o in outs if _key(o) not in in_keys]
        if used and fresh:
            out_axes, contr = self._out_axes(func, args, kwargs, ins,
                                             in_axes, outs)
            for o, ax in zip(outs, out_axes):
                if _key(o) not in in_keys:
                    self._record(o, ax)
        else:
            for o in fresh:
                self._record(o, [])
        for o in fresh:
            self._alloc(o)
        split = 1
        for a in used:
            split *= self.sizes.get(a, 1)
        for t in ins:
            if _key(t) in self._pending:
                self._charge(*self._pending.pop(_key(t)), split)
        if not used and func._overloadpacket in _FILLS:
            # a fresh buffer no split tensor feeds (the zeros a gather's
            # gradient scatters into): its fill is charged at its first
            # use, split as that use is
            for o in fresh:
                self._pending[_key(o)] = (_nbytes(o), name)
            self.bytes += sum(_nbytes(o) for o in fresh)
            self.by_op[name][0] += 1
            return out
        fl = flop_fn(*args, **kwargs, out_val=out) if flop_fn else 0
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
        self.flops += fl
        self.flops_chip += fl / split
        self.bytes += nb
        self.bytes_chip += nb / split
        row = self.by_op[name]
        row[0] += 1
        row[1] += fl / split
        row[2] += nb / split
        return out

    def _alloc(self, o: torch.Tensor) -> None:
        st = o.untyped_storage()
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, _key(o), n)

    def _charge(self, nb: float, name: str, split: int) -> None:
        self.bytes_chip += nb / split
        self.by_op[name][2] += nb / split

    def settle(self) -> None:
        """Charge whole the fills no operator used."""
        for key in list(self._pending):
            self._charge(*self._pending.pop(key), 1)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._dims.pop(key, None)
        self._memo.pop(key, None)
        if key in self._pending:
            self._charge(*self._pending.pop(key), 1)


def _broadcast(ndim: int, items) -> List[frozenset]:
    """Right-aligned union of the axes of ``items`` ((tensor, axes)), the
    index tensors of a gather, over their broadcast of ``ndim`` dims."""
    out = [set() for _ in range(ndim)]
    for t, ax in items:
        for j in range(1, min(t.dim(), ndim) + 1):
            if t.shape[-j] > 1:
                out[-j] |= ax[-j]
    return [frozenset(a) for a in out]


def _generic(o: torch.Tensor, items) -> List[frozenset]:
    """An output's axes from its inputs: right-aligned dims of equal size
    (elementwise ops, broadcasts, ``cat`` off its dim); an input with
    more dims (a reduction) maps its dims onto the output's in order
    where the sizes agree."""
    out = [set() for _ in range(o.dim())]
    for t, ax in items:
        if t.dim() <= o.dim():
            for j in range(1, t.dim() + 1):
                if t.shape[-j] == o.shape[-j] and t.shape[-j] > 1:
                    out[-j] |= ax[-j]
        else:
            d = 0
            for i in range(t.dim()):
                if d < o.dim() and t.shape[i] == o.shape[d]:
                    if t.shape[i] > 1:
                        out[d] |= ax[i]
                    d += 1
    return [frozenset(a) for a in out]


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _spec(leaf):
    sh = getattr(leaf, "sharding", None)
    return sh.spec if sh is not None else None


def _split(spec, sizes: Dict[str, int]) -> int:
    n = 1
    for e in spec or ():
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n *= sizes[a]
    return n


def _leaves_with_paths(tree) -> List:
    out = []
    SH.tree_map_with_path(lambda p, leaf: out.append(("/".join(p), leaf)),
                          tree)
    return out


def _tokens_fn(meta: Dict, cfg, sizes: Dict[str, int]):
    """Tokens a chip runs through the layer at a parameter path."""
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    B, S = meta["global_batch"], meta["seq_len"]
    b = B // dp if B % dp == 0 else B
    kind = meta["kind"]
    if not R.is_encdec(cfg):
        return lambda path: b * (1 if kind == "decode" else S)
    T = min(cfg.max_target, S)
    enc = {"train": S, "prefill": S, "decode": 0}[kind]
    dec = {"train": T, "prefill": 0, "decode": 1}[kind]
    return lambda path: b * (enc if path.startswith("enc/") else dec)


def run_cell(arch: str, shape: str, mesh_spec: str = "single",
             smoke: bool = False, fsdp: Optional[bool] = None,
             remat: bool = True, seq_on_model: bool = False,
             save_hlo: Optional[str] = None,
             exact: bool = False, accum: int = 1,
             overrides: Optional[Dict] = None,
             top_ops: bool = False) -> Dict:
    """Run one cell's step on ``meta`` tensors over a placeholder mesh and
    return its JSON-able record (the reference's keys).  The step runs
    under the mesh, as the reference compiles it, so ``moe_ep`` takes
    the expert-parallel dispatch.  ``exact`` changes nothing here (no
    depth to extrapolate); ``save_hlo`` writes the counted operators
    (there is no HLO), ``top_ops`` prints them by bytes."""
    t0 = time.time()
    mesh = make_mesh(mesh_spec, devices=placeholder_devices(
        host_device_count_needed(mesh_spec)))
    chips = mesh_chip_count(mesh)
    sizes = dict(mesh.shape)
    fn, args, meta = R.dryrun_cell(arch, shape, mesh=mesh, smoke=smoke,
                                   fsdp=fsdp, remat=remat,
                                   seq_on_model=seq_on_model, accum=accum,
                                   overrides=overrides)
    cfg = R.get_config(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    specs = [leaf for _, leaf in _leaves_with_paths(args)]
    tensors = R.materialize(args)
    counter = CostCounter(sizes)
    for (_, t), leaf in zip(_leaves_with_paths(tensors), specs):
        counter.place(t, _spec(leaf))
    state_bytes = sum(leaf.nbytes / _split(_spec(leaf), sizes)
                      for leaf in specs)
    opt_einsum = torch.backends.opt_einsum.enabled
    # two-operand einsums need no path search, which is most of an
    # einsum's host time on meta tensors
    torch.backends.opt_einsum.enabled = False
    t_run = time.time()
    try:
        with mesh, counter:
            out = fn(*tensors)
            del out
    finally:
        torch.backends.opt_einsum.enabled = opt_einsum
    counter.settle()
    t_main = time.time() - t_run

    if save_hlo:
        with open(save_hlo, "w") as f:
            for name, (n, fl, nb) in sorted(counter.by_op.items()):
                f.write(f"{name}\t{n}\t{fl:.6e}\t{nb:.6e}\n")
    if top_ops:
        print("top operators by bytes (per chip):")
        for name, (n, fl, nb) in sorted(counter.by_op.items(),
                                        key=lambda kv: -kv[1][2])[:15]:
            print(f"  {name:<36s} {nb / 1e9:10.2f} GB  x{n}")

    dp = 1
    for a in SH.dp_axes(mesh):
        dp *= sizes[a]
    # the batch splits over the data axes, or lies whole (batch_specs)
    act = counter.peak / (dp if meta["global_batch"] % dp == 0 else 1)
    mem_rec = {"state_bytes_per_device": state_bytes,
               "activation_peak_bytes_per_device": act,
               "peak_bytes_per_device": state_bytes + act}
    mem_rec["fits_hbm_80g"] = mem_rec["peak_bytes_per_device"] \
        <= RL.HBM_GB * 1e9

    kind = meta["kind"]
    first = args[0]
    params = first["params"] if kind == "train" else first
    moments = {}
    if kind == "train":
        moments = dict(_leaves_with_paths(
            SH.tree_map_with_path(lambda _, l: l.sharding,
                                  first["opt"].mu)))
    act_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    coll = RL.model_collectives(kind, _leaves_with_paths(params), moments,
                                sizes, _tokens_fn(meta, cfg, sizes),
                                act_bytes)
    roof = RL.roofline_terms(counter.flops_chip, counter.bytes_chip, coll,
                             chips, meta["model_flops"])
    return {
        "arch": arch, "shape": shape, "mesh": mesh_spec, "chips": chips,
        "smoke": smoke, "remat": remat, "fsdp": meta["fsdp"],
        "seq_on_model": seq_on_model, "cost_method": "meta-direct",
        "exact": exact, "exact_note": "no-op: eager counting sees every "
        "layer", "accum": accum, "overrides": overrides or {},
        "device": RL.DEVICE, "notes": meta["notes"],
        "params_total": meta["params_total"],
        "params_active": meta["params_active"],
        "model_flops": meta["model_flops"],
        "memory": mem_rec,
        "cost": {"flops_per_chip": counter.flops_chip,
                 "bytes_per_chip": counter.bytes_chip,
                 "flops_global": counter.flops,
                 "bytes_global": counter.bytes},
        "collectives": coll.to_dict(),
        "roofline": roof.to_dict(),
        "timing": {"total_s": round(time.time() - t0, 2),
                   "main_compile_s": round(t_main, 2)},
        "status": "ok",
    }


def all_cells(include_skipped: bool = False):
    for arch in R.ARCHS:
        for shape in R.SHAPES:
            reason = R.cell_is_skipped(arch, shape)
            if reason and not include_skipped:
                yield arch, shape, reason
            else:
                yield arch, shape, None


def _chunk_loop(arch: str) -> bool:
    cfg = R.get_config(arch)
    return not R.is_encdec(cfg) and any(m == "rwkv" for m, _ in cfg.kinds)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _run_one(cmd: List[str], timeout_s: int):
    """(ok, stderr, seconds) of one cell's process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_package_root()] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                             else []))
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env)
        return r.returncode == 0, r.stderr, time.time() - t0
    except subprocess.TimeoutExpired:
        return False, "timeout", time.time() - t0


def driver(out_dir: str, mesh_specs: Sequence[str], smoke: bool,
           force: bool, timeout_s: int = 3600, jobs: int = 1) -> int:
    """Run every cell in a fresh subprocess (one bad cell cannot take
    down the sweep), ``jobs`` at a time; returns the failures."""
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for mesh_spec in mesh_specs:
        for arch, shape, skip_reason in all_cells():
            name = f"{arch}__{shape}__{mesh_spec}".replace("/", "_")
            path = os.path.join(out_dir, name + ".json")
            if skip_reason:
                rec = {"arch": arch, "shape": shape, "mesh": mesh_spec,
                       "status": "skipped", "reason": skip_reason}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"SKIP {name}: {skip_reason}")
                continue
            if os.path.exists(path) and not force:
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"CACHED {name}")
                        continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_spec,
                   "--out", path] + (["--smoke"] if smoke else [])
            todo.append((name, path, arch, shape, mesh_spec, cmd))
    # longest first, so the slowest cells start while the rest share the
    # other processes: a step over more tokens counts more operators,
    # and an RWKV step loops over its sequence in chunks
    todo.sort(key=lambda c: (_chunk_loop(c[2]), R.SHAPES[c[3]].seq_len
                             * R.SHAPES[c[3]].global_batch), reverse=True)
    failures = 0
    with concurrent.futures.ThreadPoolExecutor(max(1, jobs)) as pool:
        futs = {pool.submit(_run_one, c[-1], timeout_s): c for c in todo}
        for fut in concurrent.futures.as_completed(futs):
            name, path, arch, shape, mesh_spec, _ = futs[fut]
            ok, err, secs = fut.result()
            if not ok:
                failures += 1
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "mesh": mesh_spec, "status": "failed",
                               "error": err[-2000:]}, f, indent=1)
                print(f"FAIL {name} ({secs:.0f}s): {err[-300:]}")
            else:
                print(f"OK   {name} ({secs:.0f}s)")
    return failures


def _parse_overrides(items: Iterable[str]) -> Dict:
    overrides = {}
    for kv in items:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                overrides[k] = {"true": True, "false": False}.get(v, v)
    return overrides


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single | multi | NxM | PxNxM")
    ap.add_argument("--out", default=None, help="JSON output path/dir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--seq-on-model", action="store_true",
                    help="sequence-parallel activations")
    ap.add_argument("--fsdp", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--save-hlo", default=None,
                    help="write the counted operators (no HLO here)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--override", action="append", default=[],
                    help="config field override key=value (repeatable)")
    ap.add_argument("--top-ops", action="store_true",
                    help="print the top operators by bytes")
    ap.add_argument("--exact", action="store_true",
                    help="accepted for the reference's CLI; the count is "
                         "already of every layer")
    ap.add_argument("--driver", action="store_true",
                    help="run ALL cells x {single,multi} via subprocesses")
    ap.add_argument("--jobs", type=int, default=1,
                    help="driver: cells run at once")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.driver:
        out = args.out or "runs/dryrun"
        n_fail = driver(out, ["single", "multi"], args.smoke, args.force,
                        jobs=args.jobs)
        sys.exit(1 if n_fail else 0)

    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    overrides = _parse_overrides(args.override)
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, smoke=args.smoke,
                       fsdp=fsdp, remat=not args.no_remat,
                       seq_on_model=args.seq_on_model,
                       save_hlo=args.save_hlo, exact=args.exact,
                       accum=args.accum, overrides=overrides or None,
                       top_ops=args.top_ops)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    print(RL.summarize_cell(rec))
    print(json.dumps({k: rec[k] for k in ("memory", "cost", "collectives",
                                          "timing")}, indent=1))
    if args.out:
        out = args.out
        if os.path.isdir(out):
            out = os.path.join(
                out, f"{args.arch}__{args.shape}__{args.mesh}.json")
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
