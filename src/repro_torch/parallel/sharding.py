"""Device meshes and sharding rules (port of ``repro.parallel.sharding``).

A ``Mesh`` names the axes of an array of ``torch.device`` entries; each
entry is one shard, and a CUDA entry gets its own stream.  Entries may
repeat a device: a mesh of ``[cuda:0] * 4`` is four shards on one card,
the port's counterpart of the reference's virtual devices.  On one card
such a mesh checks that a sharded path is right; it does not scale,
since the shards share the card's SMs.  On the CPU,
``device.ensure_host_devices(n)`` lets the CPU stand as ``n`` entries.
A mesh of ``meta`` entries stands for devices that are not there (the
dry-run's 256 and 512 chips, ``launch/mesh.py``): it runs nothing and
has no streams.  A mesh does not mix CPU, CUDA and meta entries.

The rule tables map '/'-joined parameter paths (``stacks/0/attn/wq``)
to candidate ``PartitionSpec``s, exactly as the reference's do.  The
``model`` axis carries tensor and expert parallelism; ``data`` (and
``pod`` on multi-pod meshes) data parallelism, and the batch axes of
activations shard over ``("pod", "data")``.

* Every rule maps to a candidate list.  The first candidate whose
  sharded dims all divide the leaf's shape wins; if none applies, the
  first is taken with each dim that does not divide replicated.  So
  one table serves archs whose head counts do not divide the model
  axis (qwen1.5: 40 heads, rwkv6: 40, whisper: 6).
* Leaves under a scanned layer stack (``stacks/<i>/...``) carry a
  leading layer-group dim; the spec is shifted right by one so rules
  address the math dims.
* The MoE expert dim rides ``model``; with ``fsdp=True`` the next dim
  also shards over the data axes (ZeRO-3).

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes; ``make_shardings`` walks the port's trees (dicts, lists,
tuples, named tuples and dataclasses, as ``optim.adamw.tree_map`` does)
with the reference's paths.  Which paths consume them:
``core.lutdnn.search_connectivity_population(mesh=)`` splits a
population by ``lutdnn_population_rules``, ``data.loader`` splits
batches by ``data_sharding``, and the batch-sharded LUT engine
(``kernels.lut_gather.ops.lut_network_fused_sharded``) splits over every
axis but ``model``, ``device_put`` lays a tensor out over a mesh (the
checkpoint's elastic restore), and ``attach`` pairs an abstract tree
(``ShapeDtypeStruct`` leaves) with its shardings for the dry-run cost
pass (``models.registry``).  The port's LM steps take whole tensors:
only the expert-parallel MoE dispatch (``models.layers.moe_apply_ep``)
runs over a mesh's entries.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import host_devices, resolve_device


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names (the
    dim split over their product, the first outermost), or None
    (replicated).  A one-name tuple is kept as the bare name, as the
    reference's ``PartitionSpec`` compares them."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec
Rule = Tuple[str, List[P]]
ShardingRules = List[Rule]


class Mesh:
    """Named axes over an array of devices.  ``shape`` maps each axis
    name to its size (in axis order); ``devices`` is the entries' array
    (numpy, dtype object), ``device_list`` the same in row-major order.
    ``with mesh:`` makes it the ``ambient_mesh()`` of this thread."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        flat = [_entry_device(d) for d in arr.flat]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh mixes device types {sorted(kinds)}: "
                             f"its entries are all CPU, all CUDA or all "
                             f"meta")
        arr.flat[:] = flat
        self.devices = arr
        self.device_list: List[torch.device] = flat
        self.shape: Dict[str, int] = collections.OrderedDict(
            zip(self.axis_names, arr.shape))
        self._streams: Dict[int, Any] = {}
        self._lock = threading.Lock()
        # what an engine replicates over this mesh (ops keeps it here)
        self.cache: "collections.OrderedDict" = collections.OrderedDict()

    @property
    def size(self) -> int:
        return len(self.device_list)

    @property
    def is_cuda(self) -> bool:
        return self.device_list[0].type == "cuda"

    def stream(self, entry: int):
        """The CUDA stream of entry ``entry`` (row-major index), made at
        first use; None for a CPU entry."""
        dev = self.device_list[entry]
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(entry)
            if s is None:
                s = self._streams[entry] = torch.cuda.Stream(device=dev)
            return s

    def shard_entries(self, axes: Union[str, Sequence[str], None]
                      ) -> List[int]:
        """The entries (row-major indices) that hold the shards of a dim
        split over ``axes`` (a name or names, the first outermost), at
        index 0 of every other axis: shard k is entry
        ``shard_entries(axes)[k]``.  No axes: the first entry alone."""
        names = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.axis_names}")
        sizes = [self.shape[a] for a in names]
        out = []
        for k in np.ndindex(*sizes) if names else [()]:
            idx = [0] * len(self.axis_names)
            for a, i in zip(names, k):
                idx[self.axis_names.index(a)] = i
            out.append(int(np.ravel_multi_index(idx, self.devices.shape)))
        return out

    def __enter__(self) -> "Mesh":
        _AMBIENT.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.device_list]})")


def _entry_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"a mesh takes CPU, CUDA or meta devices, not "
                         f"{dev}")
    return resolve_device(dev) if dev.type == "cuda" else dev


_AMBIENT = threading.local()


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` of this thread, or
    None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


class NamedSharding:
    """A mesh and a spec: how one tensor lies over the mesh."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"


# ---------------------------------------------------------------------------
# choosing a spec
# ---------------------------------------------------------------------------

def _as_candidates(spec: Union[P, List[P]]) -> List[P]:
    return spec if isinstance(spec, list) else [spec]


def specs_for(path: str, rules: ShardingRules) -> List[P]:
    for pat, spec in rules:
        if re.search(pat, path):
            return _as_candidates(spec)
    return [P()]  # replicate by default


def _axis_size(mesh, names) -> int:
    """Product of mesh-axis sizes; -1 if any axis is absent from the
    mesh (the candidate does not apply)."""
    tup = names if isinstance(names, tuple) else (names,)
    size = 1
    for n in tup:
        if n not in mesh.shape:
            return -1
        size *= mesh.shape[n]
    return size


def _fits(spec_entries: Sequence, shape: Sequence[int], mesh) -> bool:
    for dim, names in enumerate(spec_entries):
        if names is None:
            continue
        size = _axis_size(mesh, names)
        if size < 0 or dim >= len(shape) or shape[dim] % size != 0:
            return False
    return True


def _apply_with_fallback(spec_entries: Sequence, shape: Sequence[int],
                         mesh) -> P:
    fixed = []
    for dim in range(len(shape)):
        names = spec_entries[dim] if dim < len(spec_entries) else None
        size = _axis_size(mesh, names) if names is not None else -1
        if names is not None and size > 0 and shape[dim] % size == 0:
            fixed.append(names)
        else:
            fixed.append(None)
    return P(*fixed)


def choose_spec(path: str, shape: Sequence[int], mesh,
                rules: ShardingRules) -> P:
    """The first candidate of ``path``'s rule that fits ``shape``, else
    the first with each dim that does not divide replicated.  Leaves
    under ``stacks/<i>/`` get the spec shifted one dim right (the
    leading layer-group dim is never sharded)."""
    shift = 1 if re.search(r"(^|/)stacks/", path) else 0
    for cand in specs_for(path, rules):
        entries = [None] * shift + list(cand)
        entries = entries[: len(shape)]
        if _fits(entries, shape, mesh):
            return P(*entries)
    first = specs_for(path, rules)[0]
    entries = [None] * shift + list(first)
    return _apply_with_fallback(entries, shape, mesh)


def tree_map_with_path(fn, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree's leaves, rebuilding
    the tree: dicts by key, lists and tuples by index, named tuples and
    dataclasses by field name (the reference's key paths); None stays
    None.  ``path`` is the tuple of keys, ``"/".join`` of it the
    reference's path string."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return type(tree)(*[
                tree_map_with_path(fn, getattr(tree, f),
                                   *(getattr(r, f) for r in rest),
                                   path=path + (f,))
                for f in tree._fields])
        kids = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (str(i),))
                for i, v in enumerate(tree)]
        return type(tree)(kids)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       *(getattr(r, f.name) for r in rest),
                                       path=path + (f.name,))
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(path, tree, *rest)


class ShapeDtypeStruct:
    """An abstract tensor: its shape, dtype and (``attach``) sharding,
    with no storage; immutable, as the reference's.  Not a dataclass, so
    the tree walkers take it as a leaf."""

    __slots__ = ("shape", "dtype", "sharding")

    def __init__(self, shape, dtype: torch.dtype,
                 sharding: Optional[NamedSharding] = None):
        for k, v in (("shape", tuple(int(d) for d in shape)),
                     ("dtype", dtype), ("sharding", sharding)):
            object.__setattr__(self, k, v)

    def __setattr__(self, name, value):
        raise AttributeError("ShapeDtypeStruct is immutable")

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) \
            * torch.empty((), dtype=self.dtype).element_size()

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShapeDtypeStruct)
                and (self.shape, self.dtype, self.sharding)
                == (other.shape, other.dtype, other.sharding))

    def __hash__(self) -> int:
        return hash((self.shape, self.dtype, self.sharding))

    def __repr__(self) -> str:
        return (f"ShapeDtypeStruct(shape={self.shape}, dtype={self.dtype}"
                + (f", sharding={self.sharding!r}" if self.sharding else "")
                + ")")


def abstract(tree: Any) -> Any:
    """A tree of tensors (``meta`` ones, say) as ``ShapeDtypeStruct``
    leaves."""
    return tree_map_with_path(
        lambda _, t: ShapeDtypeStruct(t.shape, t.dtype), tree)


def attach(tree: Any, shardings: Any) -> Any:
    """An abstract tree and a matching tree of ``NamedSharding`` ->
    ``ShapeDtypeStruct`` leaves that carry their shardings."""
    return tree_map_with_path(
        lambda _, sds, sh: ShapeDtypeStruct(sds.shape, sds.dtype,
                                            sharding=sh), tree, shardings)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def make_shardings(tree: Any, mesh: Mesh, rules: ShardingRules) -> Any:
    """A tree of ``NamedSharding`` matching ``tree`` (of tensors, numpy
    arrays or anything with a ``shape``)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, choose_spec("/".join(path), _shape(leaf), mesh, rules)),
        tree)


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

_DP = ("pod", "data")   # entries absent from the mesh are dropped below


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _DP if a in mesh.axis_names)


def _dpa(mesh):
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _fsdp_variants(*entries) -> List[P]:
    """Expand a spec containing the sentinel 'DP' into candidates:
    ('pod','data') -> ('data',) -> unsharded, so FSDP degrades from
    multi-pod to single-pod to plain tensor parallelism."""
    outs = []
    for sub in (("pod", "data"), "data", None):
        outs.append(P(*[sub if e == "DP" else e for e in entries]))
    seen, uniq = set(), []
    for s in outs:
        if tuple(s) not in seen:
            seen.add(tuple(s))
            uniq.append(s)
    return uniq


def lm_rules(fsdp: bool = False, tied_embed: bool = True) -> ShardingRules:
    """The LM family's table.  ``fsdp=True`` also shards big matrices
    over the data axes (ZeRO-3).  ``tied_embed`` picks the embedding
    layout: vocab-sharded when the table is also the unembedding,
    d_model-sharded when it is not."""

    def fs(*entries) -> List[P]:
        if fsdp:
            return _fsdp_variants(*entries)
        return [P(*[None if e == "DP" else e for e in entries])]

    embed_rule = (fs("model", "DP") if tied_embed
                  else fs("DP", "model") + [P(None, "model")])

    return [
        # embeddings / head
        (r"embed/table", embed_rule),
        (r"head/w$", fs("DP", "model") + [P("model", None)]),
        # attention: heads on model, else replicated (never the head
        # dim: sharding the contraction of QK^T explodes collectives)
        (r"(wq)$", fs("DP", "model", None) + [P()]),
        (r"(wk|wv)$", fs("DP", "model", None) + [P()]),
        (r"wo$", fs("model", None, "DP") + [P()]),
        (r"(bq|bk|bv)$", [P("model", None), P()]),
        # dense FFN: column / row split (SparseLUT theta and sign leaves
        # shard as the dense matrices they replace)
        (r"(w_in|w_gate)(_theta|_sign)?$", fs("DP", "model") + [P()]),
        (r"w_out$", fs("model", "DP") + [P()]),
        # MoE: experts on model (+ FSDP over the data axes)
        (r"experts/(w_in|w_gate)$", fs("model", "DP", None) + [P()]),
        (r"experts/w_out$", fs("model", "DP", None) + [P()]),
        (r"router/w$", [P()]),
        (r"shared/(w_in|w_gate)$", fs("DP", "model") + [P()]),
        (r"shared/w_out$", fs("model", "DP") + [P()]),
        # RG-LRU: R on model everywhere
        (r"rglru/w_(x|y)$", fs("DP", "model") + [P()]),
        (r"rglru/conv_w$", [P(None, "model"), P()]),
        (r"rglru/w_(rgate|igate)$", [P(None, "model"), P()]),
        (r"rglru/lam$", [P("model"), P()]),
        (r"rglru/w_out$", fs("model", "DP") + [P()]),
        # RWKV6: channels on model; per-head leaves replicated
        (r"rwkv/w_(r|k|v|g)$", fs("DP", "model") + [P()]),
        (r"rwkv/w_o$", fs("model", "DP") + [P()]),
        (r"rwkv/decay_a$", [P(None, None)]),
        (r"rwkv/decay_b$", [P(None, None)]),
        (r"rwkv/cm_k$", fs("DP", "model") + [P()]),
        (r"rwkv/cm_v$", fs("model", "DP") + [P()]),
        (r"rwkv/cm_r$", fs("DP", "model") + [P()]),
        # encoder-decoder extras
        (r"pos_(enc|dec)$", [P(None, None)]),
        (r"(ffn|attn)/b$", [P()]),
        # norms / small vectors: replicated
        (r"(scale|bias|gamma|beta|mean|var|norm|mu$|lam$|u$|w0$)", [P()]),
    ]


LM_RULES: ShardingRules = lm_rules(fsdp=False)


def cache_rules(mesh) -> ShardingRules:
    """Decode-state rules: the cache's sequence dim over ``model``
    (context-parallel), the batch over the data axes."""
    dpa = _dpa(mesh)
    return [
        (r"(^|/)(k|v)(_s)?$", [P(dpa, "model", None, None), P(dpa)]),
        (r"cross_(k|v)$", [P(dpa, "model", None, None), P(dpa)]),
        (r"/h$", [P(dpa, "model"), P(dpa)]),           # rglru state
        (r"conv$", [P(dpa, None, "model"), P(dpa)]),   # rglru conv tail
        (r"/S$", [P(dpa, None, None, None)]),          # rwkv state
        (r"x_(tm|cm)$", [P(dpa, "model"), P(dpa)]),
        (r".*", [P(dpa)]),
    ]


def lutdnn_population_rules(mesh) -> ShardingRules:
    """A population's leading member axis over the data axes, else
    replicated."""
    dpa = _dpa(mesh)
    return [(r".*", [P(dpa), P()])]


def zero1_shardings(param_shardings: Any, mesh, params: Any) -> Any:
    """ZeRO-1: optimizer moments also sharded over the data axes.  Each
    leaf's sharding gets the data axes on its first dim that is unsharded
    and divides; a leaf already sharded over them, or with no such dim,
    keeps its own."""
    axes = dp_axes(mesh)
    dp_size = 1
    for a in axes:
        dp_size *= mesh.shape[a]
    dp_entry = axes if len(axes) > 1 else axes[0]

    def used_axes(spec) -> set:
        out = set()
        for names in spec:
            if names is None:
                continue
            out.update(names if isinstance(names, tuple) else (names,))
        return out

    def one(_, sh: NamedSharding, leaf):
        shape = _shape(leaf)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        if used_axes(spec) & set(axes):
            return sh
        for dim in range(len(shape)):
            if spec[dim] is None and shape[dim] % dp_size == 0:
                spec[dim] = dp_entry
                return NamedSharding(mesh, P(*spec))
        return sh

    return tree_map_with_path(one, param_shardings, params)


# ---------------------------------------------------------------------------
# meshes for serving, and batches
# ---------------------------------------------------------------------------

def visible_devices() -> List[torch.device]:
    """The visible CUDA cards, or ``host_devices()`` without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return host_devices()


def serving_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data mesh for replicate-tables / shard-batch serving: the
    first ``n_devices`` of ``devices`` (default: the visible CUDA cards,
    or ``host_devices()`` on the CPU), all of them when None.
    ``devices=[cuda:0] * 4`` builds four shards on one card."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"serving_mesh: {n_devices} devices requested, "
                f"{len(devs)} visible; on the CPU call "
                f"repro_torch.device.ensure_host_devices({n_devices}) "
                f"first, on one card pass devices=[cuda:0] * "
                f"{n_devices}")
        devs = devs[:n_devices]
    return Mesh(devs, ("data",))


def batch_spec(mesh) -> P:
    return P(_dpa(mesh))


def batch_sharding(mesh: Mesh, ndim: int, seq_on_model: bool = False
                   ) -> NamedSharding:
    """(B, S, ...) activations: B over the data axes; S over ``model``
    when ``seq_on_model`` (sequence parallelism)."""
    entries: List[Any] = [_dpa(mesh)]
    if ndim >= 2:
        entries.append("model" if seq_on_model else None)
    entries += [None] * (ndim - len(entries))
    return NamedSharding(mesh, P(*entries))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One entry's part of a sharded tensor: its device, its index into
    the whole (a slice a dim) and its data."""
    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A tensor laid out over a mesh: one ``Shard`` an entry, in the
    mesh's row-major order (replicas included)."""
    shape: Tuple[int, ...]
    sharding: NamedSharding
    addressable_shards: Tuple[Shard, ...]


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Split ``x`` over ``sharding``'s mesh as the reference's
    ``jax.device_put`` lays it out: each dim named in the spec split in
    equal parts over its axes (it must divide), each entry given its
    part on its own device."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec!r} for a tensor of shape "
                         f"{tuple(x.shape)}")
    parts = []
    for dim, names in enumerate(spec):
        n = 1 if names is None else _axis_size(mesh, names)
        if n < 0:
            raise ValueError(f"spec {spec!r}: axis not in {mesh.axis_names}")
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {n} shards")
        parts.append((names, n))
    shards = []
    for flat, idx in enumerate(np.ndindex(*mesh.devices.shape)):
        index = []
        for dim in range(x.dim()):
            names, n = parts[dim] if dim < len(parts) else (None, 1)
            if names is None:
                index.append(slice(None))
                continue
            k = 0
            for a in (names if isinstance(names, tuple) else (names,)):
                k = k * mesh.shape[a] + idx[mesh.axis_names.index(a)]
            size = x.shape[dim] // n
            index.append(slice(k * size, (k + 1) * size))
        dev = mesh.device_list[flat]
        shards.append(Shard(device=dev, index=tuple(index),
                            data=x[tuple(index)].to(dev)))
    return ShardedTensor(shape=tuple(x.shape), sharding=sharding,
                         addressable_shards=tuple(shards))
