"""Checkpoints and content-hash helpers (port of
``repro.checkpoint.checkpoint``).

The format on disk is the reference's, so a tree written by either
package restores in the other, bit for bit:

    ckpt_dir/step_000123/
      manifest.json       # per-leaf name, shape, dtype and chunks
      shard_000.npz       # leaf data, chunked along axis 0

* Leaves go in ``jax.tree.flatten`` order: dict keys sorted, lists,
  tuples and named tuples in order (dataclasses by their fields), None
  dropped.  A leaf is a tensor, a numpy array or a Python scalar.
* bfloat16 (which numpy lacks without ``ml_dtypes``) is stored as its
  ``uint16`` bit view with ``"dtype": "bfloat16"`` in the manifest.
* A leaf larger than ``max_shard_bytes`` is split along axis 0 into
  chunks, and shards close before they pass that size.
* Writes are atomic (a staging directory, then one rename), and
  ``AsyncCheckpointer`` writes on a thread from a host snapshot taken
  when ``save`` is called.

Restore fills a template tree: a tensor leaf comes back as a tensor of
the stored dtype on the template leaf's device, any other leaf as a
numpy array (a bfloat16 one as a CPU tensor).  Elastic re-sharding
(``shardings=``) waits (``ROADMAP.md``, Queue 1 item 6).  The artifact
store content-addresses its slabs with ``sha256_bytes``/``sha256_file``
and writes through ``atomic_dir``."""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def sha256_bytes(data) -> str:
    """Hex SHA-256 of a bytes-like payload (content-address primitive)."""
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, offset: int = 0, nbytes: Optional[int] = None,
                chunk: int = 8 * 1024 * 1024) -> str:
    """Hex SHA-256 of ``nbytes`` of ``path`` starting at ``offset``
    (whole remainder when None), streamed in chunks."""
    h = hashlib.sha256()
    remaining = nbytes
    with open(path, "rb") as f:
        f.seek(offset)
        while remaining is None or remaining > 0:
            take = chunk if remaining is None else min(chunk, remaining)
            buf = f.read(take)
            if not buf:
                break
            h.update(buf)
            if remaining is not None:
                remaining -= len(buf)
    return h.hexdigest()


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Write a directory atomically: yields a unique ``*.tmp`` staging
    path next to ``final``; on clean exit the staging dir replaces
    ``final`` in one rename, so a crashed writer never leaves a
    half-written directory behind, and concurrent writers of the same
    final path never share a staging dir (last rename wins)."""
    parent = os.path.dirname(os.path.abspath(final)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(final) + "-",
                           suffix=".tmp", dir=parent)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

_BF16 = "bfloat16"


class _Host:
    """A leaf snapshotted to the host: its storage array (bfloat16 as a
    uint16 view) and its dtype name."""

    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        if isinstance(leaf, _Host):
            self.array, self.dtype = leaf.array, leaf.dtype
        elif isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            bf16 = t.dtype == torch.bfloat16
            if bf16:
                t = t.view(torch.int16)
            # a device tensor's .cpu() is a copy; a CPU tensor's .numpy()
            # aliases it, so that one is copied here
            a = t.numpy().copy() if t.device.type == "cpu" \
                else t.cpu().numpy()
            self.array = a.view(np.uint16) if bf16 else a
            self.dtype = _BF16 if bf16 else str(a.dtype)
        else:
            self.array = np.array(leaf)        # a copy, as np.asarray is
            self.dtype = str(self.array.dtype)  # of a device array


def _children(node) -> Optional[List[Any]]:
    """A tree node's children in ``jax.tree.flatten`` order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def tree_flatten(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order (None dropped)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_flatten(k)]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in
    ``tree_flatten`` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            kids = [build(v) for v in node]
            return type(node)(*kids) if hasattr(node, "_fields") \
                else type(node)(kids)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return type(node)(**{f.name: build(getattr(node, f.name))
                                 for f in dataclasses.fields(node)})
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _structure(node) -> str:
    kids = _children(node) if node is not None else None
    if kids is None:
        return "None" if node is None else "*"
    inner = ", ".join(_structure(k) for k in kids)
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    return f"{type(node).__name__}({inner})"


def save_checkpoint(path: str, step: int, tree: Any,
                    max_shard_bytes: int = 512 * 1024 * 1024) -> str:
    """Atomic write of ``tree`` under ``path/step_{step:08d}``."""
    leaves = [_Host(leaf) for leaf in tree_flatten(tree)]
    final = os.path.join(path, f"step_{step:08d}")
    with atomic_dir(final) as tmp:
        manifest: Dict[str, Any] = {"step": step,
                                    "treedef": _structure(tree),
                                    "leaves": []}
        shard_id, shard_payload, shard_bytes = 0, {}, 0

        def flush():
            nonlocal shard_id, shard_payload, shard_bytes
            if shard_payload:
                np.savez(os.path.join(tmp, f"shard_{shard_id:03d}.npz"),
                         **shard_payload)
                shard_id += 1
                shard_payload, shard_bytes = {}, 0

        for i, host in enumerate(leaves):
            name, leaf = f"leaf_{i:05d}", host.array
            chunks = max(1, int(np.ceil(leaf.nbytes / max_shard_bytes)))
            rows = leaf.shape[0] if leaf.ndim else 1
            chunks = min(chunks, max(rows, 1))
            entry = {"name": name, "shape": list(leaf.shape),
                     "dtype": host.dtype, "chunks": []}
            if leaf.ndim == 0 or chunks == 1:
                parts = [(0, leaf)]
            else:
                splits = np.array_split(np.arange(rows), chunks)
                parts = [(int(s[0]), leaf[s[0]:s[-1] + 1])
                         for s in splits if len(s)]
            for off, part in parts:
                keyname = f"{name}_o{off}"
                entry["chunks"].append({"key": keyname, "offset": off,
                                        "shard": None})
                if shard_bytes + part.nbytes > max_shard_bytes:
                    flush()
                entry["chunks"][-1]["shard"] = shard_id
                shard_payload[keyname] = part
                shard_bytes += part.nbytes
            manifest["leaves"].append(entry)
        flush()

        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    return final


def _steps(path: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _leaf_out(array: np.ndarray, dtype: str, like) -> Any:
    if dtype == _BF16:
        t = torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
        return t.to(like.device) if isinstance(like, torch.Tensor) else t
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(array).to(like.device)
    return array


def restore_checkpoint(path: str, template: Any,
                       step: Optional[int] = None,
                       shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (the newest step when
    ``step`` is None)."""
    if shardings is not None:
        raise NotImplementedError("restoring onto a sharded layout is not "
                                  "ported yet (see ROADMAP.md Queue 1 "
                                  "item 6, the LM's multi-rank half)")
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shards: Dict[int, Any] = {}

    def shard(i: int):
        if i not in shards:
            shards[i] = np.load(os.path.join(d, f"shard_{i:03d}.npz"))
        return shards[i]

    like = tree_flatten(template)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint holds {len(manifest['leaves'])} "
                         f"leaves, the template {len(like)}")
    leaves = []
    for entry, tmpl in zip(manifest["leaves"], like):
        dt = entry["dtype"]
        store = np.dtype(np.uint16) if dt == _BF16 else np.dtype(dt)
        out = np.empty(entry["shape"], dtype=store)
        if not entry["shape"]:
            c = entry["chunks"][0]
            out = np.asarray(shard(c["shard"])[c["key"]]).view(store)
        else:
            for c in entry["chunks"]:
                part = shard(c["shard"])[c["key"]]
                out[c["offset"]:c["offset"] + part.shape[0]] = \
                    part.view(store)
        leaves.append(_leaf_out(out, dt, tmpl))
    return tree_unflatten(template, leaves), step


class CheckpointManager:
    """Keeps the newest ``keep`` checkpoints, atomic, monotonic."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)

    def steps(self) -> List[int]:
        return _steps(self.path)

    def save(self, step: int, tree: Any) -> str:
        out = save_checkpoint(self.path, step, tree)
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
        return out

    def restore_latest(self, template: Any, shardings: Any = None):
        return restore_checkpoint(self.path, template, None, shardings)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with compute: snapshot to the host when
    ``save`` is called (a copy, so later steps cannot change what is
    written; a CPU tensor's ``.numpy()`` would alias it), write on a
    daemon thread.  ``wait()`` joins outstanding writes."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        host = tree_unflatten(tree, [_Host(l) for l in tree_flatten(tree)])
        self.wait()
        self._thread = threading.Thread(
            target=self.manager.save, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
