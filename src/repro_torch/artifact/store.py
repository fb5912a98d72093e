"""Content-addressed on-disk artifacts for synthesised LUT networks
(port of ``repro.artifact.store``; same format, same artifact ids).

Layout (one directory per artifact, name suffixed with the content
hash, written atomically):

    <out_dir>/<name>-<hash12>/
      manifest.json      # schema version, per-layer + per-slab metadata
      slabs.bin          # every array back to back, 64-byte aligned

* **Content-addressed**: every slab carries its SHA-256 and the artifact
  id is the SHA-256 of the canonical (layer, slab) metadata, so the
  same tables saved by either package get the same id, packed
  (``int4=True``) or not.
* **Loading**: ``slabs.bin`` is read once into host memory (a writable
  buffer, so slabs become tensors without aliasing a read-only map),
  re-hashed when ``verify``, and each slab is copied once onto the
  target device.  ``unpack_int4=False`` keeps ``encoding: int4`` slabs
  two codes per byte (``LayerTables.sub_packed``/``add_packed``) for the
  kernels' in-kernel nibble unpack.
* **Routing slab**: carried and rewritten verbatim (it is hashed
  content); the port never computes with it.
* **Execution plans**: a manifest's ``execution_plan`` is a plan for the
  reference's TPU kernels; the port ignores it and plans for itself
  (``kernels.lut_gather.ops.plan_segments``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import atomic_dir, sha256_bytes, sha256_file
from repro_torch.core.lut_synth import (NUMPY_NAMES, TORCH_DTYPES,
                                        LayerTables, code_bits, nibble_pack,
                                        nibble_unpack)
from repro_torch.core.lutdnn import ModelSpec
from repro_torch.core.quant import QuantSpec
from repro_torch.device import DeviceLike, resolve_device

FORMAT = "lut-artifact"
SCHEMA_VERSION = 1
MANIFEST = "manifest.json"
SLAB_FILE = "slabs.bin"
_ALIGN = 64

INT4_NOTE = ("slabs with encoding=int4 hold two 4-bit codes per byte "
             "(low nibble first); load_artifact(unpack_int4=False) "
             "keeps them packed for the kernels' in-kernel nibble "
             "unpack")


class ArtifactError(RuntimeError):
    """Raised for unreadable, corrupt, or incompatible artifacts."""


@dataclasses.dataclass
class Artifact:
    """A loaded artifact: reconstructed tables + their manifest."""

    path: str
    manifest: Dict[str, Any]
    tables: List[LayerTables]

    @property
    def artifact_id(self) -> str:
        return self.manifest["artifact_id"]

    @property
    def n_in(self) -> int:
        """Network input width (the serving-side batcher feature count)."""
        return int(self.manifest["n_in"])

    @property
    def spec(self) -> Optional[ModelSpec]:
        """The training-time ModelSpec, when the writer recorded one."""
        d = self.manifest.get("spec")
        if d is None:
            return None
        kw = dict(d)
        for k in ("widths", "hidden"):
            if k in kw and kw[k] is not None:
                kw[k] = tuple(kw[k])
        return ModelSpec(**kw)

    @property
    def search(self) -> Optional[Dict[str, Any]]:
        """Connectivity-search provenance, when the writer recorded one
        (outside the hashed content)."""
        return self.manifest.get("search")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _quant_meta(q: QuantSpec) -> Dict[str, Any]:
    return {"bits": int(q.bits), "low": float(q.low), "high": float(q.high)}


def _spec_meta(spec: ModelSpec) -> Dict[str, Any]:
    d = dataclasses.asdict(spec)
    d["widths"] = list(d["widths"])
    d["hidden"] = list(d["hidden"])
    return d


def _infer_n_in(tables: List[LayerTables]) -> int:
    t0 = tables[0]
    if t0.routing is not None:
        return int(t0.routing.shape[0])
    return int(t0.conn.max().item()) + 1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_artifact(out_dir: str, tables: List[LayerTables], *,
                  name: str = "lut", spec: Optional[ModelSpec] = None,
                  provenance: Optional[Dict[str, Any]] = None,
                  int4: bool = True,
                  search: Optional[Dict[str, Any]] = None) -> str:
    """Serialise a synthesised network under ``out_dir``; returns the
    artifact directory (``<out_dir>/<name>-<hash12>``).  ``spec`` adds
    the ModelSpec and a cost-model row to the manifest; ``provenance``
    is free-form.  ``int4=False`` forces raw byte slabs everywhere.
    ``search`` persists connectivity-search provenance outside the
    hashed content.  Tables on any device are accepted."""
    layers_meta: List[Dict[str, Any]] = []
    slabs_meta: List[Dict[str, Any]] = []
    payloads: List[np.ndarray] = []
    offset = 0
    any_int4 = False

    def add_slab(slab_name: str, arr: np.ndarray, encoding: str,
                 logical_shape, logical_dtype) -> str:
        nonlocal offset, any_int4
        arr = np.ascontiguousarray(arr)
        pad = (-offset) % _ALIGN
        offset += pad
        payloads.append(np.zeros(pad, np.uint8))
        slabs_meta.append({
            "name": slab_name,
            "offset": offset,
            "nbytes": int(arr.nbytes),
            "stored_dtype": str(arr.dtype),
            "encoding": encoding,
            "shape": [int(s) for s in logical_shape],
            "dtype": str(np.dtype(logical_dtype)),
            "sha256": sha256_bytes(arr.tobytes()),
        })
        payloads.append(arr)
        offset += arr.nbytes
        any_int4 |= encoding == "int4"
        return slab_name

    for i, t in enumerate(tables):
        arrays: Dict[str, Optional[str]] = {}
        named = [("conn", _np(t.conn)),
                 ("sub_table", _np(t.sub_table)),
                 ("add_table", _np(t.add_table)),
                 ("routing", None if t.routing is None else _np(t.routing))]
        for key, arr in named:
            if arr is None:
                arrays[key] = None
                continue
            sname = f"L{i:02d}.{key}"
            already_packed = (key == "sub_table" and t.sub_packed) or \
                (key == "add_table" and t.add_packed)
            if already_packed and not int4:
                # int4=False promises raw slabs everywhere: expand, so
                # the bytes (and id) match a raw save of unpacked tables
                logical = arr.shape[:-1] + (arr.shape[-1] * 2,)
                arrays[key] = add_slab(
                    sname, nibble_unpack(arr, logical, np.uint8),
                    "raw", logical, np.uint8)
            elif already_packed:
                # the bytes ARE the int4 encoding: write them verbatim
                # under the logical shape
                logical = arr.shape[:-1] + (arr.shape[-1] * 2,)
                arrays[key] = add_slab(sname, arr, "int4",
                                       logical, np.uint8)
            elif (int4 and key in ("sub_table", "add_table")
                    and arr.dtype == np.uint8 and arr.size
                    and code_bits(t, key) <= 4):
                arrays[key] = add_slab(sname, nibble_pack(arr), "int4",
                                       arr.shape, arr.dtype)
            else:
                arrays[key] = add_slab(sname, arr, "raw",
                                       arr.shape, arr.dtype)
        layers_meta.append({
            "in_bits": int(t.in_bits), "sub_bits": int(t.sub_bits),
            "out_bits": int(t.out_bits), "fan_in": int(t.fan_in),
            "adder_width": int(t.adder_width),
            "is_output": bool(t.is_output),
            "table_dtype": NUMPY_NAMES[t.table_dtype],
            "out_quant": _quant_meta(t.out_quant),
            "sub_quant": _quant_meta(t.sub_quant),
            "arrays": arrays,
        })

    content = {"layers": layers_meta, "slabs": slabs_meta}
    artifact_id = sha256_bytes(
        json.dumps(content, sort_keys=True).encode())

    cost = None
    if spec is not None:
        from repro_torch.core.cost_model import model_cost
        cost = model_cost(spec).row()

    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "schema_version": SCHEMA_VERSION,
        "artifact_id": artifact_id,
        "name": name,
        "n_in": (int(spec.in_features) if spec is not None
                 else _infer_n_in(tables)),
        "total_slab_bytes": offset,
        "spec": None if spec is None else _spec_meta(spec),
        "cost_model": cost,
        "provenance": dict(provenance or {},
                           created_unix=round(time.time(), 3)),
        "notes": {"int4": INT4_NOTE} if any_int4 else {},
    }
    if search is not None:
        manifest["search"] = dict(search)
    manifest.update(content)

    final = os.path.join(out_dir, f"{name}-{artifact_id[:12]}")
    with atomic_dir(final) as tmp:
        with open(os.path.join(tmp, SLAB_FILE), "wb") as f:
            for arr in payloads:
                f.write(arr.tobytes())
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
    return final


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def find_artifacts(root: str) -> List[str]:
    """Artifact directories under ``root`` (``root`` itself when it IS
    one), newest manifest first; ``*.tmp`` staging dirs are skipped."""
    if os.path.isfile(os.path.join(root, MANIFEST)):
        return [root]
    if not os.path.isdir(root):
        return []
    hits = [os.path.join(root, d) for d in os.listdir(root)
            if not d.endswith(".tmp")
            and os.path.isfile(os.path.join(root, d, MANIFEST))]
    return sorted(hits, key=lambda p: os.path.getmtime(
        os.path.join(p, MANIFEST)), reverse=True)


def _read_manifest(path: str):
    hits = find_artifacts(path)
    if not hits:
        raise ArtifactError(f"no artifact manifest under {path!r}")
    adir = hits[0]
    try:
        with open(os.path.join(adir, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"unreadable manifest in {adir!r}: {e}") from e
    if manifest.get("format") != FORMAT:
        raise ArtifactError(f"{adir!r} is not a {FORMAT} artifact")
    return adir, manifest


def _check_size(slab_path: str, need: int) -> None:
    have = os.path.getsize(slab_path) if os.path.exists(slab_path) else -1
    if have < need:
        raise ArtifactError(
            f"truncated slab file {slab_path!r}: {have} bytes on disk, "
            f"manifest expects {need}")


def _corrupt(manifest, slab) -> ArtifactError:
    return ArtifactError(
        f"content hash mismatch for slab {slab['name']!r} — "
        f"artifact {manifest['artifact_id'][:12]} is corrupt")


def verify_artifact(path: str) -> Dict[str, Any]:
    """Hash-only admission check: re-hash every slab against the
    manifest without building any tensor.  Returns the manifest; raises
    ``ArtifactError`` on a missing, unreadable, truncated or corrupt
    artifact."""
    adir, manifest = _read_manifest(path)
    slab_path = os.path.join(adir, SLAB_FILE)
    try:
        _check_size(slab_path, int(manifest["total_slab_bytes"]))
        for s in manifest["slabs"]:
            if sha256_file(slab_path, s["offset"], s["nbytes"]) \
                    != s["sha256"]:
                raise _corrupt(manifest, s)
    except (KeyError, TypeError, ValueError) as e:
        raise ArtifactError(
            f"structurally corrupt manifest in {adir!r}: {e!r}") from e
    return manifest


def copy_artifact(src: str, dst_root: str) -> str:
    """Copy an artifact directory under ``dst_root`` (keeping its
    content-addressed name), atomically.  Returns the destination; the
    receiver still runs ``verify_artifact`` before admission."""
    hits = find_artifacts(src)
    if not hits:
        raise ArtifactError(f"no artifact manifest under {src!r}")
    adir = hits[0]
    dst = os.path.join(dst_root, os.path.basename(os.path.normpath(adir)))
    with atomic_dir(dst) as tmp:
        for fname in (MANIFEST, SLAB_FILE):
            fsrc = os.path.join(adir, fname)
            if os.path.exists(fsrc):
                shutil.copyfile(fsrc, os.path.join(tmp, fname))
    return dst


def load_artifact(path: str, verify: bool = True,
                  unpack_int4: bool = True,
                  device: DeviceLike = None) -> Artifact:
    """Reconstruct ``LayerTables`` on ``device`` (the CUDA card unless
    one is named) from an artifact directory, or a directory of
    artifacts (newest wins).  ``verify=True`` re-hashes every slab
    before any tensor is built.  ``unpack_int4=False`` keeps
    ``encoding: int4`` table slabs two codes per byte (table axis
    halved, ``sub_packed``/``add_packed`` set)."""
    dev = resolve_device(device)
    adir, manifest = _read_manifest(path)
    if manifest.get("schema_version", 0) > SCHEMA_VERSION:
        raise ArtifactError(
            f"artifact schema v{manifest['schema_version']} is newer than "
            f"this reader (v{SCHEMA_VERSION}) — upgrade before loading")

    slab_path = os.path.join(adir, SLAB_FILE)
    need = int(manifest["total_slab_bytes"])
    _check_size(slab_path, need)
    # one read into a writable host buffer; slabs are views into it
    buf = np.fromfile(slab_path, dtype=np.uint8, count=need)
    if verify:
        for s in manifest["slabs"]:
            if sha256_bytes(buf[s["offset"]:s["offset"] + s["nbytes"]]) \
                    != s["sha256"]:
                raise _corrupt(manifest, s)
    by_name = {s["name"]: s for s in manifest["slabs"]}

    def tensor(arr: np.ndarray) -> torch.Tensor:
        # CPU: a view of ``buf`` (already the one copy off the disk);
        # CUDA: one host-to-device copy
        return torch.from_numpy(arr).to(dev)

    def array(slab_name: str) -> np.ndarray:
        s = by_name[slab_name]
        raw = buf[s["offset"]:s["offset"] + s["nbytes"]]
        if s["encoding"] == "int4":
            return nibble_unpack(raw, s["shape"], s["dtype"])
        if s["encoding"] != "raw":
            raise ArtifactError(
                f"unknown slab encoding {s['encoding']!r} for "
                f"{slab_name!r}")
        return raw.view(s["dtype"]).reshape(s["shape"])

    def table_array(slab_name: str):
        """-> (array, packed) for a sub/add table slab."""
        s = by_name[slab_name]
        shape = s["shape"]
        if (not unpack_int4 and s["encoding"] == "int4"
                and shape and shape[-1] % 2 == 0
                and int(np.prod(shape, dtype=np.int64)) == 2 * s["nbytes"]):
            raw = buf[s["offset"]:s["offset"] + s["nbytes"]]
            return raw.reshape(tuple(shape[:-1]) + (shape[-1] // 2,)), True
        return array(slab_name), False

    tables: List[LayerTables] = []
    for lm in manifest["layers"]:
        a = lm["arrays"]
        sub, sub_packed = table_array(a["sub_table"])
        add, add_packed = table_array(a["add_table"])
        tables.append(LayerTables(
            conn=tensor(array(a["conn"])),
            sub_table=tensor(sub), add_table=tensor(add),
            in_bits=lm["in_bits"], sub_bits=lm["sub_bits"],
            out_bits=lm["out_bits"], fan_in=lm["fan_in"],
            adder_width=lm["adder_width"], is_output=lm["is_output"],
            out_quant=QuantSpec(**lm["out_quant"]),
            sub_quant=QuantSpec(**lm["sub_quant"]),
            table_dtype=TORCH_DTYPES[lm["table_dtype"]],
            routing=(None if a["routing"] is None
                     else tensor(array(a["routing"]))),
            sub_packed=sub_packed, add_packed=add_packed))
    return Artifact(path=adir, manifest=manifest, tables=tables)
