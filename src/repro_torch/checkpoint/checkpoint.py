"""Content-hash and atomic-directory helpers (port of
``repro.checkpoint.checkpoint``: ``sha256_bytes``, ``sha256_file``,
``atomic_dir``).  The artifact store content-addresses its slabs with
these.  Training checkpoints come with the training port."""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import tempfile
from typing import Iterator, Optional


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
