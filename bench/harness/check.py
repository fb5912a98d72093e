"""The comparison that decides ``correct``.

The window keeps the output codes of batches drawn from the seed
(``window.run_window``'s reservoir), as they reached the host.  After
the window the reference (``bench/reference/lut.py``) runs over each
kept batch's input, which the harness made and still holds, with the
raw tables the harness drew; every output code of every kept batch is
compared exactly.  The numbers compared, each with its limit:

- ``mismatched_codes``: output codes of the kept batches that differ
  from the reference's; limit 0 (integer codes, an exact comparison);
- ``unchecked_batches``: batches the reservoir should hold and does not
  (min(keep, issued) less those kept); limit 0.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from reference.lut import network_forward

LIMITS = {"mismatched_codes": 0, "unchecked_batches": 0}


def compare(kept: Sequence[Tuple[int, int, torch.Tensor]],
            pool: torch.Tensor, layers: Sequence,
            want_kept: int) -> Dict[str, int]:
    """Readings of the numbers compared, for ``kept`` (batch, pool
    index, output codes) against the reference over ``pool`` with the
    raw ``layers``."""
    expected: Dict[int, torch.Tensor] = {}
    mismatched = 0
    failed = 0
    for _, p, got in kept:
        if p not in expected:
            expected[p] = network_forward(pool[p], layers)
        want = expected[p]
        got = got.to(want.device)
        if got.shape != want.shape:
            bad = want.numel()
        else:
            bad = int((got != want).sum())
        mismatched += bad
        failed += bad > 0
    return {"mismatched_codes": mismatched,
            "unchecked_batches": max(0, want_kept - len(kept)),
            "failed_batches": failed}


def verdict(readings: Dict[str, int]) -> bool:
    return all(readings[k] <= v for k, v in LIMITS.items())


def report(readings: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """Each number compared beside its limit, for the result line (and
    the last lines of standard error)."""
    return {k: {"value": readings[k], "limit": v}
            for k, v in LIMITS.items()}
