"""The control of the comparison: the reference with every table held
one storage step narrower than the configuration states.

The configuration states each slab's code width; a slab stores a code
in 4 bits (int4) when it fits, else in 8 (uint8), else in 32 (int32).
The step below is 32 -> 8 and 8 -> 4: a code of ``b`` bits kept in
``s < b`` bits keeps its top ``s`` bits (the same quantity at a coarser
grain: the step that would tempt a change that shrinks the tables).  A
slab already stored in 4 bits has no narrower step and stays as it is.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

STEP_BELOW = {32: 8, 8: 4}


def storage_bits(code_bits: int) -> int:
    return 4 if code_bits <= 4 else 8 if code_bits <= 8 else 32


def narrowed(codes: torch.Tensor, code_bits: int) -> torch.Tensor:
    """``codes`` of ``code_bits`` bits kept in the next narrower
    storage (unchanged when there is none)."""
    keep = STEP_BELOW.get(storage_bits(code_bits))
    if keep is None or keep >= code_bits:
        return codes
    drop = code_bits - keep
    return (codes >> drop) << drop


@dataclasses.dataclass(frozen=True)
class ControlLayer:
    conn: torch.Tensor
    sub: torch.Tensor
    add: torch.Tensor
    in_bits: int
    sub_bits: int


def control_layers(layers: Sequence) -> List[ControlLayer]:
    """``layers`` (with ``conn``, ``sub``, ``add``, ``in_bits``,
    ``sub_bits``, ``out_bits``) with narrowed tables.  A sub-table
    without an adder holds output codes (``sub_bits`` is their width)."""
    out = []
    for lay in layers:
        out.append(ControlLayer(
            conn=lay.conn, sub=narrowed(lay.sub, lay.sub_bits),
            add=narrowed(lay.add, lay.out_bits), in_bits=lay.in_bits,
            sub_bits=lay.sub_bits))
    return out
