"""The table of peaks and the bytes a LUT network's forward needs.

A forward's least time is the bytes it must move over the card's
memory bandwidth.  The bytes are counted from the configuration file
and from what the harness hands the engine, never from what the port
allocates, so the count reads the same work whatever implements it:

- each input code at the 4 bytes (int32) the harness hands it;
- each table entry at its code's bits: K = 2**(in_bits*F) sub-table
  entries of ``sub_bits`` for each of the A sub-neurons of a neuron, and
  Ka = 2**(A*sub_bits) adder entries of ``out_bits`` (without an adder
  the sub-table entries are output codes of ``out_bits``);
- each connection index at ceil(log2 n_in) bits;
- each output code of the network at its ``out_bits``.

Codes passed between layers are not counted: a forward need not move
them through device memory.  No integer-operations term is counted: the
data sheet gives no integer rate outside the tensor cores.
"""
from __future__ import annotations

import math
from typing import Optional

# Memory bandwidth by the name torch.cuda.get_device_name() gives:
# NVIDIA H100 SXM data sheet, 80 GB HBM3 at 3.35 TB/s, at the part's
# 700 W power limit.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

INPUT_CODE_BYTES = 4


def index_bits(n_in: int) -> int:
    return max(1, math.ceil(math.log2(n_in)))


def table_bits(layer: dict) -> int:
    """Bits of one layer's tables and connection indices."""
    n_out, A, F = layer["n_out"], layer["A"], layer["F"]
    K = 2 ** (layer["in_bits"] * F)
    bits = n_out * A * F * index_bits(layer["n_in"])
    if A > 1:
        Ka = 2 ** (A * layer["sub_bits"])
        bits += n_out * A * K * layer["sub_bits"]
        bits += n_out * Ka * layer["out_bits"]
    else:
        bits += n_out * K * layer["out_bits"]
    return bits


def forward_bytes(cfg: dict, rows: int) -> float:
    """Bytes one forward of ``rows`` rows must move."""
    last = cfg["layers"][-1]
    inputs = rows * cfg["n_in"] * INPUT_CODE_BYTES
    outputs = rows * last["n_out"] * last["out_bits"] / 8
    tables = sum(table_bits(lay) for lay in cfg["layers"]) / 8
    return inputs + outputs + tables


def least_seconds(cfg: dict, rows: int, device_name: str
                  ) -> Optional[float]:
    """The forward's least time on ``device_name``; None for a card the
    table does not hold."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    return None if peak is None else forward_bytes(cfg, rows) / peak
