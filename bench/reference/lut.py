"""A LUT network's forward in plain PyTorch, from raw integer codes.

One layer: each output neuron has A sub-neurons; sub-neuron (n, a)
gathers the F input codes ``codes[:, conn[n, a, f]]``, packs them into a
table address (code f at bits ``f * in_bits``, code 0 lowest) and reads
its code ``sub[n, a, address]``.  With an adder (A > 1) the A sub-codes
are packed the same way (``sub_bits`` each) and address the neuron's
adder table ``add[n, :]``, whose code is the neuron's output; without
one the sub-code is.  Tables are (n_out, A, K) and (n_out, Ka) integer
arrays of one code an entry.  A code outside its table raises
(``IndexError``) rather than being masked.
"""
from __future__ import annotations

from typing import Sequence

import torch


def pack_address(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., F) codes -> (...) int64 addresses, code 0 in the low bits."""
    shift = torch.arange(codes.shape[-1], device=codes.device,
                         dtype=torch.int64) * bits
    return (codes.to(torch.int64) << shift).sum(-1)


def layer_forward(codes: torch.Tensor, conn: torch.Tensor,
                  sub: torch.Tensor, add: torch.Tensor, in_bits: int,
                  sub_bits: int) -> torch.Tensor:
    """(B, n_in) codes -> (B, n_out) int32 codes of one layer."""
    B = codes.shape[0]
    n_out, A, F = conn.shape
    picked = codes[:, conn.reshape(-1).to(torch.int64)].reshape(
        B, n_out, A, F)
    address = pack_address(picked, in_bits)                  # (B, n_out, A)
    neuron = torch.arange(n_out, device=codes.device)
    sub_codes = sub[neuron[:, None], torch.arange(A, device=codes.device),
                    address]                                 # (B, n_out, A)
    if add.shape[-1] == 0:
        return sub_codes[..., 0].to(torch.int32)
    return add[neuron, pack_address(sub_codes, sub_bits)].to(torch.int32)


def network_forward(codes: torch.Tensor, layers: Sequence,
                    block_rows: int = 8192) -> torch.Tensor:
    """Every layer in turn over blocks of ``block_rows`` rows.  Each of
    ``layers`` has ``conn``, ``sub``, ``add``, ``in_bits`` and
    ``sub_bits``."""
    parts = []
    for i in range(0, codes.shape[0], block_rows):
        x = codes[i:i + block_rows]
        for lay in layers:
            x = layer_forward(x, lay.conn, lay.sub, lay.add, lay.in_bits,
                              lay.sub_bits)
        parts.append(x)
    return torch.cat(parts)
