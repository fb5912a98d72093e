"""Plain PyTorch versions of the LUT kernels (the CPU path, and what
``chip_smoke.py`` holds each CUDA kernel against on the card).

One layer is pure integer work: gather the F fan-in codes through
``conn``, bit-pack them into a table address (slot 0 in the low bits),
look up the sub-neuron code at flat index ``n*A*K + a*K + idx``, then,
with the adder on, pack the A sub-codes (``sub_bits`` each) and look up
the adder table.  Slabs are uint8, int32, or int4 nibble-packed (byte
``fi >> 1``, nibble ``fi & 1``).  Every table address is masked to its
row (``& (K-1)``, ``& (Ka-1)``), exactly as the kernels do, so a code
out of range never reads outside a slab; on codes in range the mask
changes nothing.
"""
from __future__ import annotations

import torch


def pack_index(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., F) int codes -> packed int32 index; slot 0 in the low bits."""
    f = codes.shape[-1]
    shifts = torch.arange(f, dtype=torch.int32, device=codes.device) * bits
    return torch.sum(codes.to(torch.int32) << shifts, dim=-1,
                     dtype=torch.int32)


def read_slab(slab: torch.Tensor, fi: torch.Tensor,
              packed: bool) -> torch.Tensor:
    """Codes at LOGICAL flat indices ``fi`` (int64) of a slab -> int32."""
    flat = slab.reshape(-1)
    if not packed:
        return flat[fi].to(torch.int32)
    byte = flat[fi >> 1].to(torch.int32)
    return (byte >> ((fi & 1) * 4).to(torch.int32)) & 0xF


def lut_layer(codes: torch.Tensor, conn: torch.Tensor,
              sub_table: torch.Tensor, add_table: torch.Tensor,
              in_bits: int, sub_bits: int, sub_packed: bool = False,
              add_packed: bool = False) -> torch.Tensor:
    """codes: (B, n_in) int32 -> (B, n_out) int32 output codes.
    ``add_table`` of width 0 turns the adder off."""
    B = codes.shape[0]
    n_out, A, F = conn.shape
    K = sub_table.shape[-1] * (2 if sub_packed else 1)
    dev = codes.device
    gathered = codes[:, conn.reshape(-1).to(torch.int64)].reshape(
        B, n_out, A, F)
    idx = pack_index(gathered, in_bits) & (K - 1)          # (B, n_out, A)
    base = torch.arange(n_out * A, dtype=torch.int64,
                        device=dev).reshape(n_out, A) * K
    sub = read_slab(sub_table, base + idx.to(torch.int64), sub_packed)
    if add_table.shape[-1] == 0:
        return sub[..., 0]
    Ka = add_table.shape[-1] * (2 if add_packed else 1)
    aidx = pack_index(sub, sub_bits) & (Ka - 1)            # (B, n_out)
    abase = torch.arange(n_out, dtype=torch.int64, device=dev) * Ka
    return read_slab(add_table, abase + aidx.to(torch.int64), add_packed)


def lut_network(codes: torch.Tensor, layers) -> torch.Tensor:
    """Chain of ``lut_layer`` over ``layers``, each a tuple ``(conn,
    sub_table, add_table, in_bits, sub_bits, sub_packed, add_packed)``
    — the plain version of the fused kernels."""
    for layer in layers:
        codes = lut_layer(codes, *layer)
    return codes
