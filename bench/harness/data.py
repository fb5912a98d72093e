"""The one generator of a cell's data: a network's tables and the pool of
input batches, made on the device from the seed.

A configuration file lists every layer's sizes (``n_in``, ``n_out``,
``A``, ``F``, ``in_bits``, ``sub_bits``, ``out_bits``).  ``make_network``
draws each layer's connectivity and table codes as plain int32 arrays
(``RawLayer``): what the reference takes.  ``port_tables`` lays the same
codes out as the port's ``LayerTables``, in the storage a saved artifact
uses and the registry loads (int4 nibble-packed where the codes fit 4
bits, uint8 where they fit 8, int32 otherwise).  ``make_pool`` draws the
traffic mix's distinct input batches.  The same seed gives the same
tables and batches; every seed gives the same sizes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class RawLayer:
    """One layer as plain codes: ``conn`` (n_out, A, F) input indices,
    ``sub`` (n_out, A, K) sub-table codes and ``add`` (n_out, Ka) adder
    codes, or (n_out, 0) when A == 1 (then ``sub`` holds the output
    codes); all int32."""
    conn: torch.Tensor
    sub: torch.Tensor
    add: torch.Tensor
    in_bits: int
    sub_bits: int       # bits of a sub-table code
    out_bits: int       # bits of an output code

    @property
    def adder(self) -> bool:
        return self.add.shape[-1] > 0


def layer_sizes(layer: dict) -> tuple:
    """(K, Ka): sub-table entries a sub-neuron, adder entries a neuron
    (0 without an adder)."""
    K = 2 ** (layer["in_bits"] * layer["F"])
    Ka = 2 ** (layer["A"] * layer["sub_bits"]) if layer["A"] > 1 else 0
    return K, Ka


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _codes(g: torch.Generator, bits: int, shape, device) -> torch.Tensor:
    return torch.randint(0, 2 ** bits, tuple(shape), generator=g,
                         device=device, dtype=torch.int32)


def make_network(cfg: dict, g: torch.Generator,
                 device: torch.device) -> List[RawLayer]:
    """Every layer's connectivity and codes, uniform over their ranges."""
    out = []
    for lay in cfg["layers"]:
        n_in, n_out, A, F = lay["n_in"], lay["n_out"], lay["A"], lay["F"]
        K, Ka = layer_sizes(lay)
        conn = torch.randint(0, n_in, (n_out, A, F), generator=g,
                             device=device, dtype=torch.int32)
        if A > 1:
            sub = _codes(g, lay["sub_bits"], (n_out, A, K), device)
            add = _codes(g, lay["out_bits"], (n_out, Ka), device)
        else:
            sub = _codes(g, lay["out_bits"], (n_out, 1, K), device)
            add = torch.zeros((n_out, 0), dtype=torch.int32, device=device)
        out.append(RawLayer(conn, sub, add, lay["in_bits"],
                            lay["sub_bits"] if A > 1 else lay["out_bits"],
                            lay["out_bits"]))
    return out


def make_pool(cfg: dict, traffic: dict, g: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """(pool_batches, batch_rows, n_in) int32 input codes."""
    if traffic.get("codes", "uniform") != "uniform":
        raise ValueError(f"codes {traffic['codes']!r}: only 'uniform'")
    return _codes(g, cfg["input_bits"], (traffic["pool_batches"],
                                         traffic["batch_rows"], cfg["n_in"]),
                  device)


def storage_bits(code_bits: int) -> int:
    """Bits a slab spends on a code of ``code_bits`` bits."""
    return 4 if code_bits <= 4 else 8 if code_bits <= 8 else 32


def nibble_pack(codes: torch.Tensor) -> torch.Tensor:
    """Two 4-bit codes a byte along the last axis, low nibble first (the
    artifact's int4 encoding)."""
    return (codes[..., 0::2] | (codes[..., 1::2] << 4)).to(torch.uint8)


def _slab(codes: torch.Tensor, bits: int):
    """(slab, packed) in the storage of ``storage_bits(bits)``."""
    width = storage_bits(bits)
    if width == 4 and codes.shape[-1] % 2 == 0:
        return nibble_pack(codes).contiguous(), True
    if width <= 8:
        return codes.to(torch.uint8).contiguous(), False
    return codes.contiguous(), False


def port_tables(raw: List[RawLayer]) -> list:
    """The port's ``LayerTables`` holding ``raw``'s codes."""
    from repro_torch.core.lut_synth import LayerTables
    from repro_torch.core.quant import QuantSpec

    out = []
    for i, r in enumerate(raw):
        n_out, A, F = r.conn.shape
        sub, sub_packed = _slab(r.sub, r.sub_bits)
        if r.adder:
            add, add_packed = _slab(r.add, r.out_bits)
        else:
            add, add_packed = r.add.to(sub.dtype), False
        out.append(LayerTables(
            conn=r.conn.contiguous(), sub_table=sub, add_table=add,
            in_bits=r.in_bits, sub_bits=r.sub_bits, out_bits=r.out_bits,
            fan_in=F, adder_width=A, is_output=i == len(raw) - 1,
            out_quant=QuantSpec(r.out_bits, 0.0, 1.0),
            sub_quant=QuantSpec(r.sub_bits, -1.0, 1.0),
            table_dtype=sub.dtype, sub_packed=sub_packed,
            add_packed=add_packed))
    return out
