"""Truth-table synthesis and synthesised LUT networks as data (port of
``repro.core.lut_synth``).

Synthesis enumerates every (beta*F)-bit input combination of each
sub-neuron (and every A*(beta+1)-bit combination of each adder), pushes
them through the trained transfer function in eval mode, and stores the
resulting output codes.  ``synthesise_layer`` calls the same
``layers.subneuron_transfer`` as the QAT forward, so the two agree on
whatever device they run on.

A synthesised layer is three integer artefacts per neuron — ``conn``
(which input codes feed each sub-neuron), ``sub_table`` (sub-neuron
truth tables) and ``add_table`` (adder + BN + activation truth tables,
zero-width when A == 1) — plus the quantisation metadata that says how
wide each code is.  Inference is pure integer gather
(``lut_layer_forward`` here, the CUDA kernels in
``repro_torch.kernels.lut_gather``).

Contract (tested): for any input, ``lut_forward(synthesise(model), x)``
picks the argmax of the quantized forward ``lutdnn.forward(model, x)``,
with logits within ``OUTPUT_QUANT.step``.  Tables also arrive from an
artifact (``repro_torch.artifact``) or from numpy arrays through
``tables_from_numpy``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core.quant import QuantSpec, bn_fold
from repro_torch.device import DeviceLike, resolve_device

# packed table addresses above this width get no routing matrix (the
# reference's MATMUL_ROUTE_MAX_BITS, kernels/lut_gather/lut_gather.py)
MATMUL_ROUTE_MAX_BITS = 20

# the table dtypes synthesis emits, by numpy name
TORCH_DTYPES = {"uint8": torch.uint8, "int32": torch.int32}
NUMPY_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


@dataclasses.dataclass
class LayerTables:
    """Synthesised artefacts for one layer, as torch tensors on one
    device.

    ``sub_table`` is (n_out, A, K) with K = 2**(in_bits * F);
    ``add_table`` is (n_out, Ka) with Ka = 2**(A * sub_bits), or
    (n_out, 0) when the adder is off.  Slabs are uint8 when their codes
    fit 8 bits and int32 otherwise (the output layer's 16-bit logit
    codes).  ``sub_packed`` / ``add_packed`` mark int4 nibble-packed
    slabs: two 4-bit codes per byte, low nibble first, table axis
    halved.  ``routing`` is the reference's cached (n_in, n_out*A)
    float32 routing matrix: part of an artifact's hashed content, so it
    is carried and saved, never computed with.
    """

    conn: torch.Tensor        # (n_out, A, F) int32 gather indices
    sub_table: torch.Tensor   # (n_out, A, K) codes; (n_out, A, K//2) packed
    add_table: torch.Tensor   # (n_out, Ka), or (n_out, 0)
    in_bits: int
    sub_bits: int             # bits of sub-table output codes
    out_bits: int
    fan_in: int
    adder_width: int
    is_output: bool
    out_quant: QuantSpec
    sub_quant: QuantSpec
    table_dtype: torch.dtype = torch.int32   # dtype of sub_table
    routing: Optional[torch.Tensor] = None   # (n_in, n_out*A) f32, or None
    sub_packed: bool = False  # sub_table holds two int4 codes per byte
    add_packed: bool = False  # add_table holds two int4 codes per byte

    @property
    def table_bytes(self) -> int:
        """Bytes of truth-table payload (sub + adder tables) as stored."""
        return int(self.sub_table.numel() * self.sub_table.element_size()
                   + self.add_table.numel() * self.add_table.element_size())

    def to(self, device: torch.device) -> "LayerTables":
        """The same tables with every tensor on ``device`` (no copy for
        a tensor already there)."""
        return dataclasses.replace(
            self, conn=self.conn.to(device),
            sub_table=self.sub_table.to(device),
            add_table=self.add_table.to(device),
            routing=None if self.routing is None
            else self.routing.to(device))


def table_dtype_for(bits: int) -> torch.dtype:
    """Narrowest supported dtype for `bits`-bit unsigned output codes."""
    return torch.uint8 if bits <= 8 else torch.int32


def code_bits(t: LayerTables, which: str) -> int:
    """Bit width of the codes a table slab stores (decides int4
    eligibility from metadata, never from a data scan)."""
    if which == "sub_table":
        return t.sub_bits if t.adder_width > 1 else \
            (16 if t.is_output else t.out_bits)
    return 16 if t.is_output else t.out_bits          # add_table


# --------------------------------------------------------------------------
# int4 nibble packing (two codes per byte, low nibble first)
# --------------------------------------------------------------------------

def nibble_pack(arr: np.ndarray) -> np.ndarray:
    """Flatten ``arr`` and pack two 4-bit codes per byte (low nibble
    first: byte j = code 2j | code 2j+1 << 4), zero-padding odd sizes."""
    flat = np.ascontiguousarray(arr, np.uint8).reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)


def nibble_unpack(packed: np.ndarray, shape, dtype) -> np.ndarray:
    """Inverse of ``nibble_pack``: bytes (any shape, flat pairing order)
    back to ``shape`` codes."""
    packed = np.asarray(packed, np.uint8).reshape(-1)
    out = np.empty(packed.size * 2, np.uint8)
    out[0::2] = packed & 0xF
    out[1::2] = packed >> 4
    n = int(np.prod(shape, dtype=np.int64))
    return out[:n].reshape(shape).astype(dtype)


def _slab_packable(t: LayerTables, which: str) -> bool:
    slab = getattr(t, which)
    return (slab.dtype == torch.uint8 and slab.numel() > 0
            and slab.shape[-1] % 2 == 0 and code_bits(t, which) <= 4)


def _repack(slab: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(slab.device)


def pack_tables_int4(tables: List[LayerTables]) -> List[LayerTables]:
    """Nibble-pack every eligible (<=4-bit-code uint8) sub/add slab,
    halving the table axis in place — (n_out, A, K) -> (n_out, A, K//2)
    — so a slab keeps its (neuron, sub-neuron) geometry.  Ineligible
    slabs pass through; already packed tables are returned as-is."""
    out = []
    for t in tables:
        rep = {}
        if not t.sub_packed and _slab_packable(t, "sub_table"):
            s = t.sub_table.cpu().numpy()
            rep["sub_table"] = _repack(t.sub_table, nibble_pack(s).reshape(
                s.shape[:-1] + (s.shape[-1] // 2,)))
            rep["sub_packed"] = True
        if not t.add_packed and _slab_packable(t, "add_table"):
            a = t.add_table.cpu().numpy()
            rep["add_table"] = _repack(t.add_table, nibble_pack(a).reshape(
                a.shape[:-1] + (a.shape[-1] // 2,)))
            rep["add_packed"] = True
        out.append(dataclasses.replace(t, **rep) if rep else t)
    return out


def unpack_tables_int4(tables: List[LayerTables]) -> List[LayerTables]:
    """Expand nibble-packed slabs back to one uint8 code per byte."""
    out = []
    for t in tables:
        rep = {}
        if t.sub_packed:
            s = t.sub_table.cpu().numpy()
            rep["sub_table"] = _repack(t.sub_table, nibble_unpack(
                s, s.shape[:-1] + (s.shape[-1] * 2,), np.uint8))
            rep["sub_packed"] = False
        if t.add_packed:
            a = t.add_table.cpu().numpy()
            rep["add_table"] = _repack(t.add_table, nibble_unpack(
                a, a.shape[:-1] + (a.shape[-1] * 2,), np.uint8))
            rep["add_packed"] = False
        out.append(dataclasses.replace(t, **rep) if rep else t)
    return out


OUTPUT_QUANT = QuantSpec(bits=16, low=-8.0, high=8.0)


# --------------------------------------------------------------------------
# synthesis
# --------------------------------------------------------------------------

def routing_matrix(conn, in_bits: int, n_in: int) -> np.ndarray:
    """The reference's routing matrix (a copy of its
    ``kernels/lut_gather/lut_gather.routing_matrix``), as numpy:
    W[i, n*A + a] = sum_f [conn[n, a, f] == i] * 2**(in_bits * f).  It
    is part of an artifact's hashed content, so synthesis writes it;
    the port never routes with it."""
    conn_np = (conn.detach().cpu().numpy() if torch.is_tensor(conn)
               else np.asarray(conn))
    n_out, A, F = conn_np.shape
    w = np.zeros((n_in, n_out * A), np.float32)
    flat = conn_np.reshape(n_out * A, F)
    cols = np.arange(n_out * A)
    for f in range(F):
        np.add.at(w, (flat[:, f], cols), float(1 << (in_bits * f)))
    return w


def _enum_codes(n_slots: int, bits: int) -> np.ndarray:
    """All 2**(n_slots*bits) input-code tuples, shape (2**.., n_slots).

    Slot 0 occupies the LOW bits of the packed index — this convention
    must match the LUT kernels exactly.
    """
    total = 2 ** (n_slots * bits)
    idx = np.arange(total, dtype=np.int64)
    cols = [(idx >> (bits * i)) & ((1 << bits) - 1) for i in range(n_slots)]
    return np.stack(cols, axis=1).astype(np.int32)


def _logit_codes(z: torch.Tensor, oq: QuantSpec) -> torch.Tensor:
    """Output layer: quantize raw BN output over a wide signed range so
    argmax is preserved.  16-bit signed fixed point, range +-8."""
    del oq
    return OUTPUT_QUANT.to_code(OUTPUT_QUANT.clip(z))


@torch.no_grad()
def synthesise_layer(params: dict, conn: torch.Tensor, spec: L.LayerSpec,
                     pack: bool = True, routing: bool = True
                     ) -> LayerTables:
    """One layer's truth tables, computed on the device of its
    parameters."""
    dev = conn.device
    b_in = spec.in_quant.bits
    combos = torch.from_numpy(_enum_codes(spec.fan_in, b_in)).to(dev)
    vals = spec.in_quant.from_code(combos)                      # (K, F)

    # sub-neuron transfer for every neuron and combo: (K, n_out, A)
    x_f = vals[:, None, None, :].expand(
        vals.shape[0], spec.n_out, spec.adder_width, spec.fan_in)
    pre = L.subneuron_transfer(params, spec, x_f)               # (K, n_out, A)

    bn = bn_fold(params["bn"])
    sq = spec.sub_quant
    oq = spec.out_quant

    # the output layer emits wide 16-bit logit codes (see _logit_codes);
    # hidden layers emit oq.bits-wide codes
    out_code_bits = 16 if spec.is_output else oq.bits

    if spec.adder_width > 1:
        sub_dt = table_dtype_for(sq.bits) if pack else torch.int32
        add_dt = table_dtype_for(out_code_bits) if pack else torch.int32
        # sub-neuron LUT emits (beta+1)-bit codes of the quantized pre-sum
        sub_codes = sq.to_code(pre)                             # (K, n_out, A)
        sub_table = sub_codes.permute(1, 2, 0)                  # (n_out, A, K)
        # adder LUT: enumerate A codes of (beta+1) bits
        acombos = torch.from_numpy(
            _enum_codes(spec.adder_width, sq.bits)).to(dev)
        avals = sq.from_code(acombos)                           # (Ka, A)
        s = torch.sum(avals, dim=-1)                            # (Ka,)
        z = s[:, None] * bn.scale[None, :] + bn.offset[None, :]  # (Ka, n_out)
        if spec.is_output:
            out_codes = _logit_codes(z, oq)
        else:
            out_codes = oq.to_code(oq.clip(torch.relu(z)))
        add_table = out_codes.T.to(add_dt).contiguous()         # (n_out, Ka)
        sub_bits = sq.bits
    else:
        sub_dt = table_dtype_for(out_code_bits) if pack else torch.int32
        z = pre[..., 0] * bn.scale[None, :] + bn.offset[None, :]  # (K, n_out)
        if spec.is_output:
            codes = _logit_codes(z, oq)
        else:
            codes = oq.to_code(oq.clip(torch.relu(z)))
        sub_table = codes.T[:, None, :]                         # (n_out, 1, K)
        add_table = torch.zeros((spec.n_out, 0), dtype=sub_dt, device=dev)
        sub_bits = oq.bits

    route = (torch.from_numpy(routing_matrix(conn, b_in, spec.n_in)).to(dev)
             if routing and b_in * spec.fan_in <= MATMUL_ROUTE_MAX_BITS
             else None)
    return LayerTables(
        conn=conn.to(torch.int32).contiguous(),
        sub_table=sub_table.to(sub_dt).contiguous(),
        add_table=add_table, in_bits=b_in, sub_bits=sub_bits,
        out_bits=oq.bits, fan_in=spec.fan_in,
        adder_width=spec.adder_width, is_output=spec.is_output,
        out_quant=oq, sub_quant=sq, table_dtype=sub_dt, routing=route)


def synthesise(model: dict, spec, pack: bool = True,
               routing: bool = True) -> List[LayerTables]:
    """Every layer's tables, on the model's device.  ``routing=False``
    skips the per-layer routing matrix (an n_in*n_out*A float32 per
    layer, written to artifacts only)."""
    return [
        synthesise_layer(p, c, s, pack=pack, routing=routing)
        for p, c, s in zip(model["layers"], model["conn"], spec.layer_specs())
    ]


def network_table_bytes(tables: List[LayerTables]) -> int:
    """Total truth-table payload of a synthesised network, conn
    included."""
    return sum(t.table_bytes + t.conn.numel() * t.conn.element_size()
               for t in tables)


# --------------------------------------------------------------------------
# carrying tables across from numpy (and from the reference package)
# --------------------------------------------------------------------------

def _tensor(arr, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    # np.array copies, so the tensor never aliases a read-only buffer
    return torch.from_numpy(np.array(np.asarray(arr), dtype)).to(device)


def tables_from_numpy(tables, device: DeviceLike = None
                      ) -> List[LayerTables]:
    """Build the port's ``LayerTables`` from any objects with the same
    fields (duck-typed, e.g. the reference package's tables): every
    array goes through ``np.asarray``, metadata through plain ints and
    the ``QuantSpec`` fields.  Tensors land on ``device`` (the CUDA card
    unless one is named)."""
    dev = resolve_device(device)

    def quant(q):
        return QuantSpec(bits=int(q.bits), low=float(q.low),
                         high=float(q.high))

    out = []
    for t in tables:
        sub = np.asarray(t.sub_table)
        add = np.asarray(t.add_table)
        routing = getattr(t, "routing", None)
        out.append(LayerTables(
            conn=_tensor(t.conn, np.int32, dev),
            sub_table=_tensor(sub, sub.dtype, dev),
            add_table=_tensor(add, add.dtype, dev),
            in_bits=int(t.in_bits), sub_bits=int(t.sub_bits),
            out_bits=int(t.out_bits), fan_in=int(t.fan_in),
            adder_width=int(t.adder_width), is_output=bool(t.is_output),
            out_quant=quant(t.out_quant), sub_quant=quant(t.sub_quant),
            table_dtype=TORCH_DTYPES[np.dtype(t.table_dtype).name],
            routing=None if routing is None
            else _tensor(routing, np.float32, dev),
            sub_packed=bool(getattr(t, "sub_packed", False)),
            add_packed=bool(getattr(t, "add_packed", False))))
    return out


# --------------------------------------------------------------------------
# plain LUT-mode inference
# --------------------------------------------------------------------------

def pack_index(codes_f: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., F) int codes -> packed int32 index (slot 0 = low bits)."""
    f = codes_f.shape[-1]
    shifts = torch.arange(f, dtype=torch.int32,
                          device=codes_f.device) * bits
    return torch.sum(codes_f.to(torch.int32) << shifts, dim=-1,
                     dtype=torch.int32)


def _gather_tables(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (n_out, A, K); idx: (B, n_out, A) -> (B, n_out, A)."""
    flat = table.reshape(-1)
    n_out, A, K = table.shape
    base = (torch.arange(n_out * A, device=idx.device,
                         dtype=torch.int64) * K).reshape(n_out, A)
    return flat[base + idx.to(torch.int64)]


def lut_layer_forward(tables: LayerTables, codes: torch.Tensor
                      ) -> torch.Tensor:
    """codes: (B, n_in) int32 on this layer's input grid -> (B, n_out)
    int32.  Takes unpacked slabs (``unpack_tables_int4`` first)."""
    gathered = codes[:, tables.conn.to(torch.int64)]   # (B, n_out, A, F)
    idx = pack_index(gathered, tables.in_bits)         # (B, n_out, A)
    sub = _gather_tables(tables.sub_table, idx)        # (B, n_out, A)
    if tables.adder_width > 1:
        aidx = pack_index(sub, tables.sub_bits)        # (B, n_out)
        return _gather_tables(tables.add_table[:, None, :],
                              aidx[..., None])[..., 0].to(torch.int32)
    return sub[..., 0].to(torch.int32)


def lut_forward(all_tables: List[LayerTables], x: torch.Tensor,
                first_quant: QuantSpec) -> torch.Tensor:
    """Full LUT-mode inference.  x: (B, n_in) real; returns logits."""
    codes = first_quant.to_code(first_quant.clip(x))
    for t in all_tables:
        codes = lut_layer_forward(t, codes)
    return OUTPUT_QUANT.from_code(codes)
