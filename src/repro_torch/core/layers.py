"""LUT-DNN layers: LogicNets / PolyLUT / PolyLUT-Add / NeuraLUT (port
of ``repro.core.layers``).

A layer is a static ``LayerSpec`` plus a dict of parameter tensors;
connectivity is data, an int32 gather table ``conn`` of shape
(n_out, A, F).  The training forward is a gather (``x_q[..., conn]``)
plus monomial expansion and a small einsum, as in the reference; it
does not go through the masked-matmul kernel, which has no backward.
Inference runs through synthesised truth tables instead
(``core.lut_synth``), and ``synthesise`` calls the same
``subneuron_transfer`` as ``layer_forward``.

Random draws take an explicit ``torch.Generator`` and are made on the
generator's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import poly
from repro_torch.core.quant import (QuantSpec, act_quant, adder_quant,
                                    bn_apply_eval, bn_apply_train, bn_init,
                                    input_quant)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    n_in: int
    n_out: int
    fan_in: int                 # F per sub-neuron
    degree: int = 1             # D (1 == LogicNets linear neuron)
    adder_width: int = 1        # A (>1 == PolyLUT-Add)
    in_quant: QuantSpec = QuantSpec(2, -1.0, 1.0)
    out_quant: QuantSpec = QuantSpec(2, 0.0, 1.0)
    hidden: Tuple[int, ...] = ()  # NeuraLUT sub-net widths; () == PolyLUT
    is_output: bool = False

    @property
    def total_fan_in(self) -> int:
        return self.fan_in * self.adder_width

    @property
    def n_monomials(self) -> int:
        return poly.num_monomials(self.fan_in, self.degree)

    @property
    def sub_quant(self) -> QuantSpec:
        """Quantizer on sub-neuron outputs feeding the adder: beta + 1
        bits, where beta is the layer's activation width (out_quant)."""
        return adder_quant(self.out_quant.bits, self.adder_width)

    @property
    def subneuron_table_entries(self) -> int:
        return 2 ** (self.in_quant.bits * self.fan_in)

    @property
    def adder_table_entries(self) -> int:
        if self.adder_width == 1:
            return 0
        return 2 ** (self.adder_width * self.sub_quant.bits)

    @property
    def layer_table_entries(self) -> int:
        """Total truth-table entries for the layer (paper Table II col.)."""
        per_neuron = self.adder_width * self.subneuron_table_entries \
            + self.adder_table_entries
        return self.n_out * per_neuron


def _he(gen: torch.Generator, shape, fan) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * math.sqrt(2.0 / max(fan, 1))


def init_layer(gen: torch.Generator, spec: LayerSpec) -> dict:
    """Trainable params for one layer (connectivity lives separately),
    drawn from ``gen`` on its device."""
    dev = gen.device
    p: dict = {"bn": bn_init(spec.n_out, device=dev)}
    if spec.hidden:
        dims = (spec.fan_in,) + tuple(spec.hidden) + (1,)
        mats = []
        for i in range(len(dims) - 1):
            mats.append({
                "w": _he(gen, (spec.n_out, spec.adder_width,
                               dims[i], dims[i + 1]), dims[i]),
                "b": torch.zeros((spec.n_out, spec.adder_width,
                                  dims[i + 1]), dtype=torch.float32,
                                 device=dev),
            })
        p["subnet"] = mats
        p["skip"] = _he(gen, (spec.n_out, spec.adder_width,
                              spec.fan_in, 1), spec.fan_in)
    else:
        p["w"] = _he(gen, (spec.n_out, spec.adder_width, spec.n_monomials),
                     spec.fan_in)
        p["b"] = torch.zeros((spec.n_out, spec.adder_width),
                             dtype=torch.float32, device=dev)
    return p


def random_conn(gen: torch.Generator, spec: LayerSpec) -> torch.Tensor:
    """Random connectivity (the baseline): (n_out, A, F) int32 indices,
    drawn per neuron without replacement across the whole A*F budget
    while that budget fits in n_in (with replacement beyond it)."""
    total = spec.total_fan_in
    dev = gen.device
    if total > spec.n_in:
        flat = torch.randint(0, spec.n_in, (spec.n_out, total),
                             generator=gen, device=dev)
    else:
        # the first `total` of a uniform random order of the n_in inputs
        keys = torch.rand((spec.n_out, spec.n_in), generator=gen,
                          device=dev)
        flat = torch.argsort(keys, dim=1)[:, :total]
    return flat.reshape(spec.n_out, spec.adder_width,
                        spec.fan_in).to(torch.int32)


def subneuron_transfer(params: dict, spec: LayerSpec,
                       x_f: torch.Tensor) -> torch.Tensor:
    """Map gathered fan-in values (..., n_out, A, F) -> pre-activation
    (..., n_out, A).  Polynomial (PolyLUT) or sub-network (NeuraLUT)."""
    if spec.hidden:
        t = x_f
        n_mats = len(params["subnet"])
        for i, m in enumerate(params["subnet"]):
            t = torch.einsum("...naf,nafe->...nae", t, m["w"]) + m["b"]
            if i < n_mats - 1:
                t = torch.relu(t)
        skip = torch.einsum("...naf,nafe->...nae", x_f, params["skip"])
        return (t + skip)[..., 0]
    feats = poly.expand(x_f, spec.degree)              # (..., n_out, A, M)
    return torch.einsum("...nam,nam->...na", feats, params["w"]) \
        + params["b"]


def layer_forward(params: dict, conn: torch.Tensor, spec: LayerSpec,
                  x: torch.Tensor, train: bool = False
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (..., n_in) on the previous layer's quant grid.

    Returns (y, new_params) where y is on this layer's out-quant grid
    (or raw BN output for the output layer) and new_params carries
    updated BN running stats when ``train``.
    """
    x_q = spec.in_quant.quantize(x)
    x_f = x_q[..., conn.long()]                        # (..., n_out, A, F)
    pre = subneuron_transfer(params, spec, x_f)        # (..., n_out, A)

    if spec.adder_width > 1:
        sub = spec.sub_quant.quantize(pre)             # beta+1 bits
        s = torch.sum(sub, dim=-1)                     # adder
    else:
        s = pre[..., 0]

    new_params = params
    if train:
        z, new_bn = bn_apply_train(params["bn"], s)
        new_params = dict(params)
        new_params["bn"] = new_bn
    else:
        z = bn_apply_eval(params["bn"], s)

    if spec.is_output:
        return z, new_params
    y = spec.out_quant.quantize(torch.relu(z))
    return y, new_params


def make_layer_specs(in_features: int, widths: Sequence[int], bits: int,
                     fan_in: int, degree: int = 1, adder_width: int = 1,
                     input_bits: Optional[int] = None,
                     input_fan_in: Optional[int] = None,
                     hidden: Tuple[int, ...] = ()) -> list:
    """Per-layer spec list for a full LUT-DNN: the first layer may use
    its own input bit-width (beta_i) and fan-in (F_i); hidden
    activations are unsigned ``bits`` over [0, 1]; the output layer
    emits BN output directly (argmax logits)."""
    specs = []
    dims = [in_features] + list(widths)
    for i in range(len(widths)):
        first = i == 0
        last = i == len(widths) - 1
        b_in = (input_bits if (first and input_bits is not None) else bits)
        f = (input_fan_in if (first and input_fan_in is not None) else fan_in)
        iq = input_quant(b_in) if first else act_quant(bits)
        oq = act_quant(bits)
        specs.append(LayerSpec(
            n_in=dims[i], n_out=dims[i + 1],
            fan_in=min(f, dims[i]), degree=degree,
            adder_width=adder_width, in_quant=iq, out_quant=oq,
            hidden=hidden, is_output=last,
        ))
    return specs
