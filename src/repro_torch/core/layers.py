"""LUT-DNN layer specifications (port of the data half of
``repro.core.layers``: ``LayerSpec`` and ``make_layer_specs``).

A layer is a static ``LayerSpec``; connectivity is data, an int32
gather table ``conn`` of shape (n_out, A, F).  The training forward and
parameter initialisation come with the training port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.quant import (QuantSpec, act_quant, adder_quant,
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
        """Monomials of degree 1..D in F variables: C(F + D, D) - 1."""
        return math.comb(self.fan_in + self.degree, self.degree) - 1

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
