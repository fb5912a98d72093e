"""LUT-DNN network configuration (port of ``repro.core.lutdnn.
ModelSpec``).  The trainers and the connectivity search come with the
training port."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import layers as L


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A full LUT-DNN configuration (one row of paper Table III / V)."""

    name: str
    in_features: int
    widths: Tuple[int, ...]
    bits: int                   # beta
    fan_in: int                 # F
    degree: int = 1             # D
    adder_width: int = 1        # A
    input_bits: Optional[int] = None   # beta_i
    input_fan_in: Optional[int] = None  # F_i
    hidden: Tuple[int, ...] = ()        # NeuraLUT sub-net widths

    def layer_specs(self) -> list:
        return L.make_layer_specs(
            self.in_features, self.widths, self.bits, self.fan_in,
            self.degree, self.adder_width, self.input_bits,
            self.input_fan_in, self.hidden)

    @property
    def table_entries(self) -> int:
        return sum(s.layer_table_entries for s in self.layer_specs())
