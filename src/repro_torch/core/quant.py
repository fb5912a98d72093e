"""Uniform quantizers of the LUT-DNN activation edges (port of
``repro.core.quant``: ``QuantSpec``, ``input_quant``, ``act_quant``,
``adder_quant``).

Float32 throughout, with the reference's order of operations, so codes
match it bit for bit: ``to_code`` clips, subtracts ``low``, divides by
``step`` and rounds half to even (``torch.round``, like ``jnp.round``);
``from_code`` multiplies by ``step`` and adds ``low``.  Batch norm and
the straight-through ``quantize`` are training-side and come with the
training port.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A uniform quantizer: ``2**bits`` levels spanning ``[low, high]``
    inclusive."""

    bits: int
    low: float = 0.0
    high: float = 1.0

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def step(self) -> float:
        return (self.high - self.low) / (self.levels - 1)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, self.low, self.high)

    def to_code(self, x: torch.Tensor) -> torch.Tensor:
        """Real value -> integer code in [0, 2**bits)."""
        xc = self.clip(x)
        return torch.round((xc - self.low) / self.step).to(torch.int32)

    def from_code(self, code: torch.Tensor) -> torch.Tensor:
        """Integer code -> real grid value (float32)."""
        return code.to(torch.float32) * self.step + self.low

    def all_codes(self, device=None) -> torch.Tensor:
        return torch.arange(self.levels, dtype=torch.int32, device=device)


def input_quant(bits: int) -> QuantSpec:
    """Input quantizer: signed range [-1, 1]."""
    return QuantSpec(bits=bits, low=-1.0, high=1.0)


def act_quant(bits: int) -> QuantSpec:
    """Post-ReLU activation quantizer: non-negative range [0, 1]."""
    return QuantSpec(bits=bits, low=0.0, high=1.0)


def adder_quant(bits: int, fan_in: int) -> QuantSpec:
    """Sub-neuron output quantizer feeding the A-input adder: one extra
    bit of resolution over [-1, 1] (the adder's internal word is
    beta + 1 bits)."""
    del fan_in
    return QuantSpec(bits=bits + 1, low=-1.0, high=1.0)
