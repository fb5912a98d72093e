"""Quantization-aware-training primitives for LUT-DNNs (port of
``repro.core.quant``): uniform quantizers with a straight-through
estimator, and the batch norm the LUT layers train with.

Float32 throughout, with the reference's order of operations, so codes
match it bit for bit: ``to_code`` clips, subtracts ``low``, divides by
``step`` and rounds half to even (``torch.round``, like ``jnp.round``);
``from_code`` multiplies by ``step`` and adds ``low``.

Batch norm is written out rather than taken from ``nn.BatchNorm1d``:
the reference keeps running stats as ``0.9 * old + 0.1 * new`` with the
population variance, where ``BatchNorm1d``'s momentum means the other
weight and its running variance is unbiased.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Fake-quantize with STE: forward = grid value, grad = identity.
        The reference's expression exactly: its forward value is not
        always ``q`` itself in float32, and the next layer's codes
        depend on that rounding."""
        q = self.from_code(self.to_code(x))
        return x + (q - x).detach()

    def all_codes(self, device=None) -> torch.Tensor:
        return torch.arange(self.levels, dtype=torch.int32, device=device)

    def all_values(self, device=None) -> torch.Tensor:
        return self.from_code(self.all_codes(device))


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


@dataclasses.dataclass(frozen=True)
class BatchNormParams:
    """Inference-folded batch-norm: y = x * scale + offset."""

    scale: torch.Tensor
    offset: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset


def bn_init(n: int, device=None) -> dict:
    return {
        "gamma": torch.ones((n,), dtype=torch.float32, device=device),
        "beta": torch.zeros((n,), dtype=torch.float32, device=device),
        "mean": torch.zeros((n,), dtype=torch.float32, device=device),
        "var": torch.ones((n,), dtype=torch.float32, device=device),
    }


def bn_apply_train(p: dict, x: torch.Tensor, momentum: float = 0.9,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    """Training-mode batch norm over leading axes; returns output and
    updated running stats (``momentum * old + (1 - momentum) * new``,
    population variance, as ``jnp.var``)."""
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.var(x, dim=axes, unbiased=False)
    y = (x - mean) / torch.sqrt(var + eps) * p["gamma"] + p["beta"]
    new_p = dict(p)
    new_p["mean"] = momentum * p["mean"] + (1 - momentum) * mean.detach()
    new_p["var"] = momentum * p["var"] + (1 - momentum) * var.detach()
    return y, new_p


def bn_apply_eval(p: dict, x: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    return (x - p["mean"]) / torch.sqrt(p["var"] + eps) * p["gamma"] \
        + p["beta"]


def bn_fold(p: dict, eps: float = 1e-5) -> BatchNormParams:
    """Fold running stats into an affine (scale, offset) pair for the
    truth-table synthesiser."""
    inv = p["gamma"] / torch.sqrt(p["var"] + eps)
    return BatchNormParams(scale=inv, offset=p["beta"] - p["mean"] * inv)
