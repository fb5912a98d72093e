"""Analytic FPGA cost model (the 'modelling twist').

This container has no Vivado, so the paper's hardware numbers (Tables
II/IV/VIII, Fig. 10) are reproduced through a structural 6-LUT model
calibrated on the paper's own reported rows.  The model is documented
and deterministic; benchmarks print modeled vs paper-reported values
side by side so the *ratios* the paper claims (2.0-13.9x LUT savings,
1.2-1.6x latency) can be validated.

Structure
---------
* A p-input, 1-bit Boolean function costs ``T(p)`` LUT6s:
  data LUTs ``2^(p-6)`` (F7/F8 muxes free up to p=8) plus a 4:1-mux
  tree (one LUT6 per 4:1) above that.
* Logic synthesis compresses truth tables (don't-cares, shared
  sub-functions).  We model it as an efficiency factor
  ``eta(p) = ETA0 + ETA1 * (p - 12)`` — entry-bits-per-LUT6 relative to
  the raw 64 — calibrated by least squares on paper Table II
  (HDR / JSC-XL / JSC-M Lite rows).
* ``F_max = FMAX_A * (total_LUT6 ** -FMAX_P)`` — routing congestion
  power law, calibrated on the same rows.
* Pipeline latency = one cycle per layer (the paper's designs are fully
  pipelined; the adder+BN LUT of PolyLUT-Add is absorbed into the layer
  stage, matching Table II's equal cycle counts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core.lutdnn import ModelSpec

# calibration constants (fit to paper Table II; see module docstring)
ETA0 = 2.0      # entry-bit compression at p = 12
ETA1 = 0.45     # added compression per extra input bit
FMAX_A = 26500.0
FMAX_P = 0.4
FMAX_CAP = 900.0


def mux_tree_luts(n_blocks: int) -> int:
    """LUT6s to mux ``n_blocks`` 8-input blocks (4:1 mux per LUT6)."""
    total = 0
    while n_blocks > 1:
        n_blocks = math.ceil(n_blocks / 4)
        total += n_blocks
    return total


def lut6_per_bit(p: int) -> float:
    """Structural LUT6 count for one p-input output bit, pre-synthesis."""
    if p <= 6:
        return 1.0
    data = 2 ** (p - 6)
    blocks = max(1, 2 ** (p - 8))   # F7/F8 merge 4 LUT6 into an 8-input block
    return data + mux_tree_luts(blocks)


def synthesis_eff(p: int) -> float:
    return max(1.0, ETA0 + ETA1 * (p - 12))


def table_luts(p_inputs: int, q_bits: int) -> float:
    """Physical LUT6 estimate for a p-input, q-output-bit truth table."""
    return q_bits * lut6_per_bit(p_inputs) / synthesis_eff(p_inputs)


def adder_stage_luts(adder_width: int, sub_bits: int, out_bits: int) -> float:
    """PolyLUT-Add's adder layer: Vivado implements the A-input adder +
    BN affine + requantization as carry-chain arithmetic whenever that
    is cheaper than the enumerated truth table (it is structured
    arithmetic, not random logic).  Model: (A-1) ripple adders of
    sub_bits+log2(A) bits + ~8 LUT6/output-bit for the affine compare
    chain; take the min against the raw table."""
    arith = (adder_width - 1) * (sub_bits + math.ceil(math.log2(adder_width))
                                 ) + 8.0 * out_bits
    table = table_luts(adder_width * sub_bits, out_bits)
    return min(arith, table)


@dataclasses.dataclass
class HardwareReport:
    name: str
    table_entries: int
    lut6: int
    ff: int
    fmax_mhz: float
    cycles: int
    latency_ns: float

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def model_cost(spec: ModelSpec) -> HardwareReport:
    specs = spec.layer_specs()
    total_luts = 0.0
    total_ff = 0
    for i, s in enumerate(specs):
        out_bits = 16 if s.is_output else s.out_quant.bits
        p_sub = s.in_quant.bits * s.fan_in
        sub_out_bits = (s.sub_quant.bits if s.adder_width > 1 else out_bits)
        total_luts += s.n_out * s.adder_width * table_luts(p_sub, sub_out_bits)
        if s.adder_width > 1:
            total_luts += s.n_out * adder_stage_luts(
                s.adder_width, s.sub_quant.bits, out_bits)
        # pipeline registers at each layer boundary
        total_ff += s.n_out * out_bits
    cycles = len(specs)
    fmax = min(FMAX_CAP, FMAX_A * max(total_luts, 1.0) ** (-FMAX_P))
    latency_ns = cycles / fmax * 1e3
    return HardwareReport(
        name=spec.name,
        table_entries=spec.table_entries,
        lut6=int(round(total_luts)),
        ff=int(total_ff),
        fmax_mhz=round(fmax, 1),
        cycles=cycles,
        latency_ns=round(latency_ns, 2),
    )


def compare(specs: List[ModelSpec]) -> List[Dict]:
    return [model_cost(s).row() for s in specs]


def lut_reduction(base: ModelSpec, ours: ModelSpec) -> float:
    return model_cost(base).lut6 / max(model_cost(ours).lut6, 1)


def latency_reduction(base: ModelSpec, ours: ModelSpec) -> float:
    return model_cost(base).latency_ns / max(model_cost(ours).latency_ns, 1e-9)
