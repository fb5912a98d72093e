"""Paper model setups (SparseLUT Tables III & V).

One ModelSpec per row; ``D`` (polynomial degree) is left as an argument
since every row is evaluated at D = 1 (LogicNets-equivalent) and D = 2.

    HDR          MNIST  256,100,100,100,100,10  beta=2 F=6
    HDR-Add2     MNIST  same widths             beta=2 F=4 A=2
    HDR-5L       MNIST  256,100,100,100,10      beta=2 F=6 (NeuraLUT)
    JSC-XL       JSC    128,64,64,64,5          beta=5 F=3 (beta_i=7 F_i=2)
    JSC-XL-Add2  JSC    same                    beta=5 F=2 A=2 (F_i=1)
    JSC-M Lite   JSC    64,32,5                 beta=3 F=4
    JSC-M-Add2   JSC    64,32,5                 beta=3 F=2 A=2
    JSC-2L       JSC    32,5                    beta=4 F=3 (NeuraLUT)
    CIFAR-10 rows reuse the HDR topologies on 3072 inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.lutdnn import ModelSpec

MNIST_IN, JSC_IN, CIFAR_IN = 784, 16, 3072

# NeuraLUT sub-net width (network-in-network hidden layers inside a LUT)
NEURALUT_HIDDEN: Tuple[int, ...] = (8,)


def hdr(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"HDR(D={degree})", in_features=MNIST_IN,
                     widths=(256, 100, 100, 100, 100, 10), bits=2,
                     fan_in=6, degree=degree)


def hdr_add2(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"HDR-Add2(D={degree})", in_features=MNIST_IN,
                     widths=(256, 100, 100, 100, 100, 10), bits=2,
                     fan_in=4, degree=degree, adder_width=2)


def hdr_add(adder: int, degree: int = 1, fan_in: int = 6) -> ModelSpec:
    return ModelSpec(name=f"HDR-Add{adder}(D={degree},F={fan_in})",
                     in_features=MNIST_IN,
                     widths=(256, 100, 100, 100, 100, 10), bits=2,
                     fan_in=fan_in, degree=degree, adder_width=adder)


def hdr_5l() -> ModelSpec:
    return ModelSpec(name="HDR-5L", in_features=MNIST_IN,
                     widths=(256, 100, 100, 100, 10), bits=2, fan_in=6,
                     hidden=NEURALUT_HIDDEN)


def jsc_xl(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"JSC-XL(D={degree})", in_features=JSC_IN,
                     widths=(128, 64, 64, 64, 5), bits=5, fan_in=3,
                     degree=degree, input_bits=7, input_fan_in=2)


def jsc_xl_add2(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"JSC-XL-Add2(D={degree})", in_features=JSC_IN,
                     widths=(128, 64, 64, 64, 5), bits=5, fan_in=2,
                     degree=degree, adder_width=2, input_bits=7,
                     input_fan_in=1)


def jsc_m_lite(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"JSC-M Lite(D={degree})", in_features=JSC_IN,
                     widths=(64, 32, 5), bits=3, fan_in=4, degree=degree)


def jsc_m_lite_add2(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"JSC-M Lite-Add2(D={degree})", in_features=JSC_IN,
                     widths=(64, 32, 5), bits=3, fan_in=2, degree=degree,
                     adder_width=2)


def jsc_2l() -> ModelSpec:
    return ModelSpec(name="JSC-2L", in_features=JSC_IN, widths=(32, 5),
                     bits=4, fan_in=3, hidden=NEURALUT_HIDDEN)


def cifar_hdr(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"CIFAR-HDR(D={degree})", in_features=CIFAR_IN,
                     widths=(256, 100, 100, 100, 100, 10), bits=2,
                     fan_in=6, degree=degree)


def cifar_hdr_add2(degree: int = 1) -> ModelSpec:
    return ModelSpec(name=f"CIFAR-HDR-Add2(D={degree})",
                     in_features=CIFAR_IN,
                     widths=(256, 100, 100, 100, 100, 10), bits=2,
                     fan_in=4, degree=degree, adder_width=2)


# deeper / wider variants for the Fig.-7 sweep -----------------------------

def deeper(spec: ModelSpec, depth_factor: int) -> ModelSpec:
    """PolyLUT-Deeper: repeat each hidden layer D-fold (paper Fig. 7)."""
    hidden, out = spec.widths[:-1], spec.widths[-1]
    widths = tuple(w for w in hidden for _ in range(depth_factor)) + (out,)
    import dataclasses
    return dataclasses.replace(
        spec, name=spec.name + f"-Deep{depth_factor}", widths=widths)


def wider(spec: ModelSpec, width_factor: int) -> ModelSpec:
    """PolyLUT-Wider: multiply hidden widths (paper Fig. 7)."""
    widths = tuple(w * width_factor for w in spec.widths[:-1]) \
        + (spec.widths[-1],)
    import dataclasses
    return dataclasses.replace(
        spec, name=spec.name + f"-Wide{width_factor}", widths=widths)


# reduced variants for fast CPU tests/benchmarks ---------------------------

def tiny(dataset: str = "jsc", degree: int = 1, adder_width: int = 1,
         fan_in: int = 3, bits: int = 2,
         hidden: Tuple[int, ...] = ()) -> ModelSpec:
    n_in = {"mnist": MNIST_IN, "jsc": JSC_IN, "cifar10": CIFAR_IN}[dataset]
    n_cls = {"mnist": 10, "jsc": 5, "cifar10": 10}[dataset]
    return ModelSpec(name=f"tiny-{dataset}", in_features=n_in,
                     widths=(32, 16, n_cls), bits=bits, fan_in=fan_in,
                     degree=degree, adder_width=adder_width, hidden=hidden)
