"""CUDA LUT kernels on the card (``gpu`` marker): each kernel against
its plain PyTorch version, bit for bit, and the committed golden
vectors.  The kernels have no CPU mode, so without a card these tests
skip; on the card run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest configures JAX, which the
card's machine does not have.)  This file imports no JAX."""
import pathlib

import numpy as np
import pytest
import torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA LUT kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _engines(tables, n_in0):
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    args = ops._layer_args(tables, n_in0, check_conn=True)
    net = K.FusedNet(args)

    def per_layer(c):
        for a in args:
            c = K.lut_gather(c, a)
        return c

    return {"fused": lambda c: K.lut_network_fused(c, net),
            "pipelined": lambda c: K.lut_network_fused(c, net,
                                                       pipeline=True),
            "per_layer": per_layer,
            "plain": lambda c: ref.lut_network(
                c, [a.plain() for a in args])}


@pytest.mark.gpu
@pytest.mark.parametrize("unpack", [True, False])
def test_kernels_reproduce_golden(cuda, unpack):
    from repro_torch.artifact import load_artifact
    from repro_torch.kernels.lut_gather import lut_gather as K
    io = np.load(GOLDEN / "golden_io.npz")
    art = load_artifact(str(GOLDEN), unpack_int4=unpack, device=cuda)
    codes = torch.from_numpy(io["inputs"]).to(cuda)
    K.reset_launch_counts()
    for name, fn in _engines(art.tables, art.n_in).items():
        got = fn(codes).cpu().numpy()
        np.testing.assert_array_equal(got, io["outputs"], err_msg=name)
    counts = K.launch_counts()
    assert counts == {"lut_gather": len(art.tables),
                      "lut_network_fused": 1,
                      "lut_network_fused_pipelined": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_kernels_match_plain_on_ragged_batches(cuda, B):
    from repro_torch.artifact import load_artifact
    art = load_artifact(str(GOLDEN), unpack_int4=False, device=cuda)
    rng = np.random.default_rng(B)
    # codes up to 7 on a 2-bit grid: out-of-range requests stay inside
    # their slab rows and still agree with the plain version
    codes = torch.from_numpy(rng.integers(0, 8, (B, art.n_in)).astype(
        np.int32)).to(cuda)
    engines = _engines(art.tables, art.n_in)
    want = engines.pop("plain")(codes)
    for name, fn in engines.items():
        assert torch.equal(fn(codes), want), name


@pytest.mark.gpu
def test_wrapper_refuses_mismatched_devices(cuda):
    from repro_torch.artifact import load_artifact
    from repro_torch.kernels.lut_gather import ops
    art = load_artifact(str(GOLDEN), device=cuda)
    fn = ops.make_network_fn(art, device=cuda)
    with pytest.raises(ValueError):
        fn(torch.zeros((4, art.n_in), dtype=torch.int32))   # CPU codes
    with pytest.raises(TypeError):
        fn(torch.zeros((4, art.n_in), dtype=torch.int64, device=cuda))
