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


def _wkv_inputs(B, S, H, K, dtype, cuda, seed, clamp=False):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    r, k, v = (n(B, S, H, K).to(dtype) for _ in range(3))
    logw = (torch.full((B, S, H, K), -1.0, device=cuda) if clamp else
            torch.clamp(-torch.exp(-1.5 + 0.5 * n(B, S, H, K)), min=-1.0))
    return r, k, v, logw, 0.1 * n(H, K), n(B, H, K, K)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,clamp,with_s0", [
    (2, 77, 3, 64, False, True),     # ragged S, LM head size
    (3, 1, 2, 64, False, True),      # one decode token
    (1, 40, 2, 16, False, False),    # s0 = None, smoke head size
    (1, 300, 2, 32, True, False),    # every decay at the clamp
])
def test_wkv6_kernel_matches_plain(cuda, dtype, B, S, H, K, clamp,
                                   with_s0):
    """Kernel 5 against the plain chunk-32 form on the same card, in
    float32 arithmetic on both sides: within 2e-4 of the output scale."""
    from repro_torch.kernels.wkv6 import ops, wkv6
    r, k, v, logw, u, s0 = _wkv_inputs(B, S, H, K, dtype, cuda, seed=S,
                                       clamp=clamp)
    s0 = s0 if with_s0 else None
    wkv6.reset_launch_counts()
    o, s = ops.wkv6(r, k, v, logw, u, s0)
    want_o, want_s = ops.wkv6_reference(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launch_counts() == {"wkv6": 1}
    assert o.dtype == s.dtype == torch.float32
    for got, want in ((o, want_o), (s, want_s)):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 2e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B,n_in,n_out,F", [
    (1024, 784, 256, 6), (37, 50, 19, 3), (5, 70000, 33, 4)])
def test_masked_matmul_kernel_matches_plain(cuda, B, n_in, n_out, F,
                                            with_bias):
    """Kernel 4 against both plain versions (float32; the dense product
    with TF32 off), and its in-kernel range check.  The last shape's rows
    exceed shared memory: the unstaged kernel."""
    from repro_torch.kernels.masked_matmul import masked_matmul as mm
    from repro_torch.kernels.masked_matmul import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(n_in)
    x = torch.randn((B, n_in), generator=g, device=cuda)
    conn = torch.randint(0, n_in, (n_out, F), generator=g, device=cuda,
                         dtype=torch.int32)
    w = torch.randn((n_out, F), generator=g, device=cuda)
    b = torch.randn((n_out,), generator=g, device=cuda) if with_bias \
        else None
    mm.reset_launch_counts()
    got = mm.masked_matmul(x, conn, w, b)
    for want in (ref.masked_matmul(x, conn, w, b),
                 ref.masked_matmul_dense(x, conn, w, n_in, b)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert mm.launch_counts() == {"masked_matmul": 1}
    # an index outside [0, n_in) makes its output NaN, the rest unchanged
    bad = conn.clone()
    bad[0, 0], bad[1, F - 1] = n_in, -1
    y = mm.masked_matmul(x, bad, w, b)
    assert torch.isnan(y[:, :2]).all()
    torch.testing.assert_close(y[:, 2:], got[:, 2:], rtol=0, atol=0)
