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
            "per_layer_chain": lambda c: K.lut_layers(c, net),
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
    assert counts == {"lut_gather": 2 * len(art.tables),
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
    # int64 codes on the card are cast to int32, as on the CPU
    # (test_wrapper_contract)
    codes = torch.ones((4, art.n_in), dtype=torch.int64, device=cuda)
    assert torch.equal(fn(codes), fn(codes.int()))


def _contract_cases(wrapper, dev):
    """(call, good int32 input, the same input as int64, inputs of a
    wrong width, a float input) for one wrapper on ``dev``."""
    from repro_torch.artifact import load_artifact
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    rng = np.random.default_rng(5)
    if wrapper == "masked_matmul":
        x = torch.from_numpy(rng.standard_normal((8, 10)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((3, 2)).astype(
            np.float32)).to(dev)
        conn = torch.from_numpy(rng.integers(0, 10, (3, 2)).astype(
            np.int32)).to(dev)
        return (lambda c: MM.masked_matmul(x, c, w), conn, conn.long(),
                [conn[:, :1].contiguous(), conn.reshape(-1)],
                conn.float())
    art = load_artifact(str(GOLDEN), device=dev)
    args = ops._layer_args(art.tables, art.n_in, check_conn=True)
    net = K.FusedNet(args)
    call = {"lut_gather": lambda c: K.lut_gather(c, args[0]),
            "lut_layers": lambda c: K.lut_layers(c, net),
            "lut_network_fused": lambda c: K.lut_network_fused(c, net)
            }[wrapper]
    codes = torch.from_numpy(rng.integers(0, 4, (8, art.n_in)).astype(
        np.int32)).to(dev)
    wide = torch.zeros((8, art.n_in + 3), dtype=torch.int32, device=dev)
    return (call, codes, codes.long(),
            [wide, codes[:, :-1].contiguous(), codes[0]], codes.float())


@pytest.mark.parametrize("wrapper", ["lut_gather", "lut_layers",
                                     "lut_network_fused", "masked_matmul"])
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_wrapper_contract(device, wrapper, request):
    """One contract for a wrapper's integer input (LUT codes, the
    masked matmul's conn) on both branches, checked before the device
    branch: int64 is cast to int32 and answers as int32 does, a
    non-contiguous view answers as its copy does, a wrong width raises
    ValueError and a float dtype TypeError."""
    dev = (request.getfixturevalue("cuda") if device == "cuda"
           else torch.device("cpu"))
    call, good, as_int64, wrong_width, as_float = _contract_cases(
        wrapper, dev)
    want = call(good)
    assert torch.equal(call(as_int64), want)
    strided = good.t().contiguous().t()
    assert not strided.is_contiguous() or good.shape[0] == 1
    assert torch.equal(call(strided), want)
    for bad in wrong_width:
        with pytest.raises(ValueError):
            call(bad)
    with pytest.raises(TypeError):
        call(as_float)


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


# (B, n_in, n_out, offset, walks): ragged batches, rows not a multiple of
# 4 floats, an x starting ``offset`` floats past a 16-byte boundary,
# neuron counts off 32 and over one block, and batches past what the
# card holds resident (``walks``: blocks walk more tiles than the ring
# has stages, so stages are refilled)
MM_CASES = [(37, 50, 19, 0, False), (1000, 37, 300, 1, False),
            (16384, 784, 250, 0, True), (9000, 1001, 129, 1, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 2, 6, 8, 12])
@pytest.mark.parametrize("B,n_in,n_out,offset,walks", MM_CASES)
def test_masked_matmul_kernel_geometries(cuda, B, n_in, n_out, offset,
                                         walks, F):
    """Kernel 4 against both plain versions at every compiled fan-in
    (1-8) and the generic one (12), through the geometries above; an
    index outside [0, n_in) makes NaN of its neuron's outputs only."""
    from repro_torch.kernels.masked_matmul import masked_matmul as mm
    from repro_torch.kernels.masked_matmul import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(B + n_in + F)
    flat = torch.randn((B * n_in + offset,), generator=g, device=cuda)
    x = flat[offset:].view(B, n_in)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    conn = torch.randint(0, n_in, (n_out, F), generator=g, device=cuda,
                         dtype=torch.int32)
    w = torch.randn((n_out, F), generator=g, device=cuda)
    b = torch.randn((n_out,), generator=g, device=cuda)
    geo = mm.mm_geometry(B, torch.cuda.get_device_properties(
        cuda).multi_processor_count, n_in, n_out, F)
    assert (geo.tiles > geo.stages) == walks, geo
    mm.reset_launch_counts()
    got = mm.masked_matmul(x, conn, w, b)
    for want in (ref.masked_matmul(x, conn, w, b),
                 ref.masked_matmul_dense(x, conn, w, n_in, b)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert mm.launch_counts() == {"masked_matmul": 1}
    bad = conn.clone()
    bad[0, 0], bad[n_out - 1, F - 1] = n_in, -1
    y = mm.masked_matmul(x, bad, w, b)
    assert torch.isnan(y[:, 0]).all() and torch.isnan(y[:, -1]).all()
    torch.testing.assert_close(y[:, 1:-1], got[:, 1:-1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# kernel 1's instantiations, its generic path, and kernels 2-3 beside it
# ---------------------------------------------------------------------------

# (A, F) of the paper's models, each a compiled instantiation of the fused
# kernels' per-layer code, and two that take its generic path
AF_INSTANTIATED = [(1, 6), (2, 4), (1, 3), (1, 2), (2, 2), (2, 1), (1, 4)]
AF_GENERIC = [(3, 2), (1, 5)]
FUSED_BATCHES = (1, 2, 255, 256, 257, 4096)


def _nibble_pack(t):
    """(..., K) codes <= 15 -> (..., K/2) uint8, low nibble first."""
    t = t.to(torch.uint8)
    return (t[..., 0::2] | (t[..., 1::2] << 4)).contiguous()


def _random_net(A, F, enc, adder, device, seed, n_in0=40,
                widths=(64, 48, 10), in_bits=(2, 2, 2)):
    """Layer arguments of a random network: every layer (A, F), 2-bit
    output codes (3-bit sub-codes under the adder), slabs in ``enc``
    (uint8 / int32 / int4-packed)."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    rng = np.random.default_rng(seed)
    layers, n_in = [], n_in0
    for n_out, ib in zip(widths, in_bits):
        Kw = 2 ** (ib * F)
        sub_bits = 3 if adder else 2
        conn = torch.from_numpy(rng.integers(0, n_in, (n_out, A, F)).astype(
            np.int32)).to(device)
        sub = torch.from_numpy(rng.integers(0, 2 ** sub_bits, (n_out, A, Kw)))
        add = torch.from_numpy(rng.integers(0, 4, (n_out, 2 ** (A * sub_bits))
                                            if adder else (n_out, 0)))
        dt = torch.int32 if enc == "int32" else torch.uint8
        sub, add = sub.to(dt), add.to(dt)
        if enc == "int4":
            sub = _nibble_pack(sub)
            add = _nibble_pack(add) if adder else add
        layers.append(K.layer_args(
            conn, sub.to(device), add.to(device), ib, sub_bits,
            enc == "int4", enc == "int4" and adder, n_in=n_in,
            check_conn=True))
        n_in = n_out
    return layers


def _all_kernels_match(layers, codes):
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    net = K.FusedNet(layers)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    c = codes
    for a in layers:
        c = K.lut_gather(c, a)
    for name, got in (("fused", K.lut_network_fused(codes, net)),
                      ("pipelined", K.lut_network_fused(codes, net,
                                                        pipeline=True)),
                      ("per_layer", c),
                      ("per_layer_chain", K.lut_layers(codes, net))):
        assert torch.equal(got, want), name


@pytest.mark.gpu
@pytest.mark.parametrize("adder", [True, False])
@pytest.mark.parametrize("enc", ["uint8", "int32", "int4"])
@pytest.mark.parametrize("A,F", AF_INSTANTIATED + AF_GENERIC)
def test_fused_instantiations_match_plain(cuda, A, F, enc, adder):
    """Every (A, F) instantiation of the kernels' per-layer code and the
    generic path, each slab encoding, adder on and off: kernels 1-3
    (kernel 3 one call a layer and as the one-call chain) equal the
    plain version bit for bit at batches around the geometry's steps."""
    layers = _random_net(A, F, enc, adder, cuda, seed=A * 10 + F)
    rng = np.random.default_rng(F)
    for B in FUSED_BATCHES:
        codes = torch.from_numpy(rng.integers(0, 4, (B, 40)).astype(
            np.int32)).to(cuda)
        _all_kernels_match(layers, codes)


@pytest.mark.gpu
@pytest.mark.parametrize("A,F,in_bits", [(2, 2, 5), (1, 3, 4), (3, 2, 5)])
def test_fused_layer0_wild_codes_match_plain(cuda, A, F, in_bits):
    """Request codes anywhere in int32, negative included, through a first
    layer whose table rows hold 2^(in_bits*F) >= 1024 entries (as
    JSC-XL-Add2's hidden layers): masked to the row after packing,
    exactly as the plain version does."""
    layers = _random_net(A, F, "uint8", A > 1, cuda, seed=in_bits,
                         in_bits=(in_bits, 2, 2))
    rng = np.random.default_rng(in_bits)
    for B in (1, 256, 4096):
        codes = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (B, 40), dtype=np.int64).astype(
                np.int32)).to(cuda)
        _all_kernels_match(layers, codes)


@pytest.mark.gpu
def test_fused_geometry_overrides_match_plain(cuda):
    """Any rows per block within the cap gives the same codes."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    layers = _random_net(2, 4, "int4", True, cuda, seed=5)
    net = K.FusedNet(layers)
    codes = torch.from_numpy(np.random.default_rng(5).integers(
        0, 4, (1000, 40)).astype(np.int32)).to(cuda)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    for rows in (1, 3, 8, 30, 32):
        for pipeline in (False, True):
            got = K.lut_network_fused(codes, net, rows=rows,
                                      pipeline=pipeline)
            assert torch.equal(got, want), (rows, pipeline)


# ---------------------------------------------------------------------------
# kernel 2's ring of stages and kernel 3's one-call chain
# ---------------------------------------------------------------------------

def _codes_at(cuda, rng, B, n_in, offset=0):
    """(B, n_in) int32 codes on the card whose first code lies ``offset``
    codes past a 16-byte boundary (a view into a larger buffer)."""
    buf = torch.empty((B * n_in + offset,), dtype=torch.int32, device=cuda)
    codes = buf[offset:].view(B, n_in)
    codes.copy_(torch.from_numpy(rng.integers(0, 4, (B, n_in)).astype(
        np.int32)))
    assert codes.data_ptr() % 16 == 4 * offset
    return codes


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 257, 1000, 4096])
def test_pipelined_kernel_batches(cuda, B):
    """Kernel 2 at the geometry it picks for each batch, HDR-Add2's (2, 4)
    per-layer code on int4 slabs: equal to the plain version."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    layers = _random_net(2, 4, "int4", True, cuda, seed=B)
    net = K.FusedNet(layers)
    codes = _codes_at(cuda, np.random.default_rng(B), B, 40)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    assert torch.equal(K.lut_network_fused(codes, net, pipeline=True), want)


def _pipelined_capacity(K, net, rows):
    """Blocks of ``rows`` rows the card holds resident for kernel 2 (one
    input stage): past that many tiles a block walks several."""
    g = net.geometry(1, True, rows=rows)
    one = K.fused_smem_bytes(net.n_in0, net.widths, rows, True, 1)
    return K.resident_blocks(g.threads, one) * net.n_sms


@pytest.mark.gpu
@pytest.mark.parametrize("n_in0", [40, 37])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("rows,tiles", [(2, 3), (3, 4), (5, 7), (1, 9)])
def test_pipelined_ring_wraps(cuda, rows, tiles, offset, n_in0):
    """Blocks that walk three or more tiles through the two-stage ring
    (each stage refilled and waited on again), reached by batches past
    what the card holds a block each for a narrow net; ragged last tiles
    (B not a multiple of rows), and tiles that start 0-3 codes past a
    16-byte boundary (an input width of 37 codes, codes at an offset):
    the bulk copies' head and tail and the stages' slack.  Equal to the
    plain version."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    layers = _random_net(2, 2, "uint8", True, cuda, seed=rows, n_in0=n_in0)
    net = K.FusedNet(layers)
    cap = _pipelined_capacity(K, net, rows)
    rng = np.random.default_rng(rows * 10 + offset)
    for B in (rows * (cap * (tiles - 1) + 5) + 1,
              rows * (cap * tiles - 1) + 1):
        codes = _codes_at(cuda, rng, B, n_in0, offset)
        want = ref.lut_network(codes, [a.plain() for a in layers])
        g = net.geometry(B, True, rows=rows)
        assert (g.tiles, g.stages) == (tiles, 2), (B, g)
        assert g.grid * g.tiles >= -(-B // rows)
        got = K.lut_network_fused(codes, net, pipeline=True, rows=rows)
        assert torch.equal(got, want), (B, rows, tiles, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [4, None])
def test_pipelined_one_stage_walks_tiles(cuda, rows):
    """Blocks that walk several tiles through a one-stage ring (a second
    stage would cost resident blocks, at HDR-Add2's 784 input codes): each
    tile's copy is issued once the tile before it is done.  At 4 rows a
    block forced, and as the geometry picks it for a batch past what the
    card holds a block each.  Equal to the plain version."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    layers = _random_net(2, 4, "int4", True, cuda, seed=rows or 0,
                         n_in0=784, widths=(256, 100, 10))
    net = K.FusedNet(layers)
    B = 20000 if rows is None else \
        rows * (2 * _pipelined_capacity(K, net, rows) + 5) + 1
    g = net.geometry(B, True, rows=rows)
    assert g.stages == 1 and g.tiles >= 3, g
    codes = _codes_at(cuda, np.random.default_rng(B), B, 784, 1)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    assert torch.equal(K.lut_network_fused(codes, net, pipeline=True,
                                           rows=rows), want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 256, 1000, 4096, 20000])
def test_per_layer_chain_matches_per_layer_calls(cuda, B):
    """Kernel 3's one-call chain against one ``lut_gather`` call a layer
    and the plain version, at the geometry each picks: 1 to 32 rows a
    block, and at B=1 and 33 the 600 neurons of the first layer split
    over blocks; one launch a layer counted."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    layers = _random_net(2, 4, "int4", True, cuda, seed=B + 1, n_in0=37,
                         widths=(600, 100, 10))
    net = K.FusedNet(layers)
    assert (net.layer_geometries(B)[0].neuron_tiles > 1) == (B <= 33)
    codes = _codes_at(cuda, np.random.default_rng(B), B, 37, B % 4)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    c = codes
    for a in layers:
        c = K.lut_gather(c, a)
    assert torch.equal(c, want)
    K.reset_launch_counts()
    assert torch.equal(K.lut_layers(codes, net), want)
    assert K.launch_counts()["lut_gather"] == len(layers)


@pytest.mark.gpu
def test_per_layer_kernel_unstaged_wide_layer(cuda):
    """A first layer too wide for one staged row (70,000 input codes):
    kernel 3 reads its codes from device memory and still equals the
    plain version; the planner sends such a network per layer."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    layers = _random_net(1, 3, "uint8", False, cuda, seed=7, n_in0=70_000,
                         widths=(64, 10), in_bits=(2, 2))
    net = K.FusedNet(layers)
    assert net.layer_geometries(5)[0].smem_bytes == 0
    codes = _codes_at(cuda, np.random.default_rng(7), 5, 70_000)
    want = ref.lut_network(codes, [a.plain() for a in layers])
    assert torch.equal(K.lut_layers(codes, net), want)
    assert K.block_rows(70_000, net.widths, False) == 0


# ---------------------------------------------------------------------------
# kernel 5 across head sizes, lengths, grids and column splits
# ---------------------------------------------------------------------------

def _wkv_check(cuda, B, S, H, K, dtype, with_s0, clamp, seed):
    from repro_torch.kernels.wkv6 import ops
    r, k, v, logw, u, s0 = _wkv_inputs(B, S, H, K, dtype, cuda, seed=seed,
                                       clamp=clamp)
    s0 = s0 if with_s0 else None
    want_o, want_s = ops.wkv6_reference(r, k, v, logw, u, s0)
    o, s = ops.wkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    for got, want in ((o, want_o), (s, want_s)):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 2e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 3, 31, 32, 33, 77, 512])
@pytest.mark.parametrize("K", [16, 32, 64])
def test_wkv6_kernel_lengths_and_grids(cuda, K, S, dtype):
    """Lengths on both sides of the unstaged decode path (S <= 2, its
    own tile) and around the 16-token staging chunk, B*H far below (2)
    and far above (640) the card's 132 SMs, with and without a state:
    within 2e-4 of the output scale."""
    _wkv_check(cuda, 1, S, 2, K, dtype, with_s0=True, clamp=False, seed=S)
    _wkv_check(cuda, 16, S, 40, K, dtype, with_s0=False, clamp=False,
               seed=S + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [16, 32, 64])
def test_wkv6_kernel_finite_at_the_clamp(cuda, K, dtype):
    """Every decay at the clamp over 512 tokens: finite and within 2e-4."""
    _wkv_check(cuda, 2, 512, 3, K, dtype, with_s0=True, clamp=True, seed=K)
    _wkv_check(cuda, 2, 512, 3, K, dtype, with_s0=False, clamp=True,
               seed=K + 1)


# ---------------------------------------------------------------------------
# kernels on a second card
# ---------------------------------------------------------------------------

ROOT = GOLDEN.parent.parent

TWO_CARD_PROBE = """
import sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1] + "/tests", sys.argv[1]]
import test_torch_kernels_gpu as T
T.two_card_kernels(int(sys.argv[2]), int(sys.argv[3]))
print("ok")
"""


def two_card_kernels(first: int, second: int) -> None:
    """Kernels 1-5 on card ``first``, then the same calls on card
    ``second``, each against its plain version on that card (LUT
    kernels bit for bit, kernel 4 within 1e-5, WKV6 within 2e-4 of the
    output scale).  Kernels 1-3 run at geometries whose dynamic shared
    memory exceeds 48 KB, which a launch may take only after its device
    allowed it (``cudaFuncSetAttribute`` acts on the current device)."""
    import chip_smoke
    from repro_torch.configs import paper_models as PM
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops as lops
    from repro_torch.kernels.lut_gather import ref as lref
    from repro_torch.kernels.masked_matmul import masked_matmul as mm
    from repro_torch.kernels.masked_matmul import ref as mref
    from repro_torch.kernels.wkv6 import ops as wops

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = PM.hdr_add2()
    for index in (first, second):
        dev = torch.device("cuda", index)
        tables = chip_smoke.random_tables(spec, 11, dev)
        args = lops._layer_args(tables, spec.in_features, check_conn=True)
        net = K.FusedNet(args)
        rng = np.random.default_rng(index)
        for B, call in (
                (4096, lambda c: K.lut_network_fused(c, net, rows=32)),
                (4096, lambda c: K.lut_network_fused(c, net, rows=16,
                                                     pipeline=True)),
                (17000, lambda c: K.lut_layers(c, net))):
            codes = torch.from_numpy(rng.integers(
                0, 4, (B, spec.in_features)).astype(np.int32)).to(dev)
            want = lref.lut_network(codes, [a.plain() for a in args])
            assert torch.equal(call(codes), want), (index, B)
        g = torch.Generator(device=dev).manual_seed(index)
        x = torch.randn((16384, 784), generator=g, device=dev)
        conn = torch.randint(0, 784, (256, 6), generator=g, device=dev,
                             dtype=torch.int32)
        w = torch.randn((256, 6), generator=g, device=dev)
        torch.testing.assert_close(mm.masked_matmul(x, conn, w),
                                   mref.masked_matmul(x, conn, w),
                                   rtol=1e-5, atol=1e-5)
        r, k, v, logw, u, s0 = _wkv_inputs(2, 77, 3, 64, torch.bfloat16,
                                           dev, seed=index)
        for got, want in zip(wops.wkv6(r, k, v, logw, u, s0),
                             wops.wkv6_reference(r, k, v, logw, u, s0)):
            err = (got - want).abs().max().item()
            assert err <= 2e-4 * max(1.0, want.abs().max().item()), err
        torch.cuda.synchronize(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["0-1", "1-0"])
def test_kernels_on_a_second_card(order):
    """Each order in a fresh process, so nothing was set on either card
    before: the attributes the CUDA sources remember are remembered per
    device, and a launch on the second card is not refused."""
    import subprocess
    import sys
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the kernels' per-device "
                    "launch attributes are checked on a second card")
    proc = subprocess.run(
        [sys.executable, "-c", TWO_CARD_PROBE, str(ROOT), *map(str, order)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout[-2000:] + proc.stderr[-4000:]


def _one_card_mesh(device):
    from repro_torch.parallel.sharding import Mesh
    return Mesh(np.array([device] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))


@pytest.mark.gpu
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_apply_ep_on_one_card_matches_cpu(cuda, no_drop):
    """The expert-parallel dispatch on ``[cuda:0] * 4`` (a 2x2 mesh)
    against the same call on a CPU mesh: outputs within 1e-5 (float32,
    TF32 off; the products' sums differ in order), the same aux within
    1e-6, and the gathered-weights form the same bits on the card."""
    from repro_torch.models import layers as NN
    torch.backends.cuda.matmul.allow_tf32 = False
    s = NN.MoESpec(8, 2, 64, 128, capacity_factor=1.25)
    p = NN.moe_init(torch.Generator().manual_seed(0), s, torch.float32,
                    "cpu")
    x = torch.randn(4, 32, 64, generator=torch.Generator().manual_seed(1))
    pc = {k: ({n: t.to(cuda) for n, t in v.items()}) for k, v in p.items()}
    cpu_mesh = _one_card_mesh(torch.device("cpu"))
    want, want_aux = NN.moe_apply_ep(p, s, x, cpu_mesh, no_drop=no_drop)
    mesh = _one_card_mesh(cuda)
    got, aux = NN.moe_apply_ep(pc, s, x.to(cuda), mesh, no_drop=no_drop)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    again, _ = NN.moe_apply_ep(pc, s, x.to(cuda), mesh, no_drop=no_drop,
                               fsdp_axis="data")
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_restore_checkpoint_onto_cuda_entries(cuda, tmp_path):
    """``restore_checkpoint(shardings=)`` onto a 2x2 mesh of the card:
    every shard on the card, equal to its slice of the saved leaf."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.parallel.sharding import NamedSharding, P
    tree = {"w": torch.randn(8, 6, generator=torch.Generator()
                             .manual_seed(2)),
            "b": torch.arange(4, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    mesh = _one_card_mesh(cuda)
    sh = {"w": NamedSharding(mesh, P("model", "data")),
          "b": NamedSharding(mesh, P())}
    out, step = restore_checkpoint(str(tmp_path), tree, shardings=sh)
    assert step == 1
    for name, leaf in tree.items():
        assert out[name].sharding == sh[name]
        for shard in out[name].addressable_shards:
            assert shard.data.device == cuda
            assert torch.equal(shard.data.cpu(), leaf[shard.index])


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["hdr_add2", "jsc_xl_add2"])
def test_tune_block_b_keeps_the_largest_level_cap(cuda, model):
    """On the card, for both paper networks at a 2048-row probe: caps of
    one launch share one time, and the cap returned is the largest among
    the launches within TUNE_LEVEL_MARGIN of the fastest."""
    import chip_smoke
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.lut_synth import pack_tables_int4
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops
    spec = getattr(PM, model)()
    tables = pack_tables_int4(chip_smoke.random_tables(spec, 11, cuda))
    best, timings = ops.tune_block_b(tables, n_in0=spec.in_features)
    widths = [t.conn.shape[0] for t in tables]
    n_sms = K._sm_count(cuda.index)
    groups = {}
    for cap in timings:
        groups.setdefault(K.fused_geometry(
            2048, n_sms, spec.in_features, widths, False, max_rows=cap),
            set()).add(timings[cap])
    assert all(len(t) == 1 for t in groups.values())
    fastest = min(timings.values())
    assert best == max(c for c, t in timings.items()
                       if t <= fastest * (1 + ops.TUNE_LEVEL_MARGIN))
