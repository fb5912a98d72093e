"""Port parity of LUT-mode inference: ``repro_torch.core.lut_synth``
(``lut_layer_forward``, ``lut_forward``, int4 packing) and the plain
versions of the three CUDA kernels (``kernels/lut_gather/ref.py``, which
is what every kernel wrapper runs on CPU tensors) against the JAX
package's oracle, on networks the JAX package synthesises from random
parameters.

Networks: the committed golden artifact (adder on) and one draw of the
conformance harness with the adder off (tests/test_conformance.py
``_random_draw`` / ``_build``), each with uint8, int32 and int4
nibble-packed slabs.  JAX synthesis is the expensive step here, so the
networks are few and cached.  Codes are integers: tolerance 0 everywhere; the float logits
of ``lut_forward`` are one float32 multiply-add of equal codes, also
exact."""
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_synth as LS
from repro.kernels.lut_gather import ref as jref
from repro_torch.core import lut_synth as TLS
from repro_torch.kernels.lut_gather import lut_gather as TK
from repro_torch.kernels.lut_gather import ops as tops
from repro_torch.kernels.lut_gather import ref as tref
from test_conformance import _build, _random_draw  # noqa: E402

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# a conformance-harness draw with the adder off: 3-bit hidden codes
# (int4-packable sub-tables), int32 logit sub-table
SEEDED_DRAW = 8


@functools.lru_cache(maxsize=None)
def network(name: str):
    """-> (input width, in_quant of layer 0, uint8 tables, int32
    tables), all
    synthesised by the JAX package from random parameters.  "golden" is
    the committed artifact (beta=2 A=2: int4-packable 3-bit sub-codes
    and 2-bit adder codes, int32 logit adder table); "seeded" is
    synthesised here."""
    if name == "golden":
        from repro.artifact import load_artifact
        art = load_artifact(str(GOLDEN))
        u8 = art.tables
        i32 = [dataclasses.replace(
            t, sub_table=t.sub_table.astype(jnp.int32),
            add_table=t.add_table.astype(jnp.int32),
            table_dtype=jnp.dtype(jnp.int32)) for t in u8]
        return art.n_in, art.spec.layer_specs()[0].in_quant, u8, i32
    kw, _, _ = _random_draw(np.random.default_rng(SEEDED_DRAW))
    spec, u8, i32 = _build(tuple(sorted(kw.items())))
    return spec.in_features, spec.layer_specs()[0].in_quant, u8, i32


def jax_chain(tables, codes):
    """Every layer's output codes through the JAX oracle (jitted as one
    program: eager dispatch compiles each small op separately)."""
    def chain(x):
        outs = []
        for t in tables:
            x = jref.lut_layer(x, t.conn, t.sub_table, t.add_table,
                               t.in_bits, t.sub_bits)
            outs.append(x)
        return outs
    return [np.array(o) for o in jax.jit(chain)(jnp.asarray(codes))]


def port_layers(tt, n_in):
    out = []
    for t in tt:
        out.append(TK.layer_args(
            t.conn, t.sub_table, t.add_table, t.in_bits, t.sub_bits,
            t.sub_packed, t.add_packed, n_in=n_in, check_conn=True))
        n_in = t.conn.shape[0]
    return out


def codes_for(fq, n_in: int, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** fq.bits, (B, n_in)).astype(np.int32)


@pytest.mark.parametrize("name", ["golden", "seeded"])
def test_lut_paths_match_reference(name):
    n_in, fq, u8, i32 = network(name)
    codes = codes_for(fq, n_in, 37, 1)
    want = jax_chain(i32, codes)
    c = torch.from_numpy(codes)
    variants = {"int32": i32, "uint8": u8, "int4": LS.pack_tables_int4(u8)}
    for vname, jt in variants.items():
        tt = TLS.tables_from_numpy(jt, "cpu")
        layers = port_layers(tt, n_in)
        # plain version of the fused kernels: the whole chain
        np.testing.assert_array_equal(
            tref.lut_network(c, [a.plain() for a in layers]).numpy(),
            want[-1], err_msg=f"plain fused chain, {vname} slabs")
        net = TK.FusedNet(layers)
        for pipeline in (False, True):
            np.testing.assert_array_equal(
                TK.lut_network_fused(c, net, pipeline=pipeline).numpy(),
                want[-1])
        # plain version of the per-layer kernel, layer by layer
        x = c
        for a, w in zip(layers, want):
            x = TK.lut_gather(x, a)
            np.testing.assert_array_equal(
                x.numpy(), w, err_msg=f"per-layer plain, {vname} slabs")
        # the lut_synth reference path takes unpacked slabs
        x = c
        for t in TLS.unpack_tables_int4(tt):
            x = TLS.lut_layer_forward(t, x)
        np.testing.assert_array_equal(x.numpy(), want[-1])
    # the real-valued entry quantizes, runs and decodes the logits
    xr = np.random.default_rng(2).uniform(
        -1.2, 1.2, codes.shape).astype(np.float32)
    # lut_forward's steps, with only the integer chain jitted: under jit
    # XLA contracts the decode's multiply-add into an FMA, one float32
    # rounding away from the unjitted reference
    xc = fq.to_code(fq.clip(jnp.asarray(xr)))
    want_logits = np.asarray(LS.OUTPUT_QUANT.from_code(
        jnp.asarray(jax_chain(u8, np.asarray(xc))[-1])))
    got = TLS.lut_forward(TLS.tables_from_numpy(u8, "cpu"),
                          torch.from_numpy(xr),
                          TLS.QuantSpec(fq.bits, fq.low, fq.high))
    np.testing.assert_array_equal(got.numpy(), want_logits)


def test_int4_packing_matches_reference():
    _, _, packed, _ = network("golden")
    j4 = LS.pack_tables_int4(packed)
    t4 = TLS.pack_tables_int4(TLS.tables_from_numpy(packed, "cpu"))
    for a, b in zip(j4, t4):
        assert (a.sub_packed, a.add_packed) == (b.sub_packed, b.add_packed)
        np.testing.assert_array_equal(b.sub_table.numpy(),
                                      np.asarray(a.sub_table))
        np.testing.assert_array_equal(b.add_table.numpy(),
                                      np.asarray(a.add_table))
    back = TLS.unpack_tables_int4(t4)
    for a, b in zip(packed, back):
        np.testing.assert_array_equal(b.sub_table.numpy(),
                                      np.asarray(a.sub_table))
    assert TLS.network_table_bytes(t4) == LS.network_table_bytes(j4)


def test_kernel_wrappers_refuse_bad_arguments():
    """The wrappers' checks run before any device work: wrong dtype,
    a non-power-of-two table, out-of-range connectivity, layers that do
    not chain, and codes on another device than the tables."""
    conn = torch.zeros((4, 2, 3), dtype=torch.int32)
    sub = torch.zeros((4, 2, 64), dtype=torch.uint8)
    add = torch.zeros((4, 64), dtype=torch.uint8)
    a = TK.layer_args(conn, sub, add, 2, 3, n_in=5)
    with pytest.raises(TypeError):
        TK.layer_args(conn.long(), sub, add, 2, 3, n_in=5)
    with pytest.raises(ValueError):
        TK.layer_args(conn, sub[..., :48].contiguous(), add, 2, 3, n_in=5)
    with pytest.raises(ValueError):
        TK.layer_args(conn + 5, sub, add, 2, 3, n_in=5, check_conn=True)
    with pytest.raises(ValueError):
        TK.FusedNet([a, a])                  # widths 4 -> 5 do not chain
    assert not TK.layer_args(conn, sub, add[:, :0], 2, 3, n_in=5,
                             add_packed=True).add_packed
    # codes and tables on different devices: refused before dispatch
    meta = TK.layer_args(conn.to("meta"), sub.to("meta"), add.to("meta"),
                         2, 3, n_in=5)
    codes = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="codes on cpu"):
        TK.lut_gather(codes, meta)
    with pytest.raises(ValueError, match="codes on cpu"):
        TK.lut_network_fused(codes, TK.FusedNet([meta]))
    with pytest.raises(ValueError, match="no LUT kernel"):
        TK.lut_gather(codes.to("meta"), meta)


# --------------------------------------------------------------------------
# the engine: repro_torch.kernels.lut_gather.ops
# --------------------------------------------------------------------------

def _forced_budget(tables, n_in0: int, pipeline: bool = False) -> int:
    """A shared-memory budget one byte below what the whole network
    needs at one row per block: the planner has to cut."""
    return tops.fused_smem_bytes(tables, 1, n_in0, pipeline) - 1


def test_engine_plans_match_reference_fused_and_segmented():
    """At the golden size: every plan mode of the port's
    ``make_network_fn`` equals the JAX engine's fused kernel (interpret
    mode), and a forced multi-segment plan equals the JAX segmented
    path."""
    from repro.kernels.lut_gather import ops as jops
    n_in, fq, u8, _ = network("golden")
    codes = codes_for(fq, n_in, 41, 3)
    want = np.asarray(jops.lut_network_fused(
        u8, jnp.asarray(codes), block_b=16, force_interpret=True))
    jplan = jops.plan_segments(
        u8, block_b=16, n_in0=n_in, prefer_int4=False,
        budget=jops.fused_vmem_bytes(u8, 16, n_in) - 1)
    assert jplan.n_segments >= 2
    want_seg = np.asarray(jops.lut_network_segmented(
        u8, jnp.asarray(codes), jplan, force_interpret=True))
    np.testing.assert_array_equal(want_seg, want)

    c = torch.from_numpy(codes)
    for jt in (u8, LS.pack_tables_int4(u8)):
        tt = TLS.tables_from_numpy(jt, "cpu")
        budget = _forced_budget(tt, n_in)
        engines = {
            "fused": dict(), "fused-pipelined": dict(pipeline=True),
            "forced-fused": dict(fused=True, block_b=5),
            "per-layer": dict(fused=False),
            "segmented": dict(budget=budget),
            "segmented-3": dict(budget=max(
                tops.fused_smem_bytes(tt[i:i + 1], 1, w)
                for i, w in enumerate([n_in] + [t.conn.shape[0]
                                                for t in tt[:-1]]))),
        }
        modes = {}
        for name, kw in engines.items():
            fn = tops.make_network_fn(tt, n_in0=n_in, device="cpu", **kw)
            modes[name] = (fn.execution_plan.mode,
                           fn.execution_plan.n_segments)
            np.testing.assert_array_equal(fn(c).numpy(), want,
                                          err_msg=name)
        assert modes["fused"] == ("fused", 1)
        assert modes["per-layer"][0] == "per_layer"
        assert modes["segmented"][0] == "segmented"
        assert modes["segmented-3"] == ("segmented", 3)
        np.testing.assert_array_equal(
            tops.lut_network_segmented(tt, c, budget=budget).numpy(), want)
        np.testing.assert_array_equal(tops.lut_network(tt, c).numpy(), want)


def test_engine_matches_oracle_on_seeded_draw():
    n_in, fq, u8, i32 = network("seeded")
    codes = codes_for(fq, n_in, 29, 4)
    want = jax_chain(i32, codes)[-1]
    c = torch.from_numpy(codes)
    for jt in (i32, u8, LS.pack_tables_int4(u8)):
        tt = TLS.tables_from_numpy(jt, "cpu")
        for kw in (dict(), dict(pipeline=True), dict(fused=False),
                   dict(budget=_forced_budget(tt, n_in))):
            fn = tops.make_network_fn(tt, n_in0=n_in, device="cpu", **kw)
            np.testing.assert_array_equal(fn(c).numpy(), want,
                                          err_msg=str(kw))


def _hdr_add2_shaped(spec):
    """Zero tables of a paper model's shapes (the planner reads shapes)."""
    out = []
    for s in spec.layer_specs():
        A, F = s.adder_width, s.fan_in
        K = 2 ** (s.in_quant.bits * F)
        Ka = 2 ** (A * s.sub_quant.bits) if A > 1 else 0
        out.append(TLS.LayerTables(
            conn=torch.zeros((s.n_out, A, F), dtype=torch.int32),
            sub_table=torch.zeros((s.n_out, A, K), dtype=torch.uint8),
            add_table=torch.zeros((s.n_out, Ka), dtype=torch.uint8),
            in_bits=s.in_quant.bits, sub_bits=s.sub_quant.bits,
            out_bits=s.out_quant.bits, fan_in=F, adder_width=A,
            is_output=s.is_output, out_quant=s.out_quant,
            sub_quant=s.sub_quant, table_dtype=torch.uint8))
    return out


def test_plan_ledger_properties():
    """The H100 shared-memory ledger: paper models plan to one fused
    segment at the card's budget, with rows per block chosen from the
    ledger; every segment of a forced plan fits its budget; per-layer
    only when a single layer cannot fit one row."""
    from repro_torch.configs import paper_models as PM
    for spec in (PM.hdr_add2(), PM.jsc_xl_add2(), PM.hdr()):
        tables = _hdr_add2_shaped(spec)
        n_in = spec.in_features
        for pipeline in (False, True):
            plan = tops.plan_segments(tables, n_in0=n_in, pipeline=pipeline)
            assert (plan.mode, plan.n_segments) == ("fused", 1)
            assert 1 <= plan.block_b[0] <= TK.MAX_BLOCK_ROWS
            assert plan.smem_bytes[0] <= TK.SMEM_BUDGET_BYTES
        widths = [n_in] + [t.conn.shape[0] for t in tables]
        single = max(tops.fused_smem_bytes(tables[i:i + 1], 1, widths[i])
                     for i in range(len(tables)))
        for budget in (single, single * 2, _forced_budget(tables, n_in)):
            plan = tops.plan_segments(tables, n_in0=n_in, budget=budget)
            assert plan.mode in ("fused", "segmented")
            for (s, e), bb, v in zip(plan.bounds, plan.block_b,
                                     plan.smem_bytes):
                assert bb >= 1
                assert v == tops.fused_smem_bytes(
                    tables[s:e], bb, widths[s], plan.pipeline) <= budget
        assert tops.plan_segments(tables, n_in0=n_in,
                                  budget=single - 1).mode == "per_layer"
    # HDR-Add2 at the card's budget: 32 rows, two P/Q buffers of 256 and
    # 100 codes beside 784 input codes per row
    plan = tops.plan_segments(_hdr_add2_shaped(PM.hdr_add2()), n_in0=784)
    assert plan.block_b == (32,)
    assert plan.smem_bytes == (32 * 4 * (784 + 256 + 100),)


# every paper model of configs/paper_models.py (the CIFAR rows reuse the
# HDR topologies on 3072 inputs)
PAPER_MODELS = ("hdr", "hdr_add2", "hdr_5l", "jsc_xl", "jsc_xl_add2",
                "jsc_m_lite", "jsc_m_lite_add2", "jsc_2l", "cifar_hdr",
                "cifar_hdr_add2")
H100_SMS = 132


def _paper_shape(name):
    from repro_torch.configs import paper_models as PM
    spec = getattr(PM, name)()
    return spec, spec.in_features, list(spec.widths)


@pytest.mark.parametrize("name", PAPER_MODELS)
def test_paper_models_plan_one_fused_segment(name):
    """The ledger still plans every paper model to one fused segment at
    the card's budget, its cap MAX_BLOCK_ROWS rows, in both modes."""
    spec, n_in, _ = _paper_shape(name)
    tables = _hdr_add2_shaped(spec)
    for pipeline in (False, True):
        plan = tops.plan_segments(tables, n_in0=n_in, pipeline=pipeline)
        assert (plan.mode, plan.n_segments) == ("fused", 1)
        assert plan.block_b[0] == min(TK.MAX_BLOCK_ROWS, TK.block_rows(
            n_in, [t.conn.shape[0] for t in tables], pipeline))
        assert "chosen per batch up to the cap" in plan.describe()


@pytest.mark.parametrize("name", PAPER_MODELS)
def test_fused_geometry_fills_the_card(name):
    """The registry's 256-row micro-batch spreads over >= 128 blocks of a
    132-SM card; one row makes one block; a 4096-row batch makes two or
    more blocks per SM, and four of them fit an SM's shared memory
    together."""
    _, n_in, widths = _paper_shape(name)
    g = TK.fused_geometry(256, H100_SMS, n_in, widths, False)
    assert g.grid >= 128
    g1 = TK.fused_geometry(1, H100_SMS, n_in, widths, False)
    assert (g1.rows, g1.grid) == (1, 1)
    g = TK.fused_geometry(4096, H100_SMS, n_in, widths, False)
    assert g.grid >= 2 * H100_SMS
    assert g.blocks_per_sm >= 4
    assert g.blocks_per_sm * (g.smem_bytes + TK.BLOCK_SMEM_RESERVED) \
        <= TK.SM_SMEM_BYTES


@pytest.mark.parametrize("name", PAPER_MODELS)
def test_fused_geometry_stays_within_the_ledger(name):
    """At any batch, in both modes, with and without a plan's cap: rows
    within the ledger's cap, the ledger's bytes at those rows within the
    227 KB budget, every row covered, the carveout a percentage."""
    _, n_in, widths = _paper_shape(name)
    for pipeline in (False, True):
        cap = TK.block_rows(n_in, widths, pipeline)
        for max_rows in (None, 5):
            for B in (1, 2, 255, 256, 257, 1000, 4096, 65536):
                g = TK.fused_geometry(B, H100_SMS, n_in, widths, pipeline,
                                      max_rows=max_rows)
                assert 1 <= g.rows <= min(cap, max_rows or cap)
                assert g.rows <= TK.MAX_BLOCK_ROWS
                assert g.smem_bytes == TK.fused_smem_bytes(
                    n_in, widths, g.rows, pipeline) <= TK.SMEM_BUDGET_BYTES
                tiles = -(-B // g.rows)
                assert g.grid == (min(tiles, H100_SMS) if pipeline
                                  else tiles)
                assert 0 < g.carveout <= 100
                assert g.rows <= g.threads <= TK.MAX_FUSED_THREADS


def test_fused_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        TK.fused_geometry(64, H100_SMS, 784, [256, 10], False, rows=64)
    with pytest.raises(ValueError):
        TK.fused_geometry(64, H100_SMS, 784, [256, 10], False, rows=0)
    with pytest.raises(ValueError):
        TK.fused_geometry(64, H100_SMS, 784, [256, 10], False,
                          budget=100)


def test_make_network_fn_needs_a_card_unless_told(monkeypatch):
    _, _, u8, _ = network("golden")
    tt = TLS.tables_from_numpy(u8, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.make_network_fn(tt)
    with pytest.raises(RuntimeError):
        TLS.tables_from_numpy(u8)
    assert tops.make_network_fn(tt, device="cpu").device.type == "cpu"
