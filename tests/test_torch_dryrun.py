"""The port's dry-run cost pass against the JAX package's where the
reference is pure: the registry's shapes, skips, counts, FLOPs and depth
variants for every arch; the abstract specs (batch, parameters, ZeRO-1
train state, decode cache) leaf by leaf on a 2x2 mesh at smoke size;
every non-skipped cell assembling; ``run_cell`` at smoke on 2x2 and
2x2x2 meeting ``tests/test_dryrun_smoke.py``'s contract; and the
collective model against bytes worked out by hand.

No JAX dry-run runs here (the reference's are ``slow``, minutes): only
``jax.eval_shape`` of the reference's specs, on conftest's 4 virtual
devices."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import registry as JR
from repro.parallel import sharding as JSH
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TRL
from repro_torch.launch.mesh import make_mesh, placeholder_devices
from repro_torch.models import registry as TR
from repro_torch.parallel import sharding as TSH

torch.set_num_threads(1)

JMESH = jax.make_mesh((2, 2), ("data", "model"))
TMESH = make_mesh("2x2", devices=placeholder_devices(4))
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int8): torch.int8,
          jnp.dtype(jnp.float16): torch.float16}


def _spec(spec, ndim):
    entries = list(spec) + [None] * ndim
    return tuple(entries[:ndim])


def _jleaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        sh = getattr(leaf, "sharding", None)
        out[JSH._path_str(path)] = (
            tuple(leaf.shape), DTYPES[jnp.dtype(leaf.dtype)],
            _spec(sh.spec, len(leaf.shape)) if sh is not None else None)
    return out


def _tleaves(tree):
    out = {}

    def one(path, leaf):
        sh = leaf.sharding
        out["/".join(path)] = (leaf.shape, leaf.dtype,
                               _spec(sh.spec, len(leaf.shape))
                               if sh is not None else None)
    TSH.tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_registry_pure_parts_equal_reference(arch):
    """SHAPES, the skips, parameter counts, MODEL_FLOPS and the depth
    variants of every arch."""
    assert {k: dataclasses.astuple(v) for k, v in TR.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JR.SHAPES.items()}
    assert TR.arch_skips(arch) == JR.arch_skips(arch)
    for shape in JR.SHAPES:
        assert TR.cell_is_skipped(arch, shape) == \
            JR.cell_is_skipped(arch, shape)
    for smoke in (False, True):
        tcfg, jcfg = TR.get_config(arch, smoke), JR.get_config(arch, smoke)
        assert TR.param_count(tcfg) == JR.param_count(jcfg)
        for shape in JR.SHAPES.values():
            assert TR.model_flops(tcfg, TR.SHAPES[shape.name]) == \
                JR.model_flops(jcfg, shape)
        if not TR.is_encdec(tcfg):
            for g in (1, 2):
                tv, jv = TR.depth_variant(tcfg, g), JR.depth_variant(jcfg, g)
                assert tv.n_layers == jv.n_layers
                assert [tuple(k) for k in tv.prefix] == \
                    [tuple(k) for k in jv.prefix]


@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_specs_equal_reference_leaf_by_leaf(arch):
    """batch_specs (every shape, and the sequence-parallel layout),
    param_specs (and FSDP), state_specs (ZeRO-1) and cache_specs (a
    decode shape) at smoke size on a 2x2 mesh: the same paths, shapes,
    dtypes and partition specs as the reference's."""
    tcfg, jcfg = TR.get_config(arch, True), JR.get_config(arch, True)
    for name in JR.SHAPES:
        for sm in (False, True):
            assert _tleaves(TR.batch_specs(tcfg, TR.SHAPES[name], TMESH,
                                           seq_on_model=sm)) == \
                _jleaves(JR.batch_specs(jcfg, JR.SHAPES[name], JMESH,
                                        seq_on_model=sm)), (name, sm)
    for fsdp in (False, True):
        assert _tleaves(TR.param_specs(tcfg, TMESH, fsdp=fsdp)) == \
            _jleaves(JR.param_specs(jcfg, JMESH, fsdp=fsdp))
    assert _tleaves(TR.state_specs(tcfg, TMESH)) == \
        _jleaves(JR.state_specs(jcfg, JMESH))
    shape = dataclasses.replace(JR.SHAPES["decode_32k"], seq_len=64,
                                global_batch=4)
    tshape = dataclasses.replace(TR.SHAPES["decode_32k"], seq_len=64,
                                 global_batch=4)
    assert _tleaves(TR.cache_specs(tcfg, tshape, TMESH)) == \
        _jleaves(JR.cache_specs(jcfg, shape, JMESH))


@pytest.mark.parametrize("arch", list(TR.ARCHS))
def test_registry_dryrun_cell_assembles_all_shapes(arch):
    """Every non-skipped (arch x shape) cell assembles (the reference's
    ``tests/test_sharding.py`` case): abstract args, a callable step,
    FLOPs and counts; and the step runs on ``meta`` tensors."""
    for shape in TR.SHAPES:
        if TR.cell_is_skipped(arch, shape):
            continue
        fn, args, meta = TR.dryrun_cell(arch, shape, mesh=None, smoke=True)
        assert callable(fn)
        assert meta["model_flops"] > 0
        assert meta["params_total"] >= meta["params_active"]
        leaves = []
        TSH.tree_map_with_path(lambda _, leaf: leaves.append(leaf), args)
        assert leaves and all(isinstance(leaf, TSH.ShapeDtypeStruct)
                              for leaf in leaves)
        out = fn(*TR.materialize(args))
        assert all(t.device.type == "meta" for t in TD._tensors(out, []))
        assert bool(meta["notes"]) == arch.startswith("rwkv")


def _check_record(rec):
    assert rec["status"] == "ok" and rec["cost_method"] == "meta-direct"
    assert rec["cost"]["flops_per_chip"] > 0
    rf = rec["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert min(rf["compute_s"], rf["memory_s"], rf["collective_s"]) >= 0
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert 0 < rf["useful_ratio"] < float("inf")
    assert rec["device"] == TRL.DEVICE


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-3b", "train_4k"),
    ("granite-moe-1b-a400m", "decode_32k"),
    ("whisper-tiny", "prefill_32k"),
])
def test_dryrun_cell_smoke(arch, shape):
    """``tests/test_dryrun_smoke.py``'s contract on a 2x2 mesh: status
    ok, FLOPs > 0, a dominant term, a peak > 0, every term >= 0; the
    counter's FLOPs are ``FlopCounterMode``'s over the same step."""
    rec = TD.run_cell(arch, shape, "2x2", smoke=True)
    _check_record(rec)
    assert rec["chips"] == 4
    json.dumps(rec)
    fn, args, _ = TR.dryrun_cell(arch, shape, mesh=TMESH, smoke=True)
    torch.backends.opt_einsum.enabled = False
    try:
        with FlopCounterMode(display=False) as fc:
            fn(*TR.materialize(args))
    finally:
        torch.backends.opt_einsum.enabled = True
    assert fc.get_total_flops() == rec["cost"]["flops_global"]


def test_dryrun_multipod_cli_and_per_chip_split(tmp_path):
    """The command line on a 2x2x2 mesh writes a record meeting the
    contract with 8 chips.  At smoke widths every dim divides, so each
    chip's FLOPs are an eighth of the whole; halve the heads' divisibility
    (3 heads on a 2-wide model axis: the rule falls back to replication)
    and the attention's work counts in full on every chip."""
    out = tmp_path / "cell.json"
    TD.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh",
             "2x2x2", "--smoke", "--out", str(out)])
    rec = json.loads(out.read_text())
    _check_record(rec)
    assert rec["chips"] == 8 and rec["mesh"] == "2x2x2"
    assert rec["cost"]["flops_per_chip"] * 8 == rec["cost"]["flops_global"]
    odd = TD.run_cell("qwen2.5-3b", "train_4k", "2x2x2", smoke=True,
                      overrides={"n_heads": 3, "n_kv_heads": 3})
    assert odd["cost"]["flops_per_chip"] * 8 > odd["cost"]["flops_global"]
    assert odd["roofline"]["useful_ratio"] < rec["roofline"]["useful_ratio"]


def test_run_cell_runs_the_ep_dispatch_under_moe_ep(tmp_path, monkeypatch):
    """``run_cell`` runs the step under its mesh, as the reference's
    ``_compile_cell`` does, so ``--override moe_ep=true`` counts the
    expert-parallel dispatch (``moe_apply_ep``: an expert product for
    each mesh entry) and not ``moe_apply``; ``moe_ep_fsdp`` gathers the
    weights over ``data`` there."""
    from repro_torch.models import layers as TNN
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    calls, real = [], TNN.moe_apply_ep

    def spy(*a, **k):
        calls.append((k.get("fsdp_axis"),
                      isinstance(_get_current_dispatch_mode(),
                                 TD.CostCounter)))
        return real(*a, **k)
    monkeypatch.setattr(TNN, "moe_apply_ep", spy)
    counted = {}
    for name, ov in (("plain", None), ("ep", {"moe_ep": True}),
                     ("ep_fsdp", {"moe_ep": True, "moe_ep_fsdp": True})):
        calls.clear()
        ops = tmp_path / f"{name}.tsv"
        rec = TD.run_cell("granite-moe-1b-a400m", "prefill_32k", "2x2",
                          smoke=True, overrides=ov, save_hlo=str(ops))
        _check_record(rec)
        assert rec["overrides"] == (ov or {})
        n_moe = TR.get_config("granite-moe-1b-a400m", smoke=True).n_layers
        want = {"plain": [], "ep": [(None, True)] * n_moe,
                "ep_fsdp": [("data", True)] * n_moe}[name]
        assert calls == want                  # one call a layer
        counted[name] = {
            line.split("\t")[0]: int(line.split("\t")[1])
            for line in ops.read_text().splitlines()}
    # 2 data slices x 2 expert columns: four expert products a layer
    assert counted["ep"]["aten.bmm"] > counted["plain"]["aten.bmm"]
    assert counted["ep_fsdp"]["aten.cat"] > counted["ep"]["aten.cat"]


@pytest.mark.parametrize("arch,fsdp,over", [
    ("rwkv6-3b", None, {}), ("granite-moe-1b-a400m", None, {}),
    ("kimi-k2-1t-a32b", True, {}), ("qwen2.5-3b", None, {"vocab": 151936})])
def test_per_chip_split_halves_when_data_doubles(arch, fsdp, over,
                                                 monkeypatch):
    """A train cell whose activations outweigh its parameters (the smoke
    widths at 16 x 128 tokens: four WKV chunks, whose loop's select
    gradients once lost the batch's axis; an MoE dispatch, whose slots
    come from a sort over every token; FSDP, whose weights split their
    contracted dim over the tokens' data axis; a published vocabulary,
    whose logits' gradient fills a fresh buffer of zeros): from 2x2 to
    4x2 the data axis doubles and each chip's FLOPs (every product
    splits) and activation peak halve, its bytes within 4% (the weights'
    own work does not split over data); a batch of one lies whole, so
    its peak does not."""
    real = TR.get_config
    monkeypatch.setattr(TR, "get_config", lambda name, **_: dataclasses.
                        replace(real(name, smoke=True), **over))
    monkeypatch.setitem(TR.SHAPES, "train_4k",
                        TR.ShapeSpec("train_4k", "train", 128, 16))
    recs = {m: TD.run_cell(arch, "train_4k", m, fsdp=fsdp)
            for m in ("2x2", "4x2")}
    assert recs["2x2"]["fsdp"] == bool(fsdp)
    for key, part, most in (("bytes_per_chip", "cost", 0.52),
                            ("flops_per_chip", "cost", 0.5),
                            ("activation_peak_bytes_per_device", "memory",
                             0.5)):
        ratio = recs["4x2"][part][key] / recs["2x2"][part][key]
        assert 0.5 <= ratio <= most * (1 + 1e-9), (key, ratio)
    monkeypatch.setitem(TR.SHAPES, "train_4k",
                        TR.ShapeSpec("train_4k", "train", 64, 1))
    one = {m: TD.run_cell(arch, "train_4k", m)["memory"][
        "activation_peak_bytes_per_device"] for m in ("2x2", "4x2")}
    assert one["2x2"] == one["4x2"]


def test_collective_model_against_hand_count():
    """Two leaves on a data 2 x model 2 mesh, train: a stacked (3
    layers) attention output projection split over ``model`` with
    ZeRO-1 moments (a reduce-scatter and an all-gather for its gradient,
    two all-reduces of the (64, 16) bf16 output a layer), and an FSDP
    embedding (two all-gathers and a reduce-scatter)."""
    mesh = make_mesh("2x2", devices=placeholder_devices(4))

    def leaf(shape, dtype, *spec):
        return TSH.ShapeDtypeStruct(shape, dtype,
                                    TSH.NamedSharding(mesh, TSH.P(*spec)))
    wo = leaf((3, 4, 8, 16), torch.float32, None, "model", None, None)
    table = leaf((32, 16), torch.bfloat16, "model", "data")
    mom = TSH.NamedSharding(mesh, TSH.P(None, "model", "data", None))
    stats = TRL.model_collectives(
        "train", [("stacks/0/attn/wo", wo), ("embed/table", table)],
        {"stacks/0/attn/wo": mom}, dict(mesh.shape), lambda path: 64, 2)
    # wo: shard 3*4*8*16*4/2 = 3072 bytes; table: 32*16*2/4 = 256
    assert stats.counts == {"all-gather": 3, "all-reduce": 6,
                            "reduce-scatter": 2, "all-to-all": 0,
                            "collective-permute": 0}
    assert stats.bytes_by_type["all-gather"] == 3072 + 2 * 512
    assert stats.bytes_by_type["reduce-scatter"] == 1536 + 256
    assert stats.bytes_by_type["all-reduce"] == 6 * 64 * 16 * 2
    assert stats.wire_bytes_by_type == {
        "all-gather": 2048.0, "all-reduce": 12288.0,
        "reduce-scatter": 1792.0, "all-to-all": 0.0,
        "collective-permute": 0.0}
    # serving: no gradients, one all-reduce a layer
    serve = TRL.model_collectives("decode", [("stacks/0/attn/wo", wo)], {},
                                  dict(mesh.shape), lambda path: 4, 2)
    assert serve.counts["all-reduce"] == 3 and serve.total_wire_bytes == \
        3 * 4 * 16 * 2
