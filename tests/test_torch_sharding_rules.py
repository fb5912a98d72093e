"""The port's sharding rules (``repro_torch.parallel.sharding``) and mesh
construction (``repro_torch.launch.mesh``) against the reference's, on
the CPU.

For each smoke config of the model families (attention, MoE, RG-LRU,
RWKV6, encoder-decoder) the reference's parameter and cache shapes come
from ``jax.eval_shape``; on meshes (1,1), (1,2), (2,1), (2,2), (1,4) and
(4,1) of ("data", "model") the port's ``choose_spec`` gives the
reference's spec for every leaf, and ``make_shardings`` over the port's
own trees (in the reference's stacked layout) gives the reference's
paths and specs.  Then ``fsdp=True``, ``zero1_shardings``,
``lutdnn_population_rules``, ``batch_sharding`` and the mesh helpers.
The rules are pure functions of path, shape and axis sizes: equality
is exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as JMESH
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.models import registry as JR
from repro.parallel import sharding as JSH
from repro_torch import device as TDEV
from repro_torch.launch import mesh as TMESH
from repro_torch.models import encdec as TED
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR
from repro_torch.parallel import sharding as TSH

torch.set_num_threads(1)

ARCHS = ["qwen2.5-3b", "granite-moe-1b-a400m", "recurrentgemma-9b",
         "rwkv6-3b", "whisper-tiny"]
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1)]
CACHE_B, CACHE_S = 4, 16


@pytest.fixture(autouse=True)
def four_host_devices(monkeypatch):
    monkeypatch.setenv(TDEV.HOST_DEVICES_ENV, "4")


def _meshes(shape):
    return (jax.make_mesh(shape, ("data", "model")),
            TMESH.make_mesh(f"{shape[0]}x{shape[1]}"))


def _jflat(tree) -> dict:
    return {JSH._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree) -> dict:
    out = {}
    TSH.tree_map_with_path(
        lambda path, leaf: out.__setitem__("/".join(path), leaf), tree)
    return out


@functools.lru_cache(maxsize=None)
def _reference_trees(arch: str):
    """(params, cache) of the reference's smoke config, as shapes."""
    cfg = JR.get_config(arch, smoke=True)
    key = jax.random.key(0)
    if JR.is_encdec(cfg):
        params = jax.eval_shape(lambda k: JED.init_params(k, cfg), key)
        cache = jax.eval_shape(lambda k: JED.init_dec_cache(
            JED.init_params(k, cfg), cfg,
            jnp.zeros((CACHE_B, 8, cfg.d_model), cfg.dtype), CACHE_B,
            CACHE_S), key)
    else:
        params = jax.eval_shape(lambda k: JLM.init_params(k, cfg), key)
        cache = jax.eval_shape(lambda: JLM.init_cache(cfg, CACHE_B,
                                                      CACHE_S))
    return cfg, params, cache


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str):
    """(params, cache) drawn by the port, in the reference's layout."""
    cfg = TR.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    if TR.is_encdec(cfg):
        params = TED.init_params(cfg, gen, "cpu")
        enc = torch.zeros((CACHE_B, 8, cfg.d_model), dtype=cfg.dtype)
        cache = TED.init_dec_cache(params, cfg, enc, CACHE_B, CACHE_S)
        return params, cache
    params = TLM.params_to_stacked(TLM.init_params(cfg, gen, "cpu"), cfg)
    cache = TLM.layers_to_stacked(
        TLM.init_cache(cfg, CACHE_B, CACHE_S, "cpu")["blocks"], cfg,
        torch.stack)
    return params, cache


def _specs(shardings, flat) -> dict:
    return {k: tuple(s.spec) for k, s in flat(shardings).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_of_every_param_and_cache_leaf_equal_reference(arch):
    cfg, jparams, jcache = _reference_trees(arch)
    tparams, tcache = _port_trees(arch)
    tied = getattr(cfg, "tie_embeddings", True)
    for shape in MESHES:
        jmesh, tmesh = _meshes(shape)
        for fsdp in (False, True):
            jr = JSH.lm_rules(fsdp=fsdp, tied_embed=tied)
            tr = TSH.lm_rules(fsdp=fsdp, tied_embed=tied)
            for path, leaf in _jflat(jparams).items():
                assert tuple(TSH.choose_spec(path, leaf.shape, tmesh, tr)) \
                    == tuple(JSH.choose_spec(path, leaf.shape, jmesh, jr)), \
                    (arch, shape, fsdp, path)
            want = _specs(JSH.make_shardings(jparams, jmesh, jr), _jflat)
            got = _specs(TSH.make_shardings(tparams, tmesh, tr), _tflat)
            assert len(want) >= 12 and got == want, (arch, shape, fsdp)
        jr, tr = JSH.cache_rules(jmesh), TSH.cache_rules(tmesh)
        want = _specs(JSH.make_shardings(jcache, jmesh, jr), _jflat)
        got = _specs(TSH.make_shardings(tcache, tmesh, tr), _tflat)
        assert len(want) >= 2 and got == want, (arch, shape, "cache")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_zero1_population_and_batch_shardings_equal_reference(shape):
    jmesh, tmesh = _meshes(shape)
    _, jparams, _ = _reference_trees("qwen2.5-3b")
    tparams, _ = _port_trees("qwen2.5-3b")
    jr, tr = JSH.lm_rules(), TSH.lm_rules()
    want = _specs(JSH.zero1_shardings(
        JSH.make_shardings(jparams, jmesh, jr), jmesh, jparams), _jflat)
    got = _specs(TSH.zero1_shardings(
        TSH.make_shardings(tparams, tmesh, tr), tmesh, tparams), _tflat)
    assert got == want
    # a population's member axis: over data when it divides, else
    # replicated
    for n in (1, 2, 3, 4, 8):
        for leaf in ((n, 16, 32), (n,), ()):
            assert tuple(TSH.choose_spec(
                "tlayers/0/theta", leaf, tmesh,
                TSH.lutdnn_population_rules(tmesh))) == tuple(
                JSH.choose_spec("tlayers/0/theta", leaf, jmesh,
                                JSH.lutdnn_population_rules(jmesh)))
    for ndim in (1, 2, 3):
        for seq in (False, True):
            assert tuple(TSH.batch_sharding(tmesh, ndim, seq).spec) == \
                tuple(JSH.batch_sharding(jmesh, ndim, seq).spec)
    assert tuple(TSH.batch_spec(tmesh)) == tuple(JSH.batch_spec(jmesh))
    assert TSH.dp_axes(tmesh) == JSH.dp_axes(jmesh)


def test_spec_helpers_equal_reference():
    class FakeMesh:          # a multi-pod mesh, as the reference's test
        shape = {"pod": 2, "data": 2, "model": 2}
        axis_names = ("pod", "data", "model")

    for entries in (("DP", "model"), ("model", "DP", None)):
        assert [tuple(p) for p in TSH._fsdp_variants(*entries)] == \
            [tuple(p) for p in JSH._fsdp_variants(*entries)]
    for path, leaf in (("stacks/0/moe/experts/w_in", (3, 8, 16, 32)),
                       ("embed/table", (100, 64)), ("head/w", (64, 99)),
                       ("attn/wq", (64, 7, 8))):
        for fsdp in (False, True):
            assert tuple(TSH.choose_spec(path, leaf, FakeMesh(),
                                         TSH.lm_rules(fsdp))) == tuple(
                JSH.choose_spec(path, leaf, FakeMesh(), JSH.lm_rules(fsdp)))
    assert TSH.P(("data",), None) == TSH.P("data", None)
    assert tuple(TSH.P(("pod", "data"))) == tuple(JSH.P(("pod", "data")))


def test_mesh_parsing_and_counts_equal_reference():
    for spec in ("single", "multi", "2x2", "1x4", "2x4x8", "4x1"):
        assert TMESH.host_device_count_needed(spec) == \
            JMESH.host_device_count_needed(spec)
    for spec in ("2x2", "1x4", "4x1", "1x1x4", "2x1x2"):
        jm, tm = JMESH.make_mesh(spec), TMESH.make_mesh(spec)
        assert tm.axis_names == jm.axis_names
        assert dict(tm.shape) == dict(jm.shape)
        assert TMESH.mesh_chip_count(tm) == JMESH.mesh_chip_count(jm)
    for spec in ("single", "multi", "4x2"):
        with pytest.raises(ValueError):
            JMESH.make_mesh(spec)
        with pytest.raises(ValueError, match="devices"):
            TMESH.make_mesh(spec)
    with pytest.raises(ValueError, match="bad mesh spec"):
        TMESH.make_mesh("2x2x2x2")


def test_mesh_entries_streams_and_ambient():
    m = TSH.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                 ("data", "model"))
    assert m.shard_entries("data") == [0, 2]
    assert m.shard_entries(("data", "model")) == [0, 1, 2, 3]
    assert m.shard_entries(None) == [0] and m.stream(0) is None
    assert TSH.ambient_mesh() is None
    with m:
        assert TSH.ambient_mesh() is m
    assert TSH.ambient_mesh() is None
    with pytest.raises(ValueError, match="mixes device types"):
        TSH.Mesh([torch.device("cpu"), torch.device("cuda", 0)], ("data",))
    with pytest.raises(ValueError, match="for axes"):
        TSH.Mesh(["cpu"] * 4, ("data", "model"))
    # host devices: an explicit count is never overridden
    TDEV.ensure_host_devices(2)
    assert len(TDEV.host_devices()) == 4
