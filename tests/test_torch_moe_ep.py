"""Port parity of the LM's multi-rank half against the JAX package: the
expert-parallel MoE dispatch (``layers.moe_apply_ep``) and the LM's
``moe_ep`` / ``moe_ep_fsdp`` / ``seq_parallel`` fields under a mesh,
``restore_checkpoint(shardings=)`` and ``Trainer.try_resume(shardings=)``,
and the int8 gradient compression (``optim.compress``).

The JAX side runs on conftest's 4 virtual CPU devices
(``jax.make_mesh((2, 2), ("data", "model"))``); the port on a mesh of
the CPU 4 times (``device.HOST_DEVICES_ENV``), single-controller.  Weights
are drawn by the port and carried to the reference as numpy; torch runs
on one thread.  Tolerances: the reference's own EP test's (1e-4 on
outputs and the four gradients, 1e-3 on the loss) for the dispatch;
1e-5 for the LM, whose float32 sums differ only in order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

from repro.models import layers as JNN
from repro.models import lm as JLM
from repro.models import registry as JR
from repro.optim import compress as JCMP
from repro_torch import device as TDEV
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.models import layers as TNN
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR
from repro_torch.optim import compress as TCMP
from repro_torch.parallel import sharding as TSH
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
EP_TOL = dict(rtol=0, atol=1e-4)
LM_TOL = dict(rtol=1e-5, atol=1e-5)
JMESH = jax.make_mesh((2, 2), ("data", "model"))
# the reference's LM train step under a mesh of explicit axes (JAX's
# default) stops at its own router gradient ("contracting dimensions are
# sharded"); with automatic axes GSPMD places it
JMESH_AUTO = jax.make_mesh((2, 2), ("data", "model"),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(autouse=True)
def four_host_devices(monkeypatch):
    """The CPU stands as 4 mesh entries, as the reference's 4 virtual
    devices (restored after each test)."""
    monkeypatch.setenv(TDEV.HOST_DEVICES_ENV, "4")


def _mesh(shape=(2, 2), axes=("data", "model")) -> TSH.Mesh:
    n = int(np.prod(shape))
    return TSH.Mesh(np.array(TDEV.host_devices()[:n],
                             dtype=object).reshape(shape), axes)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return jnp.asarray(_np(tree))


# ---------------------------------------------------------------------------
# moe_apply_ep
# ---------------------------------------------------------------------------

EP_CASES = {
    "no_drop": dict(spec={}, no_drop=True, fsdp=None),
    "capacity_1.25": dict(spec={}, no_drop=False, fsdp=None),
    "fsdp_data": dict(spec={}, no_drop=False, fsdp="data"),
    "shared": dict(spec=dict(shared_expert=True), no_drop=False, fsdp=None),
}


@pytest.mark.parametrize("case", list(EP_CASES))
def test_moe_apply_ep_matches_reference(case):
    """Outputs, loss and the router's and experts' gradients of the
    port's EP dispatch on a 2x2 CPU mesh against the reference's
    ``shard_map`` on a 2x2 JAX mesh, MoESpec(8, 2, 16, 32) in float32:
    without drops, at capacity 1.25 (the same drops: a slice's T_loc =
    16 tokens give 5 slots an expert), with the expert weights gathered
    over ``data`` and with a shared expert."""
    c = EP_CASES[case]
    kw = dict(n_experts=8, top_k=2, d_model=16, d_ff=32,
              capacity_factor=1.25, **c["spec"])
    js, ts = JNN.MoESpec(**kw), TNN.MoESpec(**kw)
    tp = TNN.moe_init(torch.Generator().manual_seed(0), ts, torch.float32,
                      CPU)
    x = np.random.default_rng(1).standard_normal((4, 8, 16)).astype(
        np.float32)

    def jloss(p, x):
        y, aux = JNN.moe_apply_ep(p, js, x, JMESH, no_drop=c["no_drop"],
                                  fsdp_axis=c["fsdp"])
        return jnp.sum(y ** 2) + aux, y

    with JMESH:
        (jl, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            _tree_np(tp), jnp.asarray(x))
    leaves = {"router": tp["router"]["w"], **tp["experts"]}
    for t in leaves.values():
        t.requires_grad_(True)
    ty, taux = TNN.moe_apply_ep(tp, ts, torch.from_numpy(x), _mesh(),
                                no_drop=c["no_drop"], fsdp_axis=c["fsdp"])
    tl = torch.sum(ty ** 2) + taux
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-3
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **EP_TOL)
    want = {"router": jg["router"]["w"], **jg["experts"]}
    for name, t in leaves.items():
        np.testing.assert_allclose(_np(t.grad), np.asarray(want[name]),
                                   err_msg=name, **EP_TOL)
    if case == "capacity_1.25":
        # the case drops: some expert gets more than 5 of a slice's 32
        # assignments
        _, eids, _ = TNN.moe_route(tp, ts, torch.from_numpy(x).reshape(
            32, 16))
        most = max(int((eids[i * 16:(i + 1) * 16] == e).sum())
                   for i in range(2) for e in range(8))
        assert most > TNN.moe_capacity(ts, 16)


def test_moe_apply_ep_fsdp_same_bits_and_refusals():
    """The gathered weights give the same bits; the shapes the
    reference's ``shard_map`` cannot split raise ValueError."""
    s = TNN.MoESpec(8, 2, 16, 32)
    p = TNN.moe_init(torch.Generator().manual_seed(2), s, torch.float32,
                     CPU)
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(3))
    mesh = _mesh()
    a = TNN.moe_apply_ep(p, s, x, mesh)
    b = TNN.moe_apply_ep(p, s, x, mesh, fsdp_axis="data")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="not divisible"):
        TNN.moe_apply_ep(p, TNN.MoESpec(7, 2, 16, 32), x, mesh)
    with pytest.raises(ValueError, match="do not split"):
        TNN.moe_apply_ep(p, s, x[:, :3][:1], mesh)          # 3 tokens
    with pytest.raises(ValueError, match="not in mesh"):
        TNN.moe_apply_ep(p, s, x, _mesh((4,), ("data",)))
    with pytest.raises(ValueError, match="do not split"):
        TNN.moe_apply_ep(p, TNN.MoESpec(8, 2, 16, 31), x, mesh,
                         fsdp_axis="data")


# ---------------------------------------------------------------------------
# the LM under a mesh
# ---------------------------------------------------------------------------

def _granite(**over):
    jcfg = dataclasses.replace(JR.get_config("granite-moe-1b-a400m", True),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(TR.get_config("granite-moe-1b-a400m", True),
                               dtype=torch.float32, **over)
    tparams = TLM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = jax.tree.map(lambda t: jnp.asarray(_np(t)),
                           TLM.params_to_stacked(tparams, tcfg))
    return jcfg, jparams, tcfg, tparams


def test_lm_moe_ep_under_mesh_matches_reference():
    """granite-moe smoke with ``moe_ep`` under an ambient 2x2 mesh (each
    data slice's capacity, so other drops than ``moe_apply``'s): the
    forward's logits and aux, and one train step's loss, aux, grad norm
    and AdamW first moment, against the reference's LM under the same
    JAX mesh.  With no mesh the flag runs ``moe_apply``: the same bits
    as ``moe_ep=False``."""
    jcfg, jparams, tcfg, tparams = _granite(moe_ep=True)
    toks = np.random.default_rng(5).integers(0, 128, (4, 17)).astype(
        np.int32)
    t = torch.from_numpy(toks)
    with JMESH:
        want, want_aux = jax.jit(lambda p, x: JLM.forward(p, jcfg, x))(
            jparams, jnp.asarray(toks))
    with _mesh():
        got, got_aux = TLM.forward(tparams, tcfg, t)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **LM_TOL)
    plain = TLM.forward(tparams, dataclasses.replace(tcfg, moe_ep=False), t)
    bare = TLM.forward(tparams, tcfg, t)
    assert torch.equal(bare[0], plain[0]) and torch.equal(bare[1], plain[1])
    assert not torch.equal(got, plain[0])         # EP drops otherwise

    _, jstep = JR.make_train_step(jcfg, remat=False)
    _, tstep = TR.make_train_step(tcfg, remat=False)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    js = {"params": jparams, "opt": JR._optimizer(jcfg)[0](jparams)}
    with JMESH_AUTO:
        js, jm = jax.jit(jstep)(js, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    ts = {"params": tparams, "opt": TR._optimizer(tcfg)[0](tparams)}
    with _mesh():
        ts, tm = tstep(ts, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **LM_TOL)
    mu = TLM.params_to_stacked(ts["opt"].mu, tcfg)
    for (path, g), w in zip(_leaves(mu), jax.tree.leaves(js["opt"].mu)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=path,
                                   **LM_TOL)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("mesh", [False, True])
def test_seq_parallel_flag_preserves_math(mesh):
    """``seq_parallel`` only pins a layout: the qwen2.5-3b smoke forward
    is bit-identical to the baseline, with and without a mesh (the
    reference's ``test_seq_parallel_flag_preserves_math``)."""
    cfg = TR.get_config("qwen2.5-3b", smoke=True)
    cfg_sp = dataclasses.replace(cfg, seq_parallel=True)
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    a, _ = TLM.forward(params, cfg, toks)
    if mesh:
        with _mesh():
            b, _ = TLM.forward(params, cfg_sp, toks)
    else:
        b, _ = TLM.forward(params, cfg_sp, toks)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(16, 6, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.tensor(3.5)},
            "list": [torch.ones(3), torch.zeros((2, 2),
                                                dtype=torch.bfloat16)]}


def _like(tree, template):
    """``tree``'s leaves at ``template``'s leaves (a ``ShardedTensor`` is a
    dataclass, which the tree walkers would open)."""
    if isinstance(template, dict):
        for k in sorted(template):
            yield from _like(tree[k], template[k])
    elif isinstance(template, (list, tuple)):
        for a, b in zip(tree, template):
            yield from _like(a, b)
    else:
        yield tree


def _assert_laid_out(out, tree, shardings):
    leaves, got = list(_like(tree, tree)), list(_like(out, tree))
    shs = (list(_like(shardings, tree))
           if not isinstance(shardings, TSH.NamedSharding)
           else [shardings] * len(leaves))
    for leaf, st, sh in zip(leaves, got, shs):
        assert isinstance(st, TSH.ShardedTensor)
        assert isinstance(st.sharding, TSH.NamedSharding)
        assert st.sharding == sh and st.shape == tuple(leaf.shape)
        assert len(st.addressable_shards) == sh.mesh.size
        for shard in st.addressable_shards:
            assert shard.data.dtype == leaf.dtype
            assert torch.equal(shard.data, leaf[shard.index])


def test_elastic_restore_with_target_sharding(tmp_path):
    """The reference's contract: a tree of shardings (one-entry mesh,
    replicated), one sharding for every leaf, and a 2x2 mesh with a
    leaf split over ``model``: every leaf a ``ShardedTensor`` whose
    shards equal their slices of the saved leaf."""
    tree = _tree()
    TCK.save_checkpoint(str(tmp_path), 3, tree)
    one = TSH.Mesh([CPU], ("data",))
    tree_sh = TSH.tree_map_with_path(
        lambda _, t: TSH.NamedSharding(one, TSH.P()), tree)
    for shardings in (tree_sh, TSH.NamedSharding(one, TSH.P())):
        out, step = TCK.restore_checkpoint(str(tmp_path), tree,
                                           shardings=shardings)
        assert step == 3
        _assert_laid_out(out, tree, shardings)
    mesh = _mesh()
    split = TSH.tree_map_with_path(
        lambda path, t: TSH.NamedSharding(
            mesh, TSH.P("model", "data") if path == ("a",) else TSH.P()),
        tree)
    out, _ = TCK.restore_checkpoint(str(tmp_path), tree, shardings=split)
    _assert_laid_out(out, tree, split)
    assert out["a"].addressable_shards[1].index == (slice(8, 16),
                                                    slice(0, 3))


def test_trainer_try_resume_with_shardings(tmp_path):
    """``Trainer.try_resume(shardings=)`` matching ``{"state", "step"}``:
    the state comes back laid out over the mesh, shard by shard equal
    to what was saved, at the saved step; the trainer's own state stays
    whole, so training goes on from it."""
    mesh = _mesh()
    state = {"w": torch.randn(8, 4, generator=torch.Generator()
                              .manual_seed(1))}

    def step(s, batch):
        return {"w": s["w"] * 0.5 + batch}, {"loss": torch.tensor(1.0)}

    tr = Trainer(TrainerConfig(str(tmp_path), ckpt_every=2), step, state)
    tr.run(iter([torch.ones(())] * 3), 3)
    tr2 = Trainer(TrainerConfig(str(tmp_path)), step, state)
    shardings = {"state": {"w": TSH.NamedSharding(mesh, TSH.P("model"))},
                 "step": TSH.NamedSharding(mesh, TSH.P())}
    assert tr2.try_resume(shardings=shardings)
    assert tr2.step == 2                      # the newest checkpoint
    saved = {"w": (state["w"] * 0.5 + 1) * 0.5 + 1}
    _assert_laid_out(tr2.sharded_state, saved, shardings["state"])
    assert torch.equal(tr2.state["w"], saved["w"])
    tr2.run(iter([torch.ones(())]), 3)
    assert tr2.step == 3 and tr2.recoveries == 0
    torch.testing.assert_close(tr2.state["w"], tr.state["w"], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def _ulp_close(got: torch.Tensor, want, g: np.ndarray) -> None:
    """The new error ``g - q * scale`` within one ulp of the gradient: XLA
    contracts it into a fused multiply-add, the port rounds the product
    first, as the source writes it."""
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)),
                                 np.spacing(np.abs(g).astype(np.float32))
                                 + 1e-45)


def test_int8_gradient_compression_error_feedback():
    """One entry, 8 steps (the reference's case): the accumulated
    compressed means converge to the true ones.  Each step fed the
    reference's error state: the mean equals the reference's in a
    one-device ``shard_map`` bit for bit, the new error within one ulp
    (``_ulp_close``)."""
    g = np.linspace(-1.0, 1.0, 64).astype(np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    run = jax.jit(shard_map(
        lambda gg, ee: JCMP.compressed_psum_mean(gg, ee, ("data",)),
        mesh=mesh, in_specs=(JP(), JP()), out_specs=(JP(), JP())))
    jerr = JCMP.init_error_state({"w": jnp.asarray(g)})
    terr = [TCMP.init_error_state({"w": torch.from_numpy(g)})]
    assert terr[0]["w"].dtype == torch.float32
    total = torch.zeros(64)
    for _ in range(8):
        fed = [{"w": torch.from_numpy(np.array(jerr["w"]))}]
        jout, jerr = run({"w": jnp.asarray(g)}, jerr)
        tout, terr_fed = TCMP.compressed_psum_mean(
            [{"w": torch.from_numpy(g)}], fed)
        np.testing.assert_array_equal(tout[0]["w"].numpy(),
                                      np.asarray(jout["w"]))
        _ulp_close(terr_fed[0]["w"], jerr["w"], g + fed[0]["w"].numpy())
        out, terr = TCMP.compressed_psum_mean([{"w": torch.from_numpy(g)}],
                                              terr)
        total += out[0]["w"]
    np.testing.assert_allclose((total / 8).numpy(), g, atol=2e-2)


def test_int8_compression_four_entries_matches_shard_map():
    """Four entries with different gradients against the reference in a
    ``shard_map`` over a 4-device ``data`` axis, two steps (the second
    with the reference's error feedback): each entry's mean bit for bit,
    its new error within one ulp (``_ulp_close``)."""
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((4, 33)).astype(np.float32),
         "b": (rng.standard_normal((4, 5, 3)) * 1e-3).astype(np.float32)}
    mesh = jax.make_mesh((4,), ("data",))
    run = jax.jit(shard_map(
        lambda gg, ee: JCMP.compressed_psum_mean(gg, ee, ("data",)),
        mesh=mesh, in_specs=(JP("data"), JP("data")),
        out_specs=(JP("data"), JP("data"))))
    jerr = JCMP.init_error_state({k: jnp.asarray(v) for k, v in g.items()})
    ent = [{k: torch.from_numpy(v[i:i + 1]) for k, v in g.items()}
           for i in range(4)]
    for _ in range(2):
        fed = [{k: torch.from_numpy(np.array(jerr[k])[i:i + 1]) for k in g}
               for i in range(4)]
        jout, jerr = run({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tout, terr = TCMP.compressed_psum_mean(ent, fed)
        for k in g:
            for i in range(4):
                np.testing.assert_array_equal(
                    tout[i][k].numpy(), np.asarray(jout[k])[i:i + 1])
                _ulp_close(terr[i][k], np.asarray(jerr[k])[i:i + 1],
                           g[k][i:i + 1] + fed[i][k].numpy())
    with pytest.raises(ValueError, match="one of each"):
        TCMP.compressed_psum_mean(ent, fed[:2])
