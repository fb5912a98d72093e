"""The port's batch-sharded LUT serving and sharded search on the CPU,
held against the JAX package on its 4 virtual devices
(tests/conftest.py):

* ``kernels.lut_gather.ops.lut_network_fused_sharded`` on meshes of 1,
  2 and 4 CPU entries (``device.ensure_host_devices``), B = 1, 37 and
  64, packed int4 and uint8 slabs, fused, per-layer and a forced
  two-segment plan: equal to the port unsharded, to the reference's
  oracle and, at ``tests/test_lut_sharded.py``'s ``SPEC_KW``, to the
  reference's own ``lut_network_fused_sharded``, bit for bit;
* ``make_network_fn(mesh=)`` built once and reused, where the result
  lies, ``tune_block_b``'s contract, ``ModelRegistry(mesh=)``,
  ``LutFleet(mesh=)``, ``serve --lut --shards``, ``serving_mesh``'s
  refusal, ``batch_iterator(sharding=)`` against the reference's
  ``addressable_shards``;
* ``search_connectivity_population(mesh=)`` on two entries, bit for bit
  against the port on one device, and against the reference's sharded
  run fed the reference's start and draws.

Codes are integers (tolerance 0).  The search's thetas are floats: the
port equals the reference as written, and the reference's jitted step
rounds its random walk differently near its 1.5e-6 terms (ROADMAP.md
Queue 3), so against the reference the masks and scores are held equal
and the thetas within 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JPM
from repro.core import lut_synth as LS
from repro.core import lutdnn as JLD
from repro.data.loader import batch_iterator as jbatches
from repro.data.loader import data_sharding as jdata_sharding
from repro.data.loader import train_test_split
from repro.data.synthetic import make_dataset
from repro.kernels.lut_gather import ops as jops
from repro.kernels.lut_gather import ref as jref
from repro.parallel.sharding import serving_mesh as jserving_mesh
from repro_torch import device as TDEV
from repro_torch.configs import paper_models as TPM
from repro_torch.core import lut_synth as TLS
from repro_torch.core import lutdnn as TLD
from repro_torch.data.loader import batch_iterator as tbatches
from repro_torch.data.loader import data_sharding as tdata_sharding
from repro_torch.kernels.lut_gather import ops as tops
from repro_torch.launch import serve as TS
from repro_torch.launch.batching import replay_open_loop
from repro_torch.launch.fleet import LutFleet
from repro_torch.launch.registry import ModelRegistry
from repro_torch.optim.adamw import OptState, tree_map
from repro_torch.parallel import sharding as TSH

torch.set_num_threads(1)

SPEC_KW = dict(in_features=16, widths=(24, 12, 5), bits=2, fan_in=3,
               degree=1, adder_width=2)
BATCHES = (1, 37, 64)


@pytest.fixture(autouse=True)
def four_host_devices(monkeypatch):
    """The CPU stands as 4 mesh entries, as the reference's 4 virtual
    devices (restored after each test)."""
    monkeypatch.setenv(TDEV.HOST_DEVICES_ENV, "4")


@functools.lru_cache(maxsize=None)
def _network():
    """SPEC_KW synthesised by the JAX package -> (spec, uint8 tables)."""
    spec = JLD.ModelSpec(name="shard-t", **SPEC_KW)
    model = JLD.init_model(jax.random.key(0), spec)
    return spec, LS.synthesise(model, spec, pack=True)


@functools.lru_cache(maxsize=None)
def _oracle_fn():
    _, tables = _network()

    @jax.jit
    def chain(x):
        for t in tables:
            x = jref.lut_layer(x, t.conn, t.sub_table, t.add_table,
                               t.in_bits, t.sub_bits)
        return x
    return chain


def _codes(B: int, seed: int = 9) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 4, (B, SPEC_KW["in_features"])).astype(np.int32)


def _oracle(codes: np.ndarray) -> np.ndarray:
    return np.asarray(_oracle_fn()(jnp.asarray(codes)))


def _port_tables(packed: bool):
    _, jt = _network()
    return TLS.tables_from_numpy(LS.pack_tables_int4(jt) if packed else jt,
                                 "cpu")


def _plan(tt, mode: str):
    n_in = SPEC_KW["in_features"]
    if mode == "fused":
        return None
    if mode == "per_layer":
        return tops.make_network_fn(tt, n_in0=n_in, fused=False,
                                    device="cpu").execution_plan
    budget = tops.fused_smem_bytes(tt, 1, n_in) - 1
    plan = tops.plan_segments(tt, n_in0=n_in, budget=budget)
    assert plan.mode == "segmented" and plan.n_segments == 2
    return plan


@pytest.mark.parametrize("mode", ["fused", "per_layer", "plan"])
@pytest.mark.parametrize("packed", [True, False], ids=["int4", "uint8"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_sharded_engine_bit_exact(ndev, packed, mode):
    """Every batch (uneven ones leave a remainder on 2 and 4 entries)
    equals the port unsharded and the reference's oracle."""
    tt = _port_tables(packed)
    plan = _plan(tt, mode)
    mesh = TSH.serving_mesh(ndev)
    codes = _codes(64)
    want = _oracle(codes)
    single = tops.make_network_fn(tt, n_in0=SPEC_KW["in_features"],
                                  plan=plan, fused=mode != "per_layer"
                                  or None, device="cpu")
    for B in BATCHES:
        c = torch.from_numpy(codes[:B])
        got = tops.lut_network_fused_sharded(
            tt, c, mesh, fused=mode != "per_layer", plan=plan)
        assert got.dtype == torch.int32 and got.shape == (B, 5)
        np.testing.assert_array_equal(got.numpy(), want[:B])
        np.testing.assert_array_equal(single(c).numpy(), want[:B])


def test_sharded_engine_equals_reference_sharded_engine():
    """At SPEC_KW, B=37 over 4 entries: the port's sharded engine and
    the reference's (shard_map, Pallas interpret mode) answer alike."""
    _, jt = _network()
    codes = _codes(37, seed=4)
    want = np.asarray(jops.lut_network_fused_sharded(
        jt, jnp.asarray(codes), jserving_mesh(4), block_b=16))
    for packed in (False, True):
        got = tops.lut_network_fused_sharded(
            _port_tables(packed), torch.from_numpy(codes),
            TSH.serving_mesh(4), pipeline=packed)
        np.testing.assert_array_equal(got.numpy(), want)


def test_result_lies_joined_on_the_first_entry():
    """The reference's result stays sharded over its 4 devices; the
    port's is one (B, n_out) tensor on the first entry's device."""
    _, jt = _network()
    codes = _codes(64)
    jout = jax.jit(lambda c: jops.lut_network_fused_sharded(
        jt, c, jserving_mesh(4)))(jnp.asarray(codes))
    assert len({s.device.id for s in jout.addressable_shards}) == 4
    mesh = TSH.serving_mesh(4)
    out = tops.lut_network_fused_sharded(_port_tables(True),
                                         torch.from_numpy(codes), mesh)
    assert isinstance(out, torch.Tensor) and out.shape == (64, 5)
    assert out.device == mesh.device_list[0]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_make_network_fn_mesh_built_once_and_reused():
    tt = _port_tables(True)
    mesh = TSH.serving_mesh(4)
    fn = tops.make_network_fn(tt, n_in0=16, mesh=mesh)
    assert fn.device == torch.device("cpu") and fn.mesh is mesh
    runs = dict(fn._runs)
    assert list(runs) == [torch.device("cpu")]   # one replica a device
    codes = _codes(64, seed=5)
    for B in (64, 37, 1, 64):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(codes[:B])).numpy(), _oracle(codes)[:B])
    assert fn._runs == runs
    with pytest.raises(ValueError, match="first entry"):
        tops.make_network_fn(tt, mesh=mesh, device="meta")
    # direct calls keep the network's replicas on the mesh
    for _ in range(3):
        tops.lut_network_fused_sharded(tt, torch.from_numpy(codes), mesh)
    assert len(mesh.cache) == 1
    # a CPU mesh takes no input from another device
    with pytest.raises(ValueError, match="mesh on the CPU"):
        fn(torch.from_numpy(codes).to("meta"))


def test_tune_block_b_contract_and_refusal():
    tt = _port_tables(True)
    best, timings = tops.tune_block_b(tt, batch=3, n_in0=16, iters=1)
    assert sorted(timings) == [1, 2, 3]         # clamped to the probe
    assert best in timings and all(v > 0 for v in timings.values())
    best, timings = tops.tune_block_b(tt, batch=64, n_in0=16, iters=1)
    assert sorted(timings) == list(tops.TUNE_CANDIDATES)
    # the reference's TPU tiles clamp to the ledger's cap: one launch
    _, t2 = tops.tune_block_b(tt, batch=4096, n_in0=16, iters=1,
                              candidates=(128, 256, 512, 1024, 2048))
    assert sorted(t2) == [tops.K.MAX_BLOCK_ROWS]
    with pytest.raises(ValueError, match="no block_b candidate fits"):
        tops.tune_block_b(tt, batch=64, n_in0=16,
                          budget=tops.fused_smem_bytes(tt, 1, 16) - 1)
    # block_b="auto": a cap for each segment, probed at the shard's batch
    mesh = TSH.serving_mesh(4)
    fn = tops.make_network_fn(tt, n_in0=16, block_b="auto", tune_batch=8,
                              mesh=mesh)
    assert fn.execution_plan.block_b[0] in (1, 2)
    codes = _codes(37)
    np.testing.assert_array_equal(fn(torch.from_numpy(codes)).numpy(),
                                  _oracle(codes))


def test_tune_block_b_times_one_cap_a_launch(monkeypatch):
    """Caps that give one launch at the probe (``fused_geometry`` on the
    H100's SMs for CPU tables) are timed once, by their largest cap, and
    every cap reports its group's time; among the groups within
    TUNE_LEVEL_MARGIN of the fastest the largest cap wins, so
    ``make_network_fn(block_b="auto")`` serves B=4096 at the rows
    ``fused_geometry`` picks with no cap.  (The timer is stubbed: on the
    CPU every cap runs the same plain version.)"""
    tt = _port_tables(True)
    K, n_sms = tops.K, tops.K.H100_SM_COUNT
    widths = [t.conn.shape[0] for t in tt]
    groups = {}
    for cap in tops.TUNE_CANDIDATES:
        g = K.fused_geometry(2048, n_sms, 16, widths, False, max_rows=cap)
        groups.setdefault(g, []).append(cap)
    assert sorted(map(tuple, groups.values())) == [(1,), (2,), (4, 8, 16, 32)]
    for secs, best in (({1: 3e-5, 2: 1.4e-5, 32: 1e-5}, 32),    # 2 level
                       ({1: 3e-5, 2: 1e-5, 32: 1.6e-5}, 2),     # 32 slower
                       ({1: 1e-5, 2: 1e-5, 32: 1e-5}, 32)):     # all level
        timed = []

        def fake(net, codes, cap, pipeline, iters, secs=secs, timed=timed):
            timed.append(cap)
            return secs[cap]

        monkeypatch.setattr(tops, "_time_cap", fake)
        got, timings = tops.tune_block_b(tt, batch=2048, n_in0=16)
        assert sorted(timed) == [1, 2, 32]          # one a launch
        assert got == best
        assert timings == {c: secs[max(caps)] for caps in groups.values()
                           for c in caps}
    monkeypatch.setattr(tops, "_time_cap", lambda *a: 1e-5)
    fn = tops.make_network_fn(tt, n_in0=16, block_b="auto", fused=True,
                              device="cpu")
    cap = fn.execution_plan.block_b[0]
    assert cap == K.MAX_BLOCK_ROWS
    assert K.fused_geometry(4096, n_sms, 16, widths, False,
                            max_rows=cap).rows == K.fused_geometry(
        4096, n_sms, 16, widths, False).rows


def _rows(n: int, seed: int = 3) -> np.ndarray:
    return _codes(n, seed)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    from repro.artifact import save_artifact as jsave
    spec, tables = _network()
    return jsave(str(tmp_path_factory.mktemp("sharded-art")), tables,
                 name="shard-t", spec=spec)


def test_registry_and_thread_fleet_on_a_mesh(artifact):
    rows = _rows(48)
    want = _oracle(rows)
    mesh = TSH.serving_mesh(4)
    with ModelRegistry(8, 0.003, mesh=mesh) as reg:
        assert reg.device == torch.device("cpu")
        reg.register("m", artifact)
        got = [h.result(timeout=30) for h in replay_open_loop(
            reg.client("m"), rows, rate=20000)]
    np.testing.assert_array_equal(np.stack(got), want)
    with LutFleet(2, 8, 0.003, device="cpu", mesh=mesh,
                  transport="thread") as fleet:
        fleet.distribute_artifact(artifact, "m")
        handles = replay_open_loop(fleet.client("m"), rows, rate=20000)
        got = [h.result(timeout=30) for h in handles]
    assert not any(h.failed for h in handles)
    np.testing.assert_array_equal(np.stack(got), want)
    with pytest.raises(ValueError, match="process transport"):
        LutFleet(1, device="cpu", mesh=mesh, transport="process")


ARGS = ["--lut", "--device", "cpu", "--lut-train-steps", "3",
        "--requests", "48", "--rate", "20000", "--microbatch", "16",
        "--deadline-ms", "5"]


def test_serve_lut_shards_equal_unsharded(tmp_path, capsys):
    d = str(tmp_path)
    one = TS.main(ARGS + ["--artifact-dir", d, "--save-artifact"])
    two = TS.main(ARGS + ["--artifact-dir", d, "--shards", "2"])
    out = capsys.readouterr().out
    assert "lut-serve[artifact] device=cpu shards=2" in out
    assert two.served == two.requests == 48 and two.failed == 0
    assert two.accuracy == one.accuracy
    with pytest.raises(ValueError, match="5 devices requested, 4 visible"):
        TS.main(ARGS + ["--artifact-dir", d, "--shards", "5"])


def test_serving_mesh_raises_beyond_what_is_visible(monkeypatch):
    assert TSH.serving_mesh().shape == {"data": 4}
    with pytest.raises(ValueError, match="5 devices requested"):
        TSH.serving_mesh(5)
    monkeypatch.delenv(TDEV.HOST_DEVICES_ENV)
    with pytest.raises(ValueError, match="2 devices requested, 1 visible"):
        TSH.serving_mesh(2)
    # explicit entries: four shards of one device
    m = TSH.serving_mesh(4, devices=["cpu"] * 4)
    assert m.device_list == [torch.device("cpu")] * 4


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4", "2x2"])
def test_batch_iterator_shards_like_device_put(shape):
    data = make_dataset("jsc", n_samples=64, seed=0)
    if len(shape) == 1:
        jmesh, tmesh = jserving_mesh(4), TSH.serving_mesh(4)
    else:
        jmesh = jax.make_mesh(shape, ("data", "model"))
        from repro_torch.launch.mesh import make_mesh
        tmesh = make_mesh("2x2")
    jb = next(jbatches(data, 8, seed=2, sharding=jdata_sharding(jmesh)))
    tb = next(tbatches(data, 8, seed=2, sharding=tdata_sharding(tmesh)))
    for k in ("x", "y"):
        js, ts = jb[k].addressable_shards, tb[k].addressable_shards
        assert len(js) == len(ts) == 4
        assert tb[k].shape == jb[k].shape
        order = list(jmesh.devices.flat)
        for a, b in zip(sorted(js, key=lambda s: order.index(s.device)),
                        ts):
            assert b.device == torch.device("cpu")
            assert a.index == b.index
            np.testing.assert_array_equal(np.asarray(a.data),
                                          b.data.numpy())
    with pytest.raises(ValueError, match="device=None"):
        next(tbatches(data, 8, device="cpu",
                      sharding=tdata_sharding(tmesh)))


# --------------------------------------------------------------- search

SEARCH_KW = dict(n_steps=24, phase_frac=0.6, eps2=2e-3)
N_MEMBERS = 4


@pytest.fixture(scope="module")
def jsc():
    return train_test_split(make_dataset("jsc", n_samples=1500, seed=0))


def test_sharded_search_equals_one_device(jsc):
    """Members split 2 + 2 over two entries end where the run on one
    device ends, bit for bit: masks, scores, every end-state leaf and
    the history."""
    spec = TPM.tiny("jsc", fan_in=2)

    def run(mesh):
        gens = [torch.Generator().manual_seed(s) for s in range(N_MEMBERS)]
        return TLD.search_connectivity_population(
            gens, spec, tbatches(jsc["train"], 128, seed=5, device="cpu"),
            mesh=mesh, device=None if mesh else "cpu", **SEARCH_KW)

    one, two = run(None), run(TSH.serving_mesh(2))
    for a, b in zip(one[0], two[0]):
        assert torch.equal(a, b)
    assert torch.equal(one[1], two[1])
    assert one[2] == two[2]
    for a, b in zip(tree_map(lambda x: x, one[3]["tlayers"]),
                    two[3]["tlayers"]):
        for f in ("theta", "sign", "bias"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert len(two[3]["gens"]) == N_MEMBERS
    # three members do not divide two entries: replicated, one shard
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    assert len(TLD._population_shards(3, TSH.serving_mesh(2))) == 1
    with pytest.raises(TypeError, match="Mesh"):
        TLD.search_connectivity_population(gens, spec, iter(()), 1,
                                           mesh=object())


@jax.jit
def _member_draws(key, like):
    """One member's draws at one step of the reference (its state's key
    -> the control key, split a layer, then noise / grow)."""
    _, sub = jax.random.split(key)
    out = []
    for k, x in zip(jax.random.split(sub, len(like)), like):
        k_noise, k_grow = jax.random.split(k)
        out.append((jax.random.normal(k_noise, x.shape),
                    jax.random.uniform(k_grow, x.shape)))
    return out


def test_sharded_search_equals_reference_sharded_search(jsc, monkeypatch):
    """The reference's population search on its ``serving_mesh(2)``
    against the port's on two CPU entries, the port started from the
    reference's start and fed each member's reference draws."""
    jspec, tspec = JPM.tiny("jsc", fan_in=2), TPM.tiny("jsc", fan_in=2)
    key = jax.random.key(7)
    jmasks, jscores, jhist, jstates = JLD.search_connectivity_population(
        key, jspec, jbatches(jsc["train"], 128, seed=5), n_seeds=N_MEMBERS,
        mesh=jserving_mesh(2), **SEARCH_KW)

    cfgs = JLD.search_sparsity_configs(
        jspec, int(SEARCH_KW["n_steps"] * SEARCH_KW["phase_frac"]),
        eps2=SEARCH_KW["eps2"])
    jinit, _ = JLD.make_search_step(jspec, cfgs, 0.15)
    start = jax.vmap(jinit)(jax.random.split(key, N_MEMBERS))
    carried = TLD.search_state_from_numpy(jax.tree.map(
        np.asarray, {k: start[k] for k in ("tlayers", "opt", "step")}),
        device="cpu")
    keys = list(start["key"])
    like = [jnp.zeros(tl.theta.shape[1:]) for tl in start["tlayers"]]
    gens = [torch.Generator().manual_seed(p) for p in range(N_MEMBERS)]
    member = {id(g): p for p, g in enumerate(gens)}

    def init(gs, spec, cfgs, mode="sparselut", device=None):
        idx = [member[id(g)] for g in gs]
        pick = lambda x: x[idx].clone()   # noqa: E731
        return {"tlayers": tree_map(pick, carried["tlayers"]),
                "opt": OptState(step=carried["opt"].step.clone(),
                                mu=tree_map(pick, carried["opt"].mu),
                                nu=None),
                "gens": list(gs), "step": carried["step"].clone()}

    def draws(gs, tlayers):
        per = []
        for g in gs:
            p = member[id(g)]
            per.append(_member_draws(keys[p], like))
            keys[p] = jax.random.split(keys[p])[0]
        return [tuple(torch.stack([torch.from_numpy(np.array(d[i][j]))
                                   for d in per]) for j in (0, 1))
                for i in range(len(like))]

    monkeypatch.setattr(TLD, "population_search_init", init)
    monkeypatch.setattr(TLD, "search_draws", draws)
    masks, scores, hist, states = TLD.search_connectivity_population(
        gens, tspec, tbatches(jsc["train"], 128, seed=5, device="cpu"),
        mesh=TSH.serving_mesh(2), **SEARCH_KW)
    for a, b in zip(jmasks, masks):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jscores), scores.numpy())
    for a, b in zip(jstates["tlayers"], states["tlayers"]):
        np.testing.assert_array_equal(np.asarray(a.theta) > 0,
                                      b.theta.numpy() > 0)
        np.testing.assert_allclose(np.asarray(a.theta), b.theta.numpy(),
                                   atol=1e-5, rtol=0)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
