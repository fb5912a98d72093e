"""Port parity of truth-table synthesis (``repro_torch.core.lut_synth.
synthesise``) against the JAX package, and the synthesis contract
inside the port.

* Across packages: a model trained by the JAX package (jitted train
  steps), carried across with ``lutdnn.model_from_numpy``, synthesises
  to the reference's tables bit for bit — every slab, its dtype, the
  routing slab and the metadata, ``pack=True`` and ``False`` — and both
  packages' ``save_artifact`` give the same artifact id.  A code that
  differs (a float tie on a quantizer step) is counted and reported;
  there must be none at these sizes.  The reference synthesises
  eagerly, as its callers do: under ``jax.jit`` XLA may fuse the BN
  fold's multiply-add, one float32 rounding away.
* Inside the port: ``lut_forward(synthesise(m))`` picks the argmax of
  the QAT forward with logits within ``OUTPUT_QUANT.step``
  (``repro/core/lut_synth.py:11-12``), and every sub-neuron table entry
  equals the quantized transfer function of its input combination."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifact import save_artifact as jsave
from repro.core import lut_synth as JLS
from repro.core import lutdnn as JLD
from repro.optim.adamw import adamw as jadamw
from repro_torch.artifact import load_artifact, save_artifact
from repro_torch.core import layers as TL
from repro_torch.core import lut_synth as TLS
from repro_torch.core import lutdnn as TLD
from repro_torch.data.loader import to_device
from test_torch_train import batches, jax_tree, numpy_model

torch.set_num_threads(1)


def _specs(**kw):
    kw = dict(name="t", in_features=12, widths=(10, 8, 5), bits=2,
              fan_in=3, **kw)
    return JLD.ModelSpec(**kw), TLD.ModelSpec(**kw)


@functools.lru_cache(maxsize=None)
def jax_trained(kind: str):
    """(jax spec, torch spec, model tree of numpy leaves).  "trained":
    PolyLUT-Add A=2 trained 10 jitted steps by the JAX package from a
    numpy draw (BN
    running stats away from their initial values); "neuralut": a
    NeuraLUT D=1 model drawn with numpy, random BN."""
    if kind == "neuralut":
        jspec, tspec = _specs(hidden=(6,))
        return jspec, tspec, numpy_model(jspec, seed=21)
    jspec, tspec = _specs(adder_width=2)
    _, step = JLD.make_train_step(jspec, lr=1e-3)
    # the reference's init_state with numpy draws in place of
    # jax.random (whose eager first call costs seconds here)
    model = jax_tree(numpy_model(jspec, seed=20, random_bn=False))
    state = {"model": model, "opt": jadamw(1e-3)[0](model["layers"])}
    step = jax.jit(step)
    for b in batches(jspec, 10, seed=0):
        state, _ = step(state, jax_tree(b))
    return jspec, tspec, jax.tree.map(np.asarray, state["model"])


def _differing_codes(jt, tt) -> int:
    return sum(int((np.asarray(getattr(j, k)).astype(np.int64)
                    != getattr(t, k).numpy().astype(np.int64)).sum())
               for j, t in zip(jt, tt) for k in ("sub_table", "add_table"))


@pytest.mark.parametrize("kind", ["trained", "neuralut"])
@pytest.mark.parametrize("pack", [True, False])
def test_synthesis_matches_reference_bit_for_bit(kind, pack):
    jspec, tspec, tree = jax_trained(kind)
    jt = JLS.synthesise(jax_tree(tree), jspec, pack=pack)
    tt = TLS.synthesise(TLD.model_from_numpy(tree, tspec, device="cpu"),
                        tspec, pack=pack)
    differ = _differing_codes(jt, tt)
    assert differ == 0, f"{differ} table codes differ from the reference"
    for i, (j, t) in enumerate(zip(jt, tt)):
        for k in ("conn", "sub_table", "add_table", "routing"):
            a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
            assert a.dtype == b.dtype, (i, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"layer {i} {k}")
        for k in ("in_bits", "sub_bits", "out_bits", "fan_in",
                  "adder_width", "is_output", "sub_packed", "add_packed"):
            assert getattr(t, k) == getattr(j, k), (i, k)
        assert vars(t.out_quant) == vars(j.out_quant)
        assert vars(t.sub_quant) == vars(j.sub_quant)
        assert np.dtype(TLS.NUMPY_NAMES[t.table_dtype]) == j.table_dtype
    assert TLS.network_table_bytes(tt) == JLS.network_table_bytes(jt)


def test_both_packages_save_the_same_artifact(tmp_path):
    jspec, tspec, tree = jax_trained("trained")
    jt = JLS.synthesise(jax_tree(tree), jspec)
    tt = TLS.synthesise(TLD.model_from_numpy(tree, tspec, device="cpu"),
                        tspec)
    for int4 in (True, False):
        jpath = jsave(str(tmp_path / f"j{int4}"), jt, name="t", spec=jspec,
                      int4=int4)
        tpath = save_artifact(str(tmp_path / f"t{int4}"), tt, name="t",
                              spec=tspec, int4=int4)
        tart = load_artifact(tpath, device="cpu")
        assert load_artifact(jpath, device="cpu").artifact_id == \
            tart.artifact_id
        assert tart.spec == tspec


def _train_port(spec, steps=10, seed=0):
    """A few port train steps on random data so the BN stats move."""
    init_state, step = TLD.make_train_step(spec, lr=1e-3)
    state = init_state(torch.Generator().manual_seed(seed), device="cpu")
    for b in batches(spec, steps, seed=seed):
        state, _ = step(state, to_device(b, "cpu"))
    return state["model"]


@pytest.mark.parametrize("degree,adder,hidden", [
    (1, 1, ()),        # LogicNets
    (2, 1, ()),        # PolyLUT
    (1, 2, ()),        # PolyLUT-Add
    (2, 2, ()),        # PolyLUT-Add D=2
    (1, 1, (6,)),      # NeuraLUT
])
def test_lut_forward_matches_qat_forward(degree, adder, hidden):
    spec = TLD.ModelSpec(name="t", in_features=12, widths=(10, 5), bits=2,
                         fan_in=3, degree=degree, adder_width=adder,
                         hidden=hidden)
    model = _train_port(spec)
    tables = TLS.synthesise(model, spec)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (100, 12)).astype(np.float32))
    net, _ = TLD.forward(model, spec, x)
    lut = TLS.lut_forward(tables, x, spec.layer_specs()[0].in_quant)
    assert torch.equal(torch.argmax(net, -1), torch.argmax(lut, -1))
    assert (net - lut).abs().max().item() <= TLS.OUTPUT_QUANT.step + 1e-6


def test_intermediate_codes_bit_exact():
    """Every sub-neuron table entry equals the quantized transfer
    function of its input combination (all K of them)."""
    spec = TLD.ModelSpec(name="t", in_features=8, widths=(6,), bits=2,
                         fan_in=2, degree=2, adder_width=2)
    model = _train_port(spec, steps=5)
    s = spec.layer_specs()[0]
    t = TLS.synthesise_layer(model["layers"][0], model["conn"][0], s)
    K = 2 ** (s.in_quant.bits * s.fan_in)
    combos = np.stack([(np.arange(K) >> (s.in_quant.bits * i))
                       & (s.in_quant.levels - 1)
                       for i in range(s.fan_in)], axis=1)
    vals = s.in_quant.from_code(torch.from_numpy(combos))       # (K, F)
    xf = vals[:, None, None, :].expand(K, s.n_out, s.adder_width, s.fan_in)
    pre = TL.subneuron_transfer(model["layers"][0], s, xf)
    want = s.sub_quant.to_code(pre).permute(1, 2, 0)
    assert torch.equal(t.sub_table.to(torch.int32), want)
    np.testing.assert_array_equal(TLS._enum_codes(s.fan_in, 2), combos)
    assert t.routing is not None and tuple(t.routing.shape) == \
        (s.n_in, s.n_out * s.adder_width)
    assert TLS.synthesise_layer(model["layers"][0], model["conn"][0], s,
                                routing=False).routing is None
