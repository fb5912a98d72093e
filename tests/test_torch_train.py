"""Port parity of the training half: ``repro_torch.data``, ``core.poly``,
``core.quant`` (STE and batch norm), ``core.layers``, ``core.lutdnn``
and ``optim.adamw`` against the JAX package.

``jax.random`` and ``torch.Generator`` draw different numbers, so
parameters are drawn once with numpy from a seed and carried into both
packages (``lutdnn.model_from_numpy``).  Stated tolerances:

* data: bit for bit;
* poly, quant and batch norm: 1e-6 absolute, codes exactly;
* forward (eval and train mode): logits 1e-5 absolute, running stats
  1e-6;
* five train steps on identical batches: losses 1e-5 relative,
  parameters 1e-5 absolute.

The pre-BN bias of every layer (``b``, or the last sub-network bias of
a NeuraLUT layer) is the one exception.  Batch norm subtracts the batch
mean, so the loss does not depend on that bias and its gradient is 0
analytically.  In float32 it is rounding noise of about 1e-9, and each
package's noise is its own.  Adam turns that noise into steps of about
``lr`` in either direction.  The test asserts that the gradient is at
noise level in both packages, bounds the bias's difference by
``2 * lr`` a step, and then copies the reference's bias (and its Adam
moments) into the port before the next step, so every other parameter
is held to 1e-5 on the same inputs.

The JAX train step is jitted, as every caller of the reference jits it;
at these sizes one compile is cheaper than an eager first call."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as JL
from repro.core import lutdnn as JLD
from repro.core import poly as JP
from repro.core import quant as JQ
from repro.data import loader as JDL
from repro.data import synthetic as JDS
from repro.optim.adamw import adamw as jadamw
from repro_torch.configs import paper_models as TPM
from repro_torch.core import layers as TL
from repro_torch.core import lutdnn as TLD
from repro_torch.core import poly as TP
from repro_torch.core import quant as TQ
from repro_torch.data import loader as TDL
from repro_torch.data import synthetic as TDS
from repro_torch.data.loader import to_device
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.optim.adamw import tree_map

torch.set_num_threads(1)

LR = 5e-3
# the forward's configurations: PolyLUT D=1 and D=2, PolyLUT-Add A=2,
# NeuraLUT with one hidden layer of 6
CONFIGS = {"D1": dict(), "D2": dict(degree=2), "A2": dict(adder_width=2),
           "neuralut": dict(hidden=(6,))}


def specs(name, widths=(10, 8, 5)):
    kw = dict(name="t", in_features=12, widths=widths, bits=2, fan_in=3,
              **CONFIGS[name])
    return JLD.ModelSpec(**kw), TLD.ModelSpec(**kw)


def numpy_model(spec, seed, random_bn=True):
    """A model tree of numpy leaves in the reference's layout: He-scaled
    weights, small biases, random (or initial) BN parameters and
    running stats, connectivity without repeats."""
    rng = np.random.default_rng(seed)

    def he(shape, fan):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan)).astype(
            np.float32)

    layers, conn = [], []
    for s in spec.layer_specs():
        n, A, F = s.n_out, s.adder_width, s.fan_in
        bn = {"gamma": np.ones(n, np.float32), "beta": np.zeros(n, np.float32),
              "mean": np.zeros(n, np.float32), "var": np.ones(n, np.float32)}
        if random_bn:
            bn = {"gamma": rng.uniform(0.5, 1.5, n).astype(np.float32),
                  "beta": rng.uniform(-0.3, 0.3, n).astype(np.float32),
                  "mean": rng.uniform(-0.3, 0.3, n).astype(np.float32),
                  "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        p = {"bn": bn}
        if s.hidden:
            dims = (F,) + tuple(s.hidden) + (1,)
            p["subnet"] = [{"w": he((n, A, dims[i], dims[i + 1]), dims[i]),
                            "b": 0.1 * he((n, A, dims[i + 1]), 1)}
                           for i in range(len(dims) - 1)]
            p["skip"] = he((n, A, F, 1), F)
        else:
            p["w"] = he((n, A, s.n_monomials), F)
            p["b"] = 0.1 * he((n, A), 1)
        layers.append(p)
        conn.append(np.stack([rng.permutation(s.n_in)[:A * F]
                              for _ in range(n)]).reshape(n, A, F)
                    .astype(np.int32))
    return {"layers": layers, "conn": conn}


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def batches(spec, n, seed, B=64):
    rng = np.random.default_rng(seed)
    return [{"x": rng.uniform(-1, 1, (B, spec.in_features)).astype(
                np.float32),
             "y": rng.integers(0, spec.widths[-1], B).astype(np.int32)}
            for _ in range(n)]


def max_err(a, b) -> float:
    errs = jax.tree.leaves(jax.tree.map(
        lambda u, v: float(np.max(np.abs(np.asarray(u) - np.asarray(v)),
                                  initial=0.0)), a, b))
    return max(errs)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("jsc", 600), ("mnist", 150),
                                    ("cifar10", 40)])
def test_data_matches_reference_bit_for_bit(name, n):
    j = JDS.make_dataset(name, n, seed=3)
    t = TDS.make_dataset(name, n, seed=3)
    for k in ("x", "y"):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    assert TDS.dataset_dims(name) == JDS.dataset_dims(name)
    js, ts = JDL.train_test_split(j, seed=1), TDL.train_test_split(t, seed=1)
    for part in ("train", "test"):
        for k in ("x", "y"):
            np.testing.assert_array_equal(ts[part][k], js[part][k])
    # two epochs' worth of batches: the reshuffle at the epoch edge too
    jit = JDL.batch_iterator(js["train"], 32, seed=2)
    tit = TDL.batch_iterator(ts["train"], 32, seed=2, device="cpu")
    for _ in range(2 * (len(ts["train"]["y"]) // 32) + 1):
        jb, tb = next(jit), next(tit)
        for k in ("x", "y"):
            assert tb[k].device.type == "cpu"
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# --------------------------------------------------------------------------
# poly, quant, batch norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("F,D", [(3, 1), (2, 2), (4, 2), (3, 3)])
def test_expand_and_its_gradient_match_reference(F, D):
    np.testing.assert_array_equal(TP.monomial_exponents(F, D),
                                  JP.monomial_exponents(F, D))
    assert TP.expand_shape((5, F), D) == JP.expand_shape((5, F), D)
    rng = np.random.default_rng(F * 10 + D)
    # the act_quant(2) grid puts exact zeros among the inputs
    x = rng.choice(np.float32([0.0, 1 / 3, 2 / 3, 1.0, -0.5]),
                   (16, F)).astype(np.float32)
    x[0] = 0.0
    c = rng.standard_normal((16, TP.num_monomials(F, D))).astype(
        np.float32)
    want, want_g = jax.jit(lambda v: (JP.expand(v, D), jax.grad(
        lambda u: jnp.sum(JP.expand(u, D) * c))(v)))(jnp.asarray(x))
    want, want_g = np.asarray(want), np.asarray(want_g)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TP.expand(tx, D)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(c)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits,low,high", [(2, -1.0, 1.0), (2, 0.0, 1.0),
                                           (3, -1.0, 1.0), (5, 0.0, 1.0)])
def test_quantize_ste_matches_reference(bits, low, high):
    j, t = JQ.QuantSpec(bits, low, high), TQ.QuantSpec(bits, low, high)
    rng = np.random.default_rng(bits)
    x = np.concatenate([rng.uniform(low - 0.5, high + 0.5, 512),
                        low + (np.arange(j.levels) + 0.5) * np.float32(
                            j.step)]).astype(np.float32)
    want, want_g = jax.jit(lambda v: (j.quantize(v), jax.grad(
        lambda u: jnp.sum(j.quantize(u) * 3.0))(v)))(jnp.asarray(x))
    want, want_g = np.asarray(want), np.asarray(want_g)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = t.quantize(tx)
    (got_g,) = torch.autograd.grad((got * 3.0).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(t.to_code(got.detach()).numpy(),
                                  np.asarray(j.to_code(jnp.asarray(want))))
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(t.all_values().numpy(),
                                  np.asarray(j.all_values()))


def test_batch_norm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 3, 7)).astype(np.float32) * 2 + 0.5
    p = {"gamma": rng.uniform(0.5, 1.5, 7), "beta": rng.uniform(-1, 1, 7),
         "mean": rng.uniform(-1, 1, 7), "var": rng.uniform(0.5, 2, 7)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = jax_tree(p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jy, jnew = jax.jit(JQ.bn_apply_train)(jp, jnp.asarray(x))
    ty, tnew = TQ.bn_apply_train(tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    for k in p:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        TQ.bn_apply_eval(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JQ.bn_apply_eval(jp, jnp.asarray(x))), rtol=0, atol=1e-6)
    jf, tf = JQ.bn_fold(jp), TQ.bn_fold(tp)
    np.testing.assert_allclose(tf.scale.numpy(), np.asarray(jf.scale),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf.offset.numpy(), np.asarray(jf.offset),
                               rtol=0, atol=1e-6)
    init = TQ.bn_init(7)
    for k, v in JQ.bn_init(7).items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))


# --------------------------------------------------------------------------
# forward and training
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward(name, train):
    jspec, _ = specs(name)
    return jax.jit(lambda m, x: JLD.forward(m, jspec, x, train=train))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name, train):
    jspec, tspec = specs(name)
    tree = numpy_model(jspec, seed=len(name))
    tmodel = TLD.model_from_numpy(tree, tspec, device="cpu")
    assert max_err(TLD.model_to_numpy(tmodel), tree) == 0.0
    (x,) = [b["x"] for b in batches(jspec, 1, seed=9)]
    jl, jm = _jax_forward(name, train)(jax_tree(tree), jnp.asarray(x))
    tl, tm = TLD.forward(tmodel, tspec, torch.from_numpy(x), train=train)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    for i, (jp, tp) in enumerate(zip(jm["layers"], tm["layers"])):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                tp["bn"][k].detach().numpy(), np.asarray(jp["bn"][k]),
                rtol=0, atol=1e-6, err_msg=f"layer {i} {k}")


def _bias_path(layer: dict):
    """(parent dict, key) of a layer's pre-BN bias."""
    return (layer["subnet"][-1], "b") if "subnet" in layer else (layer, "b")


def _layer_codes(model, spec, x, fwd):
    """Each hidden layer's output codes in eval mode."""
    out, h = [], x
    for p, c, s in zip(model["layers"], model["conn"], spec.layer_specs()):
        h, _ = fwd(p, c, s, h)
        if not s.is_output:
            out.append(s.out_quant.to_code(h))
    return out


@pytest.mark.parametrize("name", ["A2", "D2"])
def test_five_train_steps_match_reference(name):
    jspec, tspec = specs(name, widths=(8, 5))
    tree = numpy_model(jspec, seed=11, random_bn=False)
    _, jstep = JLD.make_train_step(jspec, lr=LR)
    jstep = jax.jit(jstep)
    jlayers = jax_tree(tree["layers"])
    jstate = {"model": {"layers": jlayers, "conn": jax_tree(tree["conn"])},
              "opt": jadamw(LR)[0](jlayers)}
    tmodel = TLD.model_from_numpy(tree, tspec, device="cpu")
    _, tstep = TLD.make_train_step(tspec, lr=LR)
    tstate = {"model": tmodel, "opt": tadamw(LR)[0](tmodel["layers"])}
    data = batches(jspec, 5, seed=12)
    for k, b in enumerate(data):
        jstate, jmet = jstep(jstate, jax_tree(b))
        tstate, tmet = tstep(tstate, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {k} loss")
        assert float(tmet["acc"]) == float(jmet["acc"])
        for i, (jl, tl) in enumerate(zip(jstate["model"]["layers"],
                                         tstate["model"]["layers"])):
            # the pre-BN bias: noise-level gradient in both packages,
            # at most lr a step apart; then the reference's is copied in
            jp, key = _bias_path(jl)
            tp, _ = _bias_path(tl)
            jmu, _ = _bias_path(jstate["opt"].mu[i])
            tmu, _ = _bias_path(tstate["opt"].mu[i])
            assert np.abs(np.asarray(jmu[key])).max() < 1e-6
            assert tmu[key].abs().max().item() < 1e-6
            assert np.abs(np.asarray(jp[key]) - tp[key].numpy()).max() \
                <= 2 * LR * (k + 1) + 1e-6
            tp[key] = torch.from_numpy(np.array(jp[key]))
            for moment in ("mu", "nu"):
                src, _ = _bias_path(getattr(jstate["opt"], moment)[i])
                dst, _ = _bias_path(getattr(tstate["opt"], moment)[i])
                dst[key] = torch.from_numpy(np.array(src[key]))
    jtree = jax.tree.map(np.asarray, jstate["model"])
    ttree = TLD.model_to_numpy(tstate["model"])
    x = data[-1]["x"]
    jcodes = jax.jit(lambda m, v: _layer_codes(m, jspec, v, JL.layer_forward))(
        jax_tree(jtree), jnp.asarray(x))
    tcodes = _layer_codes(tstate["model"], tspec, torch.from_numpy(x),
                          TL.layer_forward)
    differ = sum(int((np.asarray(a) != b.numpy()).sum())
                 for a, b in zip(jcodes, tcodes))
    err = max_err(ttree, jtree)
    assert err <= 1e-5, (f"parameters differ by {err}; {differ} hidden "
                         f"codes differ on the last batch")
    assert differ == 0, f"{differ} hidden codes differ on the last batch"
    for i in range(len(jspec.layer_specs())):
        for pkg, t in (("jax", jtree), ("torch", ttree)):
            bn = t["layers"][i]["bn"]
            assert np.all(bn["gamma"] == 1) and np.all(bn["beta"] == 0), \
                f"{pkg} layer {i}: BN gamma/beta moved"
        # the optimizer did compute an update of gamma, and it was
        # dropped (repro/core/lutdnn.py:113-115)
        assert tstate["opt"].mu[i]["bn"]["gamma"].abs().max() > 0


def test_random_conn_and_init_layer_contracts():
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(n_in=20, n_out=8, fan_in=3, adder_width=2),
               dict(n_in=6, n_out=5, fan_in=3, adder_width=2),
               dict(n_in=4, n_out=5, fan_in=3, adder_width=2)):
        s = TL.LayerSpec(**kw)
        conn = TL.random_conn(gen, s)
        assert conn.shape == (s.n_out, s.adder_width, s.fan_in)
        assert conn.dtype == torch.int32
        assert int(conn.min()) >= 0 and int(conn.max()) < s.n_in
        if s.total_fan_in <= s.n_in:      # no repeats within a neuron
            flat = conn.reshape(s.n_out, -1)
            assert all(len(set(r.tolist())) == s.total_fan_in for r in flat)
    for name in CONFIGS:
        jspec, tspec = specs(name)
        for js, ts in zip(jspec.layer_specs(), tspec.layer_specs()):
            want = jax.eval_shape(functools.partial(JL.init_layer, spec=js),
                                  jax.random.key(0))
            got = TL.init_layer(gen, ts)
            assert jax.tree.map(lambda a: tuple(a.shape), want) == \
                tree_map(lambda t: tuple(t.shape), got)
            # BN starts at gamma 1, beta 0, mean 0, var 1; biases at 0
            for k, v in (("gamma", 1), ("beta", 0), ("mean", 0),
                         ("var", 1)):
                assert torch.all(got["bn"][k] == v), k
            assert torch.all(_bias_path(got)[0]["b"] == 0)


def test_tiny_jsc_trains_above_chance():
    """tests/test_lutdnn.py's claim, through the port: tiny("jsc")
    trained 120 steps at lr 5e-3 scores above 0.45 (chance 0.2)."""
    data = TDL.train_test_split(TDS.make_dataset("jsc", 2000, seed=0))
    spec = TPM.tiny("jsc", degree=1)
    init_state, step = TLD.make_train_step(spec, lr=LR)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    it = TDL.batch_iterator(data["train"], 256, seed=0, device="cpu")
    for _ in range(120):
        state, _ = step(state, next(it))
    acc, loss = TLD.make_eval_step(spec)(state["model"],
                                         to_device(data["test"], "cpu"))
    assert float(acc) > 0.45 and np.isfinite(float(loss))
