"""Port parity of the connectivity search (Alg. 1 + Alg. 2):
``repro_torch.core.masking``, ``core.sparse_train`` and the search half
of ``core.lutdnn`` against the JAX package, at tiny sizes (tiny-jsc,
16 -> 32, 16, 5).

``jax.random`` and ``torch.Generator`` draw different numbers, so
parity is shown by carrying state and draws across, never by seeds:
the control functions take their draws as tensors, and the tests feed
them the reference's own ``jax.random`` draws.  Stated tolerances:

* masking (``effective_weight`` value and gradient, ``mask_to_indices``,
  ``final_mask``, ranks with ties), the schedule, ``sparse_control`` /
  ``deepr_control`` / ``sparse_control_layer`` fed the reference's draws,
  the fan-in ledger, ``masks_to_conn``: bit for bit, against the
  reference as written (op by op).  Under ``jax.jit`` XLA rewrites two
  of its expressions (``step / ramp_end`` as a multiply by the float32
  reciprocal, and the random walk's rounding); the jitted schedule is
  held equal at the protocols' configurations, the jitted control step
  to the same active set and theta within 1e-12;
* SGD over ``ThetaLayer`` trees: 1e-7 absolute over 3 steps;
* one whole search step from a carried-across state: loss 1e-6, dense
  and theta gradients 1e-5, then equal active sets and theta, bias and
  momentum within 1e-5;
* within the port, member p of a population equals a lone search from
  the same start: masks equal.

The JAX search step is jitted, as every caller of the reference jits
it."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifact import load_artifact as jload
from repro.configs import paper_models as JPM
from repro.core import lutdnn as JLD
from repro.core import masking as JM
from repro.core import sparse_train as JS
from repro.data.loader import batch_iterator as jbatches
from repro.data.loader import train_test_split
from repro.data.synthetic import make_dataset
from repro.optim.adamw import OptState as JA_OptState
from repro.optim.adamw import apply_updates as japply
from repro.optim.adamw import sgd as jsgd
from repro_torch.artifact import load_artifact, save_artifact
from repro_torch.configs import paper_models as TPM
from repro_torch.core import lut_synth as TLS
from repro_torch.core import lutdnn as TLD
from repro_torch.core import masking as TM
from repro_torch.core import sparse_train as TS
from repro_torch.data.loader import batch_iterator as tbatches
from repro_torch.optim.adamw import apply_updates as tapply
from repro_torch.optim.adamw import sgd as tsgd
from repro_torch.optim.adamw import tree_leaves, tree_map

torch.set_num_threads(1)

LR = 0.15
N_IN, N_OUT = 16, 32


def t(a):
    return torch.from_numpy(np.array(a))


def bits(a):
    """float32 bit patterns, so -0.0 and 0.0 differ."""
    return np.asarray(a, np.float32).view(np.int32)


def jax_draws(key, shape):
    """The draws ``sparse_control`` / ``deepr_control`` make from
    ``key``: (normals for the random walk, uniforms for regrowth)."""
    k_noise, k_grow = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, shape)),
            np.asarray(jax.random.uniform(k_grow, shape)))


def control_case(seed):
    """theta on a coarse grid (exact ties), some at eps1 and at 0, some
    negative (inactive); a gradient with dead rows (exact zeros); signs."""
    rng = np.random.default_rng(seed)
    theta = (np.round(rng.normal(size=(N_IN, N_OUT)) * 4) / 4).astype(
        np.float32)
    theta[rng.random((N_IN, N_OUT)) < 0.1] = 1e-12
    grad = rng.normal(size=(N_IN, N_OUT)).astype(np.float32)
    grad[rng.integers(0, N_IN, 3)] = 0.0
    sign = np.where(rng.random((N_IN, N_OUT)) < 0.5, 1.0, -1.0).astype(
        np.float32)
    return theta, grad, sign


# ---------------------------------------------------------------- masking

def test_effective_weight_value_and_gradient_gating():
    theta, _, sign = control_case(0)
    c = np.random.default_rng(1).normal(size=theta.shape).astype(np.float32)
    jw = JM.effective_weight(jnp.asarray(theta), jnp.asarray(sign))
    jg = jax.grad(lambda th: jnp.sum(JM.effective_weight(
        th, jnp.asarray(sign)) * c))(jnp.asarray(theta))
    th = t(theta).requires_grad_(True)
    tw = TM.effective_weight(th, t(sign))
    (tg,) = torch.autograd.grad((tw * t(c)).sum(), th)
    assert np.array_equal(bits(jw), bits(tw.detach()))
    assert np.array_equal(bits(jg), bits(tg))
    assert (tg.numpy()[theta <= 0] == 0).all()          # inactive: gated
    lay = TM.ThetaLayer(theta=t(theta), sign=t(sign),
                        bias=torch.zeros(N_OUT))
    assert np.array_equal(lay.fan_in().numpy(), np.asarray(
        JM.ThetaLayer(jnp.asarray(theta), jnp.asarray(sign),
                      jnp.zeros(N_OUT)).fan_in()))


def test_mask_to_indices_bit_equal():
    rng = np.random.default_rng(2)
    mask = (rng.random((N_IN, N_OUT)) < 0.2).astype(np.float32)
    mask[:, 0] = 0.0
    mask[3, 0] = 1.0                     # one active: repeated
    mask[:, 1] = 1.0                     # all active: the lowest four
    for f in (1, 4):
        want = np.asarray(JM.mask_to_indices(jnp.asarray(mask), f))
        got = TM.mask_to_indices(t(mask), f)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy())


def test_final_mask_tied_o1_thetas_bit_equal():
    rng = np.random.default_rng(3)
    theta = rng.choice(np.float32([1.0, 1.0, 0.5, 0.0, -0.0, -1.0]),
                       size=(N_IN, N_OUT))
    for f in (1, 3, N_IN, N_IN + 2):
        want = np.asarray(JM.final_mask(jnp.asarray(theta), f))
        got = TM.final_mask(t(theta), f).numpy()
        assert np.array_equal(want, got)
        assert (got.sum(0) == min(f, N_IN)).all()


@pytest.mark.parametrize("case", ["signed_zeros", "infinities",
                                  "eps1_and_zero"])
def test_ranks_tie_order_equals_reference(case):
    """Ranks on the tie patterns the controller makes: -0.0 against 0.0
    (equal to both sorts), -inf for the excluded, regrown connections
    all at eps1 and hard-pruned ones at exactly 0."""
    rng = np.random.default_rng(4)
    vals = {"signed_zeros": [0.0, -0.0, 1.0, -1.0],
            "infinities": [-np.inf, np.inf, 0.5, -0.5],
            "eps1_and_zero": [1e-12, 0.0, -1e-12, 2.0]}[case]
    score = rng.choice(np.float32(vals), size=(N_IN, N_OUT))
    want = np.asarray(JS._ranks_desc(jnp.asarray(score)))
    assert np.array_equal(want, TM.ranks_desc(t(score)).numpy())
    stacked = np.stack([score, score[::-1]])
    got = TM.ranks_desc(t(stacked)).numpy()
    assert np.array_equal(got[1], np.asarray(
        JS._ranks_desc(jnp.asarray(score[::-1]))))


@pytest.mark.parametrize("n_in,n_out,fi", [(16, 32, 3), (5, 7, 5),
                                           (12, 4, None)])
def test_init_theta_layer_and_random_mask_invariants(n_in, n_out, fi):
    gen = torch.Generator().manual_seed(n_in)
    lay = TM.init_theta_layer(gen, n_in, n_out, fi, device="cpu")
    want = n_in if fi is None else min(fi, n_in)
    assert (lay.fan_in() == want).all()
    assert set(lay.sign.unique().tolist()) <= {-1.0, 1.0}
    assert (lay.theta >= 0).all() and (lay.bias == 0).all()
    m = TM.random_mask(gen, n_in, n_out, 3)
    assert (m.sum(0) == min(3, n_in)).all()
    assert set(m.unique().tolist()) <= {0.0, 1.0}


# --------------------------------------------------------------- schedule

_RAMPS = [(T, cf, rp) for T in (5, 18, 20, 60, 100)
          for cf in (0.0, 0.25, 0.5) for rp in (1.0, 3.0)]
_WIDTHS = [(fo, n_in) for fo in (1, 3, 8) for n_in in (2, 16, 100, 256, 784)]
# each of the 30 ramps meets 5 of the 15 (F_o, n_in) pairs, a block that
# starts 7 further on for each ramp, so each pair meets 10 ramps
SCHEDULE_GRID = [ramp + _WIDTHS[(7 * i + j) % len(_WIDTHS)]
                 for i, ramp in enumerate(_RAMPS) for j in range(5)]
# the protocols' configurations: [search] (HDR-Add2, 100 steps at
# phase_frac 0.6) and this file's (tiny-jsc, F=3 and 2)
PROTOCOL_GRID = [(60, 0.25, 3.0, 8, n) for n in (784, 256, 100)] + \
    [(T, 0.25, 3.0, 2, 16) for T in (14, 36)]


def _schedules(grid, jit):
    out = []
    for T, cf, rp, fo, n_in in grid:
        c = JS.SparsityConfig(target_fan_in=fo, phase_boundary=T,
                              cooldown_frac=cf, ramp_power=rp)
        steps = jnp.arange(T + 3, dtype=jnp.int32)
        fn = lambda s: JS.scheduled_target(c, s, n_in)    # noqa: E731
        want = np.asarray((jax.jit(fn) if jit else fn)(steps))
        got = TS.scheduled_target(
            TS.SparsityConfig(target_fan_in=fo, phase_boundary=T,
                              cooldown_frac=cf, ramp_power=rp),
            torch.arange(T + 3, dtype=torch.int32), n_in)
        assert got.dtype == torch.int32
        out.append(((T, cf, rp, fo, n_in), want, got.numpy()))
    return out


def test_scheduled_target_equals_reference_as_integers():
    """Over 150 configurations, every step: the reference as written
    (float32 ``step / ramp_end``, cubic or other power, floor, max with
    F_o).  The jitted reference multiplies by the float32 reciprocal
    instead, which can land one lower where f(t) is an exact integer;
    at the protocols' configurations it does not."""
    for cfg, want, got in _schedules(SCHEDULE_GRID, jit=False):
        assert np.array_equal(want, got), cfg
    for cfg, want, got in _schedules(PROTOCOL_GRID, jit=True):
        assert np.array_equal(want, got), cfg


# ----------------------------------------------------------- control step

PHASES = {"ramp": 3, "swap": 5, "cooldown": 17, "finetune": 25}


def _cfg_kw(mode, noise):
    # phase boundary 20 -> ramp_end 15: step 3 ramps, 5 swaps, 17 cools
    # down, 25 fine-tunes; noise 0 keeps the grid's exact theta ties
    return dict(target_fan_in=3, phase_boundary=20, grow_mode=mode,
                eps2=2e-3, noise_std=noise, l1=1e-5 if noise else 0.0)


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("mode", ["grad", "theta", "random"])
def test_sparse_control_bit_equal_with_reference_draws(mode, phase):
    step = PHASES[phase]
    for noise, with_grad in ((1e-5, True), (0.0, True), (1e-5, False)):
        theta, grad, sign = control_case(step + 10 * int(with_grad))
        key = jax.random.key(step)
        normal, u = jax_draws(key, theta.shape)
        kw = _cfg_kw(mode, noise)
        g = (jnp.asarray(grad), jnp.asarray(sign)) if with_grad else \
            (None, None)
        jt, jr = JS.sparse_control(jnp.asarray(theta), key, jnp.int32(step),
                                   JS.SparsityConfig(**kw), LR, grad=g[0],
                                   sign=g[1], return_regrown=True)
        tg = (t(grad), t(sign)) if with_grad else (None, None)
        tt, tr = TS.sparse_control(t(theta), t(normal), t(u),
                                   torch.tensor(step, dtype=torch.int32),
                                   TS.SparsityConfig(**kw), LR, grad=tg[0],
                                   sign=tg[1], return_regrown=True)
        assert np.array_equal(bits(jt), bits(tt)), (noise, with_grad)
        assert np.array_equal(np.asarray(jr), tr.numpy())
        # the invariants the reference's tests pin
        f = TS.scheduled_target(TS.SparsityConfig(**kw), step, N_IN)
        fan = (tt > 0).sum(0)
        assert (fan <= f).all()
        if step >= 15:
            assert (fan == 3).all()
    if phase != "swap":
        return
    # under jax.jit the random walk rounds its 1.5e-6 terms differently
    # (a float32 ulp there is 1.1e-13): the same actives, theta within
    # 1e-12
    jj = jax.jit(lambda th, k: JS.sparse_control(
        th, k, jnp.int32(step), JS.SparsityConfig(**_cfg_kw(mode, 1e-5)),
        LR))(jnp.asarray(theta), key)
    assert np.array_equal(np.asarray(jj) > 0, tt.numpy() > 0)
    np.testing.assert_allclose(np.asarray(jj), tt.numpy(), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("noise", [1e-5, 0.0])
def test_deepr_control_bit_equal_with_reference_draws(noise):
    theta, _, _ = control_case(7)
    key = jax.random.key(8)
    normal, u = jax_draws(key, theta.shape)
    kw = _cfg_kw("random", noise)
    want = JS.deepr_control(jnp.asarray(theta), key,
                            JS.SparsityConfig(**kw), LR)
    got = TS.deepr_control(t(theta), t(normal), t(u),
                           TS.SparsityConfig(**kw), LR)
    assert np.array_equal(bits(want), bits(got))
    assert ((got > 0).sum(0) >= 3).all()


def test_sparse_control_layer_sign_reinit_and_ledger_equal():
    theta, grad, sign = control_case(9)
    bias = np.linspace(-1, 1, N_OUT).astype(np.float32)
    kw = _cfg_kw("grad", 1e-5)
    key = jax.random.key(10)
    normal, u = jax_draws(key, theta.shape)
    jl = JS.sparse_control_layer(
        JM.ThetaLayer(jnp.asarray(theta), jnp.asarray(sign),
                      jnp.asarray(bias)), key, jnp.int32(5),
        JS.SparsityConfig(**kw), LR, grad=jnp.asarray(grad))
    tl = TS.sparse_control_layer(
        TM.ThetaLayer(t(theta), t(sign), t(bias)), t(normal), t(u),
        torch.tensor(5, dtype=torch.int32), TS.SparsityConfig(**kw), LR,
        grad=t(grad))
    for f in ("theta", "sign", "bias"):
        assert np.array_equal(bits(getattr(jl, f)), bits(getattr(tl, f)))
    assert not np.array_equal(np.asarray(jl.sign), sign)   # re-initialised
    cfgs = [JS.SparsityConfig(**kw), JS.SparsityConfig(**kw)]
    tcfgs = [TS.SparsityConfig(**kw), TS.SparsityConfig(**kw)]
    jls = [jl, JM.ThetaLayer(jnp.asarray(theta), jnp.asarray(sign),
                             jnp.asarray(bias))]
    tls = [tl, TM.ThetaLayer(t(theta), t(sign), t(bias))]
    assert JS.fan_in_ledger(jls, cfgs) == TS.fan_in_ledger(tls, tcfgs)
    assert int(JS.fan_in_violation(jls, cfgs)) == \
        int(TS.fan_in_violation(tls, tcfgs))


# ------------------------------------------------------------- optimizer

def test_sgd_walks_theta_layers_as_the_reference():
    """``optim.adamw.tree_map`` walks dataclasses and named tuples, so
    ``sgd(0.15, momentum=0.9)`` over ThetaLayers gives the reference's
    ``OptState`` tree after 3 steps."""
    rng = np.random.default_rng(11)
    shapes = [(6, 4), (4, 3)]

    def layer(lib, arr):
        return lib.ThetaLayer(theta=arr[0], sign=arr[1], bias=arr[2])

    raw = [[rng.normal(size=s).astype(np.float32),
            rng.normal(size=s).astype(np.float32),
            rng.normal(size=s[1]).astype(np.float32)] for s in shapes]
    jp = [layer(JM, [jnp.asarray(a) for a in r]) for r in raw]
    tp = [layer(TM, [t(a) for a in r]) for r in raw]
    ji, ju = jsgd(LR, momentum=0.9)
    ti, tu = tsgd(LR, momentum=0.9)
    js, ts = ji(jp), ti(tp)
    assert isinstance(ts.mu[0], TM.ThetaLayer)
    for i in range(3):
        graw = [[rng.normal(size=a.shape).astype(np.float32) for a in r]
                for r in raw]
        jupd, js = ju([layer(JM, [jnp.asarray(a) for a in g])
                       for g in graw], js, jp)
        tupd, ts = tu([layer(TM, [t(a) for a in g]) for g in graw], ts, tp)
        jp, tp = japply(jp, jupd), tapply(tp, tupd)
    assert int(ts.step) == int(js.step) == 3 and ts.nu is None
    for a, b in zip(jax.tree.leaves((jp, js.mu)),
                    tree_leaves((tp, ts.mu))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-7,
                                   rtol=0)


# ------------------------------------------------------ whole search step

@pytest.fixture(scope="module")
def jsc():
    return train_test_split(make_dataset("jsc", n_samples=1500, seed=0))


def _dense_grads(spec, tlayers, x, y, lib):
    """(loss, [dL/dtheta], [dL/dW]) of the quantized proxy, from each
    package's own pieces."""
    if lib == "jax":
        lspecs = spec.layer_specs()

        def loss_fn(tl, probes):
            h = lspecs[0].in_quant.quantize(x)
            for i, (l, p) in enumerate(zip(tl, probes)):
                z = JLD._standardize(h @ (l.effective_weight() + p)) + l.bias
                h = lspecs[i].out_quant.quantize(jax.nn.relu(z)) \
                    if i < len(tl) - 1 else z
            return JLD.cross_entropy(h, y)
        probes = [jnp.zeros_like(l.theta) for l in tlayers]
        loss, (gt, gp) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1)))(tlayers, probes)
        return (float(loss), [np.asarray(g.theta) for g in gt],
                [np.asarray(g) for g in gp])
    th = [l.theta.clone().requires_grad_(True) for l in tlayers]
    probes = [torch.zeros_like(l.theta, requires_grad=True)
              for l in tlayers]
    live = [TM.ThetaLayer(a, l.sign, l.bias) for a, l in zip(th, tlayers)]
    loss = TLD._member_loss(TLD._proxy_forward(live, x, spec, probes), y)
    got = torch.autograd.grad(loss, th + probes)
    n = len(th)
    return (float(loss.detach()), [g.numpy() for g in got[:n]],
            [g.numpy() for g in got[n:]])


@jax.jit
def _step_draws(key, like):
    """The draws the reference's step makes from its state's key, for
    layers shaped as ``like`` (one compile for every test here)."""
    _, sub = jax.random.split(key)
    out = []
    for k, x in zip(jax.random.split(sub, len(like)), like):
        k_noise, k_grow = jax.random.split(k)
        out.append((jax.random.normal(k_noise, x.shape),
                    jax.random.uniform(k_grow, x.shape)))
    return out


def _reference_step_draws(jstate):
    """The draws the reference's step makes from its state's key."""
    like = [l.theta for l in jstate["tlayers"]]
    return [tuple(t(a) for a in d) for d in _step_draws(jstate["key"], like)]


@pytest.mark.parametrize("mode", ["sparselut", "deepr"])
def test_search_step_from_carried_state(jsc, mode):
    """The reference runs 10 jitted steps from a start the port drew
    (dense for Alg. 2, at the target fan-in for DeepR, as each mode's
    ``init_state`` starts; carried to the reference as numpy); its state
    (step 10, a swap step, sparse, with momentum) is carried across, and
    both packages take step 10 on the same batch with the reference's
    draws."""
    jspec, tspec = JPM.tiny("jsc"), TPM.tiny("jsc")
    cfgs = JLD.search_sparsity_configs(jspec, 18, eps2=2e-3)
    tcfgs = TLD.search_sparsity_configs(tspec, 18, eps2=2e-3)
    _, jstep = JLD.make_search_step(jspec, cfgs, LR, mode=mode)
    _, tstep = TLD.make_search_step(tspec, tcfgs, LR, mode=mode)
    jstep = jax.jit(jstep)
    fi = None if mode == "sparselut" else tcfgs[0].target_fan_in
    start = [JM.ThetaLayer(*(jnp.asarray(a.numpy()) for a in
                             (l.theta, l.sign, l.bias)))
             for l in TLD.init_search_model(torch.Generator().manual_seed(3),
                                            tspec, fi, device="cpu")]
    jstate = {"tlayers": start, "opt": jsgd(LR, momentum=0.9)[0](start),
              "key": jax.random.key(3), "step": jnp.zeros((), jnp.int32)}
    it = jbatches(jsc["train"], 128, seed=3)
    for _ in range(10):
        jstate, _ = jstep(jstate, next(it))
    batch = next(it)
    tree = jax.tree.map(np.asarray, {k: jstate[k] for k in
                                     ("tlayers", "opt", "step")})
    tstate = TLD.search_state_from_numpy(tree, device="cpu")
    back = TLD.search_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(tree["tlayers"]),
                    tree_leaves(back["tlayers"])):
        assert np.array_equal(a, b)
    tbatch = {k: t(v) for k, v in batch.items()}

    if mode == "sparselut":       # the dense gradient regrowth ranks
        jl, jgt, jgp = _dense_grads(jspec, jstate["tlayers"],
                                    jnp.asarray(batch["x"]),
                                    jnp.asarray(batch["y"]), "jax")
        tl, tgt, tgp = _dense_grads(tspec, tstate["tlayers"], tbatch["x"],
                                    tbatch["y"], "torch")
        assert abs(jl - tl) <= 1e-6
        for a, b in zip(jgt + jgp, tgt + tgp):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    jnew, jm = jstep(jstate, batch)
    tnew, tm = tstep(tstate, tbatch, draws=_reference_step_draws(jstate))
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-6
    assert float(jm["acc"]) == float(tm["acc"])
    assert int(tnew["step"]) == int(jnew["step"]) == 11
    for jl_, tl_, jmu, tmu in zip(jnew["tlayers"], tnew["tlayers"],
                                  jnew["opt"].mu, tnew["opt"].mu):
        assert np.array_equal(np.asarray(jl_.theta) > 0,
                              tl_.theta.numpy() > 0)
        for a, b in ((jl_.theta, tl_.theta), (jl_.bias, tl_.bias),
                     (jl_.sign, tl_.sign), (jmu.theta, tmu.theta),
                     (jmu.bias, tmu.bias)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                       atol=1e-5, rtol=0)


def test_search_forward_both_forms_match_reference(jsc):
    """The float relu MLP and the quantized proxy (``spec``), on one
    start (drawn by the port, fan-in 5, bias 0.1) carried across to both
    packages as numpy: logits within 1e-5."""
    jspec, tspec = JPM.tiny("jsc"), TPM.tiny("jsc")
    start = TLD.init_search_model(torch.Generator().manual_seed(4), tspec,
                                  5, device="cpu")
    tl = [JM.ThetaLayer(jnp.asarray(l.theta.numpy()),
                        jnp.asarray(l.sign.numpy()),
                        jnp.asarray(l.bias.numpy() + 0.1)) for l in start]
    tree = {"tlayers": jax.tree.map(np.asarray, tl),
            "opt": JA_OptState(step=0, mu=tl, nu=None), "step": 0}
    ttl = TLD.search_state_from_numpy(tree, device="cpu")["tlayers"]
    x = jsc["test"]["x"][:64]
    for spec in (None, "proxy"):
        want = jax.jit(lambda t, xx: JLD.search_forward(
            t, xx, jspec if spec else None))(tl, jnp.asarray(x))
        got = TLD.search_forward(ttl, t(x), tspec if spec else None)
        np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------- population

def test_population_member_equals_lone_search(jsc):
    spec = TPM.tiny("jsc", fan_in=2)
    kw = dict(n_steps=24, phase_frac=0.6, eps2=2e-3, device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    masks, scores, hist, states = TLD.search_connectivity_population(
        gens, spec, tbatches(jsc["train"], 128, seed=5, device="cpu"), **kw)
    assert states["tlayers"][0].theta.shape == (4, 16, 32)
    for m, ls in zip(masks, spec.layer_specs()):
        assert m.shape[0] == 4
        assert (m.sum(1) == ls.total_fan_in).all()
    for p in range(4):
        lone, lhist, _ = TLD.search_connectivity(
            torch.Generator().manual_seed(p), spec,
            tbatches(jsc["train"], 128, seed=5, device="cpu"), **kw)
        assert all(torch.equal(a[p], b) for a, b in zip(masks, lone))
    # history: the integer cadence plus the final step
    cad = TLD.history_cadence(kw["n_steps"])
    steps = [h["step"] for h in hist]
    assert steps[-1] == kw["n_steps"] - 1
    assert all(s % cad == 0 for s in steps[:-1])
    assert [h["step"] for h in lhist] == steps
    best_masks, best = TLD.select_best_masks(masks, scores)
    assert best == int(np.argmax(scores.numpy()))
    assert all(torch.equal(bm, m[best]) for bm, m in zip(best_masks, masks))
    # ties go to the lowest index
    assert TLD.select_best_masks(masks, torch.tensor(
        [0.5, 0.7, 0.7, 0.1]))[1] == 1
    # a mesh is a parallel.sharding.Mesh (tests/test_torch_sharded.py
    # runs the sharded search)
    with pytest.raises(TypeError, match="Mesh"):
        TLD.search_connectivity_population(gens, spec, iter(()),
                                           n_steps=1, mesh=object())


def test_population_qat_members_stacked(jsc):
    spec = TPM.tiny("jsc")
    states = TLD.population_init(torch.Generator().manual_seed(0), spec, 3,
                                 device="cpu")
    w0 = states["model"]["layers"][0]["w"]
    assert w0.shape[0] == 3 and not torch.equal(w0[0], w0[1])
    _, step = TLD.make_train_step(spec)
    lone = tree_map(lambda x: x[1], states)
    pop_step = TLD.make_population_step(spec)
    it = tbatches(jsc["train"], 128, seed=1, device="cpu")
    for _ in range(3):
        b = next(it)
        states, met = pop_step(states, b)
        lone, lmet = step(lone, b)
    assert met["loss"].shape == (3,)
    assert float(met["loss"][1]) == float(lmet["loss"])
    assert torch.equal(states["model"]["layers"][0]["w"][1],
                       lone["model"]["layers"][0]["w"])


def test_search_entry_points_need_a_card_unless_told(monkeypatch):
    spec = TPM.tiny("jsc")
    cfgs = TLD.search_sparsity_configs(spec, 10)
    init_state, _ = TLD.make_search_step(spec, cfgs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TLD.init_search_model(torch.Generator(), spec),
                 lambda: init_state(torch.Generator()),
                 lambda: TLD.population_search_init([torch.Generator()],
                                                    spec, cfgs),
                 lambda: TLD.search_state_from_numpy(
                     TLD.search_state_to_numpy(
                         init_state(torch.Generator(), "cpu")))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert init_state(torch.Generator(), "cpu")["step"].device.type == "cpu"


# ------------------------------------------------------ toolflow end to end

def test_toolflow_search_qat_synthesise_artifact(jsc, tmp_path):
    """Search (60 steps) -> exact fan-in -> masks_to_conn -> QAT ->
    synthesise -> save_artifact(search=...), read by the JAX package
    with the same id and ``search`` dict.  The same numpy masks give the
    same conn in both packages, bit for bit, and one model with one conn
    synthesises to the same artifact id in both
    (``test_torch_synth.py::test_both_packages_save_the_same_artifact``);
    provenance of one search state is JSON-equal in both packages."""
    spec = TPM.tiny("jsc", degree=1, adder_width=2, fan_in=2)
    jspec = JPM.tiny("jsc", degree=1, adder_width=2, fan_in=2)
    n_steps = 60
    masks, hist, state = TLD.search_connectivity(
        torch.Generator().manual_seed(1), spec,
        tbatches(jsc["train"], 256, seed=1, device="cpu"), n_steps,
        phase_frac=0.6, eps2=2e-3, device="cpu")
    cfgs = TLD.search_sparsity_configs(spec, int(n_steps * 0.6), eps2=2e-3)
    assert int(TS.fan_in_violation(state["tlayers"], cfgs)) <= 0
    for m, s in zip(masks, spec.layer_specs()):
        assert (m.sum(0) == s.total_fan_in).all()
    conn = TLD.masks_to_conn(masks, spec)
    jconn = jax.jit(lambda ms: JLD.masks_to_conn(ms, jspec))(
        [jnp.asarray(m.numpy()) for m in masks])
    for c, jc, s in zip(conn, jconn, spec.layer_specs()):
        assert c.shape == (s.n_out, s.adder_width, s.fan_in)
        assert c.dtype == torch.int32
        assert np.array_equal(np.asarray(jc), c.numpy())

    init_state, step = TLD.make_train_step(spec, lr=5e-3)
    st = init_state(torch.Generator().manual_seed(2), device="cpu")
    st["model"]["conn"] = conn
    it = tbatches(jsc["train"], 256, seed=2, device="cpu")
    for _ in range(20):
        st, _ = step(st, next(it))
    tables = TLS.synthesise(st["model"], spec)
    prov = TLD.search_provenance(spec, cfgs, state, n_steps=n_steps, lr=LR,
                                 seeds=1, history=hist)
    assert prov["fan_in_ledger"][0]["fan_in_max"] == 4
    path = save_artifact(str(tmp_path / "t"), tables, name="s", spec=spec,
                         search=prov)
    art = load_artifact(path, device="cpu")
    jart = jload(path)
    assert jart.artifact_id == art.artifact_id
    assert jart.search == art.search == json.loads(json.dumps(prov))


    # provenance of one state in both packages
    jstate_tl = [JM.ThetaLayer(jnp.asarray(l.theta.numpy()),
                               jnp.asarray(l.sign.numpy()),
                               jnp.asarray(l.bias.numpy()))
                 for l in state["tlayers"]]
    jcfgs = JLD.search_sparsity_configs(jspec, int(n_steps * 0.6),
                                        eps2=2e-3)
    jprov = JLD.search_provenance(jspec, jcfgs, {"tlayers": jstate_tl},
                                  n_steps=n_steps, lr=LR, seeds=1,
                                  history=hist)
    assert json.dumps(jprov, sort_keys=True) == \
        json.dumps(prov, sort_keys=True)
