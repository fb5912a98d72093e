"""Port parity of the RG-LRU (``repro_torch.models.recurrent`` ``rglru_*``
and the ``rglru`` mixer of ``repro_torch.models.lm``) against the JAX
package's ``repro.models``, at the recurrentgemma smoke config in
float32.

Weights are drawn by the port and carried into the reference's layout;
inputs come from numpy seeds.  Every comparison holds within 1e-5
(relative and absolute): the port's doubling scan and the reference's
associative scan multiply the same float32 decays in other groupings,
and the packages differ otherwise only in the order of float32 sums.
Each JAX reference is jitted once; torch runs on one thread."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro.models import recurrent as JRC
from repro.models import registry as JR
from repro_torch.models import lm as TLM
from repro_torch.models import recurrent as TRC
from repro_torch.models import registry as TR

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
D, R = 16, 24


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.detach().numpy())


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


_JRGLRU = jax.jit(JRC.rglru_apply)


def _mixer(seed=0):
    return TRC.rglru_init(torch.Generator().manual_seed(seed), D, R,
                          dtype=torch.float32, device=CPU)


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"h": torch.from_numpy(rng.normal(size=(2, R)).astype(np.float32)),
            "conv": torch.from_numpy(
                rng.normal(size=(2, 3, R)).astype(np.float32))}


@pytest.mark.parametrize("floor", [False, True])
def test_rglru_apply_matches_reference(floor):
    """``rglru_apply`` over a ragged 37 tokens from a given state (h and
    the conv's last inputs): output and new state.  ``floor``: every
    decay at its floor, Lambda = 6 and r = 1 (positive inputs through
    positive weights, a large positive r-gate), a = exp(-8 softplus(6))
    ~ 1.4e-21 a token: finite, and still the reference's numbers."""
    tp = _mixer()
    x = np.random.default_rng(1).normal(size=(2, 37, D)).astype(np.float32)
    state = _state(2)
    if floor:
        x = np.abs(x)
        for k in ("w_x", "conv_w"):
            tp[k] = tp[k].abs()
        state["conv"] = state["conv"].abs()
        tp["w_rgate"] = torch.full((R, R), 100.0)
        tp["lam"] = torch.full((R,), 6.0)
    jp = jax.tree.map(_jnp, tp)
    want, wstate = _JRGLRU(jp, jnp.asarray(x), jax.tree.map(_jnp, state))
    got, gstate = TRC.rglru_apply(tp, torch.from_numpy(x), state)
    _close(got, want, "out")
    for k in ("h", "conv"):
        _close(gstate[k], wstate[k], f"state {k}")
    assert bool(torch.isfinite(got).all())
    if floor:
        r = torch.sigmoid(TRC._causal_conv(torch.from_numpy(x) @ tp["w_x"],
                                           tp["conv_w"], state["conv"])[0]
                          @ tp["w_rgate"])
        assert bool((r == 1.0).all())


def test_rglru_decode_steps_equal_one_scan():
    """Token-by-token ``rglru_decode`` from a state leaves the outputs
    and the state that one ``rglru_apply`` over the same tokens does."""
    tp = _mixer(3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 19, D)).astype(np.float32))
    state = _state(5)
    full, fstate = TRC.rglru_apply(tp, x, state)
    st, outs = state, []
    for t in range(x.shape[1]):
        o, st = TRC.rglru_decode(tp, x[:, t:t + 1], st)
        outs.append(o)
    _close(torch.cat(outs, 1), full.numpy(), "outputs")
    for k in ("h", "conv"):
        _close(st[k], fstate[k].numpy(), f"state {k}")


def test_lru_scan_is_the_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t run in order,
    at lengths on both sides of a power of two and at 1."""
    rng = np.random.default_rng(6)
    for S in (1, 2, 7, 8, 9, 33):
        a = torch.from_numpy(rng.uniform(0, 1, (2, S, 5)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, S, 5)).astype(np.float32))
        h0 = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
        h, want = h0, []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(TRC._lru_scan(a, b, h0), torch.stack(want, 1).numpy(),
               f"S={S}")


B, P, GEN = 2, 12, 8      # the smoke config's window is 16: decode wraps it


def test_recurrentgemma_matches_reference_prefill_decode():
    """recurrentgemma smoke (rglru, rglru, local over 5 layers): the
    port's forward against the reference's, and its prefill and decode
    steps past the local layers' 16-slot ring against the reference's
    own prefill and decode: logits and every cache entry (h, conv, and
    the ring's K and V)."""
    jcfg = dataclasses.replace(JR.get_config("recurrentgemma-9b", True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TR.get_config("recurrentgemma-9b", True),
                               dtype=torch.float32)
    tparams = TLM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = jax.tree.map(_jnp, TLM.params_to_stacked(tparams, tcfg))
    toks = np.random.default_rng(7).integers(0, 128, (B, P + GEN)
                                             ).astype(np.int32)
    t = torch.from_numpy(toks)
    want, _ = jax.jit(lambda p, x: JLM.forward(p, jcfg, x))(
        jparams, jnp.asarray(toks))
    _close(TLM.forward(tparams, tcfg, t)[0], want, "forward")

    jl, jc = jax.jit(lambda p, x: JLM.prefill(p, jcfg, x, P + GEN))(
        jparams, jnp.asarray(toks[:, :P]))
    tl, tc = TR.make_prefill_step(tcfg, P + GEN)(tparams, t[:, :P])
    jstep = jax.jit(lambda p, c, x, pos: JLM.decode_step(p, jcfg, c, x, pos))
    tstep = TR.make_serve_step(tcfg)
    for i in range(GEN + 1):
        _close(tl, jl, f"step {i}")
        if i == GEN:
            break
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, P + i:P + i + 1]),
                       jnp.int32(P + i))
        tl, tc = tstep(tparams, tc, t[:, P + i:P + i + 1], P + i)
    jlayers = TLM.layers_from_stacked(jax.tree.map(np.asarray, jc), tcfg)
    kinds = [m for m, _ in tcfg.kinds]
    assert kinds == ["rglru", "rglru", "local", "rglru", "rglru"]
    for layer, (a, b) in enumerate(zip(jlayers, tc["blocks"])):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(b[k], a[k], f"layer {layer} {k}")
    ring = tc["blocks"][2]["k"]
    assert ring.shape[1] == 16 and P + GEN > 16            # wrapped
    assert tc["blocks"][0]["h"].dtype == torch.float32


def test_rglru_state_and_kinds():
    """The decode state's shapes and dtypes are the reference's, and a
    block kind the reference does not pair raises."""
    st = TRC.rglru_state_init(3, R, dtype=torch.bfloat16, device=CPU)
    ref = JRC.rglru_state_init(3, R, dtype=jnp.bfloat16)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == ref[k].shape
        assert str(st[k].dtype)[6:] == str(ref[k].dtype)
    cfg = dataclasses.replace(TR.get_config("recurrentgemma-9b", True),
                              pattern=(("rglru", "rwkv_cm"),))
    with pytest.raises(ValueError, match="rwkv_cm"):
        TLM.param_count(cfg)
