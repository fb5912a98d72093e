"""Port parity of the RWKV6 language model (``repro_torch.models.lm``,
``launch/serve.py``) against the JAX package's ``repro.models.lm``.

The rwkv6-3b smoke config (2 layers, d_model 64), weights drawn by the
JAX package's ``init_params`` and carried across with
``params_from_numpy``.  In float32 (the config's dtype replaced, so the
algorithm is compared and not bf16 rounding) the prefill logits, every
cache entry and four decode steps' logits agree within rtol = atol =
1e-4: both run the chunk-32 WKV, and the rest differs only in the
order of float32 sums.  The JAX side is one jitted prefill and one
jitted decode step; the decode tokens are fixed in advance, so both
packages decode the same sequence.  The port's stateless ``forward``
is held to the same prefill logits at the last position."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_3b as JCFG
from repro.models import lm as JLM
from repro.models import registry as JR
from repro_torch.configs import rwkv6_3b as TCFG
from repro_torch.launch import serve as TSERVE
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR

torch.set_num_threads(1)

B, P, GEN = 2, 40, 4         # P: one full WKV chunk of 32 and a ragged 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(jdtype, tdtype):
    jcfg = dataclasses.replace(JCFG.smoke_config(), dtype=jdtype)
    tcfg = dataclasses.replace(TCFG.smoke_config(), dtype=tdtype)
    jparams = JLM.init_params(jax.random.key(0), jcfg)
    tparams = TLM.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    tcfg, torch.device("cpu"))
    return jcfg, jparams, tcfg, tparams


def _tokens(vocab):
    rng = np.random.default_rng(5)
    return (rng.integers(0, vocab, (B, P)).astype(np.int32),
            rng.integers(0, vocab, (B, GEN)).astype(np.int32))


def _close(got: torch.Tensor, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def test_rwkv6_smoke_matches_reference_prefill_and_decode():
    jcfg, jparams, tcfg, tparams = _models(jnp.float32, torch.float32)
    prompt, steps = _tokens(jcfg.vocab)
    max_len = P + GEN
    jprefill = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t, max_len))
    jdecode = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, jcfg, c, t,
                                                           pos))
    jlogits, jcache = jprefill(jparams, jnp.asarray(prompt))
    tlogits, tcache = TR.make_prefill_step(tcfg, max_len)(
        tparams, torch.from_numpy(prompt))
    _close(tlogits, jlogits, "prefill logits", **TOL)
    tfull, _ = TLM.forward(tparams, tcfg, torch.from_numpy(prompt))
    assert tfull.shape == (B, P, jcfg.vocab)
    _close(tfull[:, -1], jlogits, "forward, last position", **TOL)

    def check_cache(step):
        jlayers = TLM.layers_from_stacked(jcache, tcfg)
        assert len(jlayers) == len(tcache["blocks"]) == tcfg.n_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache["blocks"])):
            assert sorted(jl) == sorted(tl) == ["S", "x_cm", "x_tm"]
            for name in tl:
                _close(tl[name], jl[name], f"{step}: layer {i} {name}",
                       **TOL)

    check_cache("prefill")
    serve = TR.make_serve_step(tcfg)
    for i in range(GEN):
        tok = steps[:, i:i + 1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                                  jnp.asarray(P + i, jnp.int32))
        tlogits, tcache = serve(tparams, tcache, torch.from_numpy(tok),
                                P + i)
        _close(tlogits, jlogits, f"decode step {i} logits", **TOL)
    check_cache(f"after {GEN} decode steps")


def test_rwkv6_smoke_bf16_prefill_near_reference():
    """bf16, the served dtype.  Both packages round to bf16 (unit
    roundoff 2^-8 = 0.0039), but at other places: XLA may keep a fused
    elementwise chain in float32 and round once, PyTorch rounds after
    each op.  Through two blocks of ~20 rounded ops each, the logits
    move by a few bf16 ulps of their scale; held to 5e-2 of the largest
    logit (about 12 ulps), and the argmax must agree wherever its
    margin is above twice that bound."""
    jcfg, jparams, tcfg, tparams = _models(jnp.bfloat16, torch.bfloat16)
    prompt, _ = _tokens(jcfg.vocab)
    jlogits, _ = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t, P))(
        jparams, jnp.asarray(prompt))
    tlogits, _ = TLM.prefill(tparams, tcfg, torch.from_numpy(prompt), P)
    want = np.asarray(jlogits, np.float32)
    got = tlogits.numpy()
    assert got.dtype == np.float32 and got.shape == (B, jcfg.vocab)
    assert np.isfinite(got).all()
    bound = 5e-2 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * bound
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def test_param_count_matches_reference():
    full = TCFG.config()
    assert TLM.param_count(full) == JLM.param_count(JCFG.config())
    assert TR.param_count(full)[0] == 3_072_327_680
    assert not TR.is_encdec(full)
    assert TLM.param_count(TCFG.smoke_config()) == \
        JLM.param_count(JCFG.smoke_config())


def test_unported_kinds_and_archs_raise():
    """The multi-card fields (expert-parallel dispatch, its ZeRO-3 form,
    sequence parallelism) still raise, naming the queue; every
    architecture of the reference resolves to a port config."""
    for field in ("moe_ep", "moe_ep_fsdp", "seq_parallel"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            dataclasses.replace(TCFG.smoke_config(), **{field: True})
    assert sorted(TR.ARCHS) == sorted(JR.ARCHS)
    for arch in JR.ARCHS:
        for smoke in (False, True):
            cfg = TR.get_config(arch, smoke)
            assert type(cfg).__module__.startswith("repro_torch.")
            assert cfg.name == JR.get_config(arch, smoke).name
    with pytest.raises(KeyError, match="unknown arch"):
        TR.get_config("no-such-arch")


def test_lm_entry_points_need_a_card_unless_told(monkeypatch):
    """As every entry point of the port: the card unless a device is
    named, and a raise (no silent CPU model) when there is no card."""
    jcfg = dataclasses.replace(JCFG.smoke_config(), dtype=jnp.float32)
    tcfg = dataclasses.replace(TCFG.smoke_config(), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JLM.init_params(jax.random.key(0),
                                                    jcfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TLM.params_from_numpy(tree, tcfg),
                 lambda: TLM.init_params(tcfg, torch.Generator()),
                 lambda: TLM.init_cache(tcfg, 1, 8),
                 lambda: TSERVE.init_lm("rwkv6-3b", smoke=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for p in (TLM.params_from_numpy(tree, tcfg, "cpu"),
              TLM.init_params(tcfg, torch.Generator(), "cpu"),
              TLM.init_cache(tcfg, 1, 8, "cpu")):
        leaves = [p["blocks"][0]] if "embed" not in p else \
            [p["embed"], p["blocks"][0]]
        assert all(t.device.type == "cpu" for d in leaves
                   for t in d.values() if isinstance(t, torch.Tensor))


def test_lm_block_helpers_need_a_card_unless_told(monkeypatch):
    """The per-block helpers resolve their device as the entry points do:
    called bare on a machine with no card they raise, never landing on
    the CPU; with ``device="cpu"`` they build there."""
    from repro_torch.models import recurrent as TRC
    tcfg = dataclasses.replace(TCFG.smoke_config(), dtype=torch.float32)
    kind = tcfg.kinds[0]
    D, H = tcfg.d_model, tcfg.n_heads
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "rwkv_init": lambda **kw: TRC.rwkv_init(torch.Generator(), D, H,
                                                tcfg.d_ff, **kw),
        "rwkv_state_init": lambda **kw: TRC.rwkv_state_init(1, D, H, **kw),
        "block_init": lambda **kw: TLM.block_init(torch.Generator(), tcfg,
                                                  kind, **kw),
        "block_cache_init": lambda **kw: TLM.block_cache_init(tcfg, kind, 1,
                                                              8, **kw),
        "_norm_init": lambda **kw: TLM._norm_init(tcfg, D, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        leaves = _tensors(call(device="cpu"))
        assert leaves and all(t.device.type == "cpu" for t in leaves), name


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def test_serve_lm_greedy_matches_its_own_logits():
    """The port's serving loop on the CPU: greedy tokens are the argmax
    of the logits before them, and the counts line up."""
    cfg, params = TSERVE.init_lm("rwkv6-3b", smoke=True, device="cpu")
    prompt = TSERVE.make_prompt(cfg, 2, 9, device="cpu")
    res = TSERVE.serve_lm(params, cfg, prompt, gen=3, keep_logits=True)
    assert res.tokens.shape == (2, 3) and len(res.logits) == 4
    for i in range(3):
        assert torch.equal(res.tokens[:, i], res.logits[i].argmax(-1))
    assert all(torch.isfinite(lg).all() for lg in res.logits)
    assert res.tokens_per_s > 0


def test_wkv_kernel_refuses_gradients_and_the_train_step_turns_it_off():
    """The WKV kernel has no backward: a time mix asked for it while
    gradients flow raises (on any device, so the card never falls back
    unseen), and the LM train step runs its config with the kernel off,
    so an RWKV model trains through the plain chunked WKV."""
    from repro_torch.optim.adamw import tree_leaves
    tcfg = dataclasses.replace(TCFG.smoke_config(), dtype=torch.float32,
                               n_layers=1)
    assert tcfg.use_wkv_kernel
    init_state, step = TR.make_train_step(tcfg, remat=False)
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab)[0][:, :8].astype(np.int64))
    p = state["params"]["blocks"][0]
    p = {**p, "rwkv": {**p["rwkv"],
                       "w_r": p["rwkv"]["w_r"].detach().requires_grad_()}}
    x = TLM._embed(tcfg, state["params"], tokens)
    with pytest.raises(RuntimeError, match="no backward"):
        TLM.block_apply(tcfg, tcfg.kinds[0], p, x, None, None)
    plain = dataclasses.replace(tcfg, use_wkv_kernel=False)
    y, _, _ = TLM.block_apply(plain, tcfg.kinds[0], p, x, None, None)
    assert y.requires_grad
    new, m = step(state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    assert np.isfinite(float(m["loss"]))
    assert set(m) == {"loss", "aux", "grad_norm"} and float(m["aux"]) == 0
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(new["params"])))
