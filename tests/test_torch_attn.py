"""Port parity of the attention LM family (``repro_torch.models.layers``
and the attention half of ``repro_torch.models.lm``) against the JAX
package's ``repro.models``.

Model weights are drawn by the port and carried into the reference's
stacked layout (``layers_to_stacked``; ``params_from_numpy`` carries
them back leaf for leaf); layer weights and inputs come from numpy
seeds.  In float32 every
comparison holds within 1e-5 (relative and absolute): both packages
multiply the same float32 (or exactly widened bf16) operands and differ
only in the order of float32 sums.  In bf16 the packages round at other
places (XLA may fuse an elementwise chain and round once, PyTorch
rounds after each op), so bf16 results are held to a bound in bf16
ulps of the output's scale, stated at each test.  Each JAX reference is
jitted once per module; torch runs on one thread."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JNN
from repro.models import lm as JLM
from repro.models import registry as JR
from repro_torch.models import layers as TNN
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR
from repro_torch.optim.adamw import tree_map

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return TNN.from_numpy(np.asarray(a), CPU)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


def _rng_array(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# ---------------------------------------------------------------------------
# rope and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_matches_reference(batched_positions):
    x = _rng_array(0, (2, 6, 3, 8))
    if batched_positions:
        pos = np.array([[0, 1, 2, 3, 4, 5], [7, 9, 11, 13, 15, 17]],
                       np.int32)
    else:
        pos = np.arange(6, dtype=np.int32) + 1000
    want = JNN.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = TNN.rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    _close(got, want, "rope")


_JATTN = jax.jit(JNN.attention,
                 static_argnames=("causal", "window", "q_chunk"))

# name: (Sq, Skv, H, KH, q_positions, kv_positions, window, q_chunk)
ATTN_CASES = {
    "gqa_causal": (7, 7, 4, 2, np.arange(7), np.arange(7), None, 512),
    "window": (9, 9, 4, 1, np.arange(9), np.arange(9), 3, 512),
    "chunked_padded": (10, 10, 4, 2, np.arange(10), np.arange(10), 4, 4),
    # one decode query against a ring of 4 slots at position 5: slots
    # hold positions 4, 5, 2, 3; and at position 2, where slot 3 is
    # not written yet (-1, masked)
    "ring_decode": (1, 4, 4, 2, np.array([5]), np.array([4, 5, 2, 3]),
                    None, 512),
    "ring_unwritten": (1, 4, 4, 2, np.array([2]), np.array([0, 1, 2, -1]),
                       None, 512),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference(case):
    Sq, Skv, H, KH, qpos, kvpos, window, q_chunk = ATTN_CASES[case]
    hd = 8
    q = _rng_array(1, (2, Sq, H, hd))
    k = _rng_array(2, (2, Skv, KH, hd))
    v = _rng_array(3, (2, Skv, KH, hd))
    qpos, kvpos = qpos.astype(np.int32), kvpos.astype(np.int32)
    want = _JATTN(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(qpos), jnp.asarray(kvpos), causal=True,
                  window=window, q_chunk=q_chunk)
    got = TNN.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(qpos),
                        torch.from_numpy(kvpos), causal=True, window=window,
                        q_chunk=q_chunk)
    assert got.shape == want.shape
    _close(got, want, case)


def test_attention_bf16_scores_are_float32_products():
    """bf16 operands, as served: both packages form float32 scores and
    values from the bf16 operands and round the output to bf16 once, so
    they agree within one bf16 ulp (2^-8 relative) of the output's
    scale; a bf16-rounded score would part them by several."""
    q, k, v = (_rng_array(s, (2, 16, 4, 32)) for s in (4, 5, 6))
    pos = np.arange(16, dtype=np.int32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(_JATTN(*jb, jnp.asarray(pos), jnp.asarray(pos),
                             causal=True, window=None, q_chunk=512),
                      np.float32)
    got = TNN.attention(*(_t(np.asarray(a)) for a in jb),
                        torch.from_numpy(pos), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# attn_apply and the FFN
# ---------------------------------------------------------------------------

SPEC = JNN.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                    qkv_bias=True, rope_theta=10000.0)


def test_attn_apply_matches_reference_forward_and_decode():
    """``attn_apply`` (the mixer of the LM's attention blocks) with QKV
    biases, weights drawn by the port: full sequence, then one decode
    token against a cache, which the port writes in place and returns
    (the reference returns a new one)."""
    tspec = TNN.AttnSpec(**dataclasses.asdict(SPEC))
    tp = TNN.attn_init(torch.Generator().manual_seed(1), tspec,
                       torch.float32, CPU)
    for i, b in enumerate(("bq", "bk", "bv")):     # nonzero biases
        tp[b] = torch.from_numpy(_rng_array(i, tuple(tp[b].shape)) * 0.1)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = _rng_array(7, (2, 6, 32))
    pos = np.arange(6, dtype=np.int32)
    jc = {n: jnp.asarray(_rng_array(10 + i, (2, 8, 2, 8)))
          for i, n in enumerate(("k", "v"))}
    tc = {n: _t(a) for n, a in jc.items()}
    x1 = x[:, :1]

    @jax.jit
    def reference(p, x, c, x1):
        full, _ = JNN.attn_apply(p, SPEC, x, jnp.arange(6))
        one, cache = JNN.attn_apply(p, SPEC, x1, jnp.array([3]), c, 3)
        return full, one, cache

    want, want1, wc = reference(jp, jnp.asarray(x), jc, jnp.asarray(x1))
    got, _ = TNN.attn_apply(tp, tspec, torch.from_numpy(x),
                            torch.from_numpy(pos))
    _close(got, want, "attn_apply forward")
    got, gc = TNN.attn_apply(tp, tspec, torch.from_numpy(x1),
                             torch.tensor([3]), tc)
    _close(got, want1, "attn_apply decode")
    assert gc is tc
    for n in ("k", "v"):
        _close(gc[n], wc[n], f"decode cache {n}")


@pytest.mark.parametrize("kind,sparse", [("swiglu", False), ("gelu", False),
                                         ("relu2", False), ("swiglu", True)])
def test_ffn_apply_matches_reference(kind, sparse):
    """The FFN in each form, weights drawn by the port (``sparse``: the
    theta/sign form at initial fan-in 8)."""
    tp = TNN.ffn_init(torch.Generator().manual_seed(2), 32, 64, kind,
                      torch.float32, sparse=sparse,
                      initial_fan_in=8 if sparse else None, device=CPU)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = _rng_array(8, (2, 5, 32))
    want = jax.jit(JNN.ffn_apply, static_argnums=1)(jp, kind,
                                                    jnp.asarray(x))
    got = TNN.ffn_apply(tp, kind, torch.from_numpy(x))
    _close(got, want, f"ffn {kind} sparse={sparse}")
    if sparse:
        assert sorted(tp) == ["w_gate_sign", "w_gate_theta", "w_in_sign",
                              "w_in_theta", "w_out"]
        assert int((tp["w_in_theta"] > 0).sum(0).max()) == 8
        assert set(tp["w_in_sign"].unique().tolist()) == {-1.0, 1.0}


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

B, P, GEN = 2, 12, 8      # gemma3 smoke's window is 16: decode wraps it


def _jnp(t: torch.Tensor):
    t = t.detach()
    if t.dtype == torch.bfloat16:                 # exact through float32
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def reference_params(tparams, tcfg):
    """The port's parameters as the reference's tree (scan stacks
    restacked): both packages then run the same weights."""
    tree = {k: jax.tree.map(_jnp, tparams[k])
            for k in ("embed", "final_norm", "head") if k in tparams}
    blocks = [jax.tree.map(_jnp, b) for b in tparams["blocks"]]
    tree.update(TLM.layers_to_stacked(blocks, tcfg, jnp.stack))
    return tree


def _models(arch, jdtype=jnp.float32, tdtype=torch.float32, **over):
    """Weights drawn by the port on the CPU and carried into the
    reference's layout; ``params_from_numpy`` of that tree gives the
    port's back, leaf for leaf."""
    jcfg = dataclasses.replace(JR.get_config(arch, smoke=True), dtype=jdtype,
                               **over)
    tcfg = dataclasses.replace(TR.get_config(arch, smoke=True), dtype=tdtype,
                               **over)
    tparams = TLM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = reference_params(tparams, tcfg)
    back = TLM.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), tparams, back)
    assert same and all(same)
    return jcfg, jparams, tcfg, tparams


def _reference_forward(jcfg, jparams, toks):
    return np.asarray(jax.jit(lambda p, t: JLM.forward(p, jcfg, t)[0])(
        jparams, jnp.asarray(toks)))


def _run_reference(jcfg, jparams, toks):
    """Prefill of the first P tokens, then GEN decode steps fed the
    rest: logits and caches (after the prefill and after the steps)."""
    ml = P + GEN
    logits, cache = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t, ml))(
        jparams, jnp.asarray(toks[:, :P]))
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, jcfg, c, t, pos))
    out = [logits]
    caches = [jax.tree.map(np.asarray, cache)]
    for i in range(GEN):
        logits, cache = step(jparams, cache,
                             jnp.asarray(toks[:, P + i:P + i + 1]),
                             jnp.asarray(P + i, jnp.int32))
        out.append(logits)
    caches.append(jax.tree.map(np.asarray, cache))
    return [np.asarray(o) for o in out], caches


def _run_port(tcfg, tparams, toks):
    t = torch.from_numpy(toks)
    fwd = TLM.forward(tparams, tcfg, t)[0].detach()
    logits, cache = TR.make_prefill_step(tcfg, P + GEN)(tparams, t[:, :P])
    caches = [[{k: v.clone() for k, v in b.items()} for b in cache["blocks"]]]
    out = [logits]
    serve = TR.make_serve_step(tcfg)
    for i in range(GEN):
        logits, cache = serve(tparams, cache, t[:, P + i:P + i + 1], P + i)
        out.append(logits)
    caches.append(cache["blocks"])
    return fwd, out, caches


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3-mini-3.8b",
                                  "gemma3-12b"])
def test_model_matches_reference_forward_prefill_decode(arch):
    """The port's forward, its prefill's logits and each decode step's
    against the reference's forward at the same positions (a causal LM:
    the same numbers); for gemma3, whose local layers keep a ring of 16
    slots that the decode wraps, against the reference's own prefill and
    decode steps instead, logits and every cache entry."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (B, P + GEN)).astype(np.int32)
    tf, tout, tcaches = _run_port(tcfg, tparams, toks)
    if arch != "gemma3-12b":
        jf = _reference_forward(jcfg, jparams, toks)
        _close(tf, jf, f"{arch} forward")
        for i, g in enumerate(tout):
            _close(g, jf[:, P - 1 + i],
                   f"{arch} {'prefill' if i == 0 else f'decode {i}'}")
        return
    jout, jcaches = _run_reference(jcfg, jparams, toks)
    for i, (g, w) in enumerate(zip(tout, jout)):
        _close(g, w, f"{arch} step {i} vs the reference's step")
        _close(tf[:, P - 1 + i], w, f"{arch} forward, position {P - 1 + i}")
    for when, jc, tc in zip(("prefill", "decode"), jcaches, tcaches):
        jl = TLM.layers_from_stacked(jc, tcfg)
        for layer, (a, b) in enumerate(zip(jl, tc)):
            assert sorted(a) == sorted(b) == ["k", "v"]
            for n in ("k", "v"):
                _close(b[n], a[n], f"{arch} {when} layer {layer} {n}")
    kinds = [k for k, _ in tcfg.kinds]
    assert kinds.count("local") == 5 and tcfg.window == 16
    ring = tcaches[1][kinds.index("local")]["k"]
    assert ring.shape[1] == 16 and P + GEN > 16      # wrapped


def test_bf16_model_near_reference():
    """qwen2.5-3b smoke in bf16, the served dtype: the port's prefill and
    three decode steps against the reference's forward at the same
    positions.  Through two blocks of some 30 rounded ops each the
    logits move by a few bf16 ulps of their scale: held to 5e-2 of the
    largest logit (about 12 ulps, as the RWKV bf16 test), and the argmax
    must agree wherever its margin is above twice that bound."""
    jcfg, jparams, tcfg, tparams = _models("qwen2.5-3b", jnp.bfloat16,
                                           torch.bfloat16)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, P + 3)).astype(np.int32)
    jf = _reference_forward(jcfg, jparams, toks).astype(np.float32)
    t = torch.from_numpy(toks)
    tl, tc = TLM.prefill(tparams, tcfg, t[:, :P], P + 3)
    pairs = [(tl, jf[:, P - 1])]
    for i in range(3):
        tl, tc = TLM.decode_step(tparams, tcfg, tc, t[:, P + i:P + i + 1],
                                 P + i)
        pairs.append((tl, jf[:, P + i]))
    for got, want in pairs:
        got = got.numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        bound = 5e-2 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * bound
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def test_chameleon_stub_embeddings_match_reference():
    """chameleon's stub frontend: precomputed (B, S, D) embeddings go
    straight into the backbone."""
    jcfg, jparams, tcfg, tparams = _models("chameleon-34b")
    emb = _rng_array(9, (B, 7, jcfg.d_model)) * 0.1
    want, _ = jax.jit(lambda p, e: JLM.forward(p, jcfg, e))(
        jparams, jnp.asarray(emb))
    got, _ = TLM.forward(tparams, tcfg, torch.from_numpy(emb))
    assert got.shape == (B, 7, jcfg.vocab)
    _close(got, want, "chameleon (B, S, D) forward")


def test_int8_kv_cache_matches_reference():
    """``kv_cache_dtype="int8"``: the codes and float16 scales the
    prefill and each decode step store equal the reference's exactly,
    the logits agree within 1e-5, and the int8 cache stays within 2% of
    the logits' scale of the bf16-dtype cache's (here float32)."""
    jcfg, jparams, tcfg, tparams = _models("qwen2.5-3b",
                                           kv_cache_dtype="int8")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, P + 3)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t, P + 3))(
        jparams, jnp.asarray(toks[:, :P]))
    tl, tc = TLM.prefill(tparams, tcfg, torch.from_numpy(toks[:, :P]), P + 3)
    full = dataclasses.replace(tcfg, kv_cache_dtype="bf16")
    fl, fc = TLM.prefill(tparams, full, torch.from_numpy(toks[:, :P]), P + 3)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, jcfg, c, t, pos))
    for i in range(3):
        _close(tl, jl, f"int8 logits {i}")
        assert np.abs(tl.numpy() - fl.numpy()).max() <= \
            0.02 * np.abs(fl.numpy()).max()
        tok = toks[:, P + i:P + i + 1]
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.int32(P + i))
        tl, tc = TLM.decode_step(tparams, tcfg, tc, torch.from_numpy(tok),
                                 P + i)
        fl, fc = TLM.decode_step(tparams, full, fc, torch.from_numpy(tok),
                                 P + i)
    for a, b in zip(TLM.layers_from_stacked(jax.tree.map(np.asarray, jc),
                                            tcfg), tc["blocks"]):
        assert b["k"].dtype == torch.int8 and b["k_s"].dtype == torch.float16
        for n in ("k", "v", "k_s", "v_s"):
            assert np.array_equal(b[n].numpy(), np.asarray(a[n])), n


def test_param_count_matches_reference_for_every_ported_arch():
    for arch in TR.ARCHS:
        for smoke in (False, True):
            assert TR.param_count(TR.get_config(arch, smoke)) == \
                JR.param_count(JR.get_config(arch, smoke)), (arch, smoke)
    assert TR.param_count(TR.get_config("qwen2.5-3b"))[0] == 3_085_697_024
