"""Port parity of the mixture of experts (``repro_torch.models.layers``
``moe_*`` and the ``moe`` channel of ``repro_torch.models.lm``) against
the JAX package's ``repro.models``, at the granite-moe and kimi-k2 smoke
configs in float32.

Weights are drawn by the port and carried into the reference's layout
(``lm.params_to_stacked``); inputs come from numpy seeds.  Every
comparison holds within 1e-5 (relative and absolute): both packages
multiply the same float32 operands and differ only in the order of
float32 sums.  Each JAX reference is jitted once; torch runs on one
thread."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.models import layers as JNN
from repro.models import lm as JLM
from repro.models import registry as JR
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.launch import train as TTRAIN
from repro_torch.models import layers as TNN
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _jnp(t: torch.Tensor):
    t = t.detach()
    if t.dtype == torch.bfloat16:                 # exact through float32
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

SPEC = dict(n_experts=4, top_k=2, d_model=16, d_ff=8, shared_expert=True)
_JMOE = jax.jit(JNN.moe_apply, static_argnums=(1, 3))


def _reference_keep(eids: np.ndarray, cap: int, E: int) -> np.ndarray:
    """Which (token, choice) assignments fit: per expert, its first
    ``cap`` assignments in token order (an independent count)."""
    T, k = eids.shape
    keep = np.zeros((T, k), bool)
    seen = np.zeros(E, int)
    for t in range(T):
        for j in range(k):
            e = eids[t, j]
            keep[t, j] = seen[e] < cap
            seen[e] += 1
    return keep


@pytest.mark.parametrize("case", ["drop", "no_drop", "ties"])
def test_moe_apply_matches_reference(case):
    """y and aux of ``moe_apply`` with overflow dropped (capacity factor
    1.0, so some experts overflow), with ``no_drop``, and with a zero
    router (every probability tied: top-k takes the lowest expert ids,
    as ``jax.lax.top_k`` does); and which assignments were dropped."""
    spec = dict(SPEC, capacity_factor=1.0 if case == "drop" else 1.25)
    js, ts = JNN.MoESpec(**spec), TNN.MoESpec(**spec)
    tp = TNN.moe_init(torch.Generator().manual_seed(1), ts, torch.float32,
                      CPU)
    if case == "ties":
        tp["router"]["w"].zero_()
    jp = jax.tree.map(_jnp, tp)
    x = np.random.default_rng(2).normal(size=(2, 9, 16)).astype(np.float32)
    no_drop = case == "no_drop"
    want_y, want_aux = _JMOE(jp, js, jnp.asarray(x), no_drop)
    got_y, got_aux = TNN.moe_apply(tp, ts, torch.from_numpy(x), no_drop)
    _close(got_y, want_y, f"{case} y")
    _close(got_aux, want_aux, f"{case} aux")

    xt = jnp.asarray(x.reshape(18, 16))
    probs = jax.nn.softmax(xt @ jp["router"]["w"], axis=-1)
    _, jeids = jax.lax.top_k(probs, ts.top_k)
    _, eids, _ = TNN.moe_route(tp, ts, torch.from_numpy(x.reshape(18, 16)))
    assert np.array_equal(eids.numpy(), np.asarray(jeids))
    cap = TNN.moe_capacity(ts, 18, no_drop)
    _, _, _, keep = TNN.moe_dispatch(ts, eids, cap)
    want_keep = _reference_keep(np.asarray(jeids), cap, ts.n_experts)
    assert np.array_equal(keep.numpy(), want_keep)
    assert (not want_keep.all()) == (case != "no_drop")
    if case == "ties":
        assert (eids.numpy() == [0, 1]).all()


def test_moe_capacity_is_the_references():
    """Python's round of T k / E * capacity_factor, at least 1; T when
    nothing may drop."""
    s = TNN.MoESpec(n_experts=32, top_k=8, d_model=1, d_ff=1)
    assert TNN.moe_capacity(s, 2048) == 640        # granite's prefill
    assert TNN.moe_capacity(s, 4, no_drop=True) == 4
    s = TNN.MoESpec(n_experts=384, top_k=8, d_model=1, d_ff=1)
    assert TNN.moe_capacity(s, 256) == round(256 * 8 / 384 * 1.25) == 7
    assert TNN.moe_capacity(dataclasses.replace(s, capacity_factor=0.01),
                            3) == 1


# ---------------------------------------------------------------------------
# the granite and kimi smoke models
# ---------------------------------------------------------------------------

B, P, GEN = 2, 12, 6


def _models(arch, **over):
    jcfg = dataclasses.replace(JR.get_config(arch, smoke=True),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(TR.get_config(arch, smoke=True),
                               dtype=torch.float32, **over)
    tparams = TLM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = jax.tree.map(_jnp, TLM.params_to_stacked(tparams, tcfg))
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_moe_model_matches_reference(arch):
    """At capacity factor 16 (nothing drops, the reference's own test
    setting) the port's forward and aux term, its prefill's logits and
    each decode step's against the reference's forward at the same
    positions; kimi adds a dense prefix layer and the shared expert.
    (The train step below holds a forward that drops.)"""
    toks = np.random.default_rng(3).integers(0, 128, (B, P + GEN)
                                             ).astype(np.int32)
    t = torch.from_numpy(toks)
    jcfg, jparams, tcfg, tparams = _models(arch, moe_capacity_factor=16.0)
    want, want_aux = jax.jit(lambda p, x: JLM.forward(p, jcfg, x))(
        jparams, jnp.asarray(toks))
    got, got_aux = TLM.forward(tparams, tcfg, t)
    _close(got, want, f"{arch} forward")
    _close(got_aux, want_aux, f"{arch} aux")
    assert float(got_aux) > 0
    want = np.asarray(want)
    logits, cache = TR.make_prefill_step(tcfg, P + GEN)(tparams, t[:, :P])
    _close(logits, want[:, P - 1], f"{arch} prefill")
    serve = TR.make_serve_step(tcfg)
    for i in range(GEN):
        logits, cache = serve(tparams, cache, t[:, P + i:P + i + 1], P + i)
        _close(logits, want[:, P + i], f"{arch} decode {i}")
    if arch.startswith("kimi"):
        assert tcfg.kinds[0] == ("attn", "dense")
        assert "shared" in tparams["blocks"][1]["moe"]


# An element whose gradient is within float32 noise of 0 is moved by
# Adam by lr * g / (|g| + eps): a noise-driven fraction of lr.  As in
# tests/test_torch_lm_train.py, such elements are held to 2 lr and must
# stay under 1% of all.
NOISE_GRAD = 1e-7
LR = 3e-4


def _pairs(got, want, path=""):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in sorted(got):
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, got.detach(), want


def test_moe_train_step_with_aux_matches_reference():
    """One registry train step of granite-moe smoke (capacity 1.25, so
    the forward drops): loss, aux, grad norm, AdamW's first moment and
    the new parameters against the reference's; and ``lm_loss`` under
    ``remat`` against without."""
    jcfg, jparams, tcfg, tparams = _models("granite-moe-1b-a400m")
    _, jstep = JR.make_train_step(jcfg, remat=False)
    _, tstep = TR.make_train_step(tcfg, remat=False)
    toks = np.random.default_rng(4).integers(0, 128, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    js = {"params": jparams, "opt": JR._optimizer(jcfg)[0](jparams)}
    js, jm = jax.jit(jstep)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = {"params": tparams, "opt": TR._optimizer(tcfg)[0](tparams)}
    ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    assert float(tm["aux"]) > 0
    want = TLM.train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg,
                                      CPU)
    mu = dict((p, w) for p, _, w in _pairs(ts["opt"].mu, want["opt"].mu))
    n_noisy = n_all = 0
    for path, g, w in _pairs(ts["opt"].mu, want["opt"].mu):
        _close(g, w, f"mu {path}")
    for path, g, w in _pairs(ts["params"], want["params"]):
        noisy = (mu[path].abs() / 0.1 < NOISE_GRAD) & (mu[path] != 0)
        bound = torch.where(noisy, 2 * LR, 0.0) + 1e-5 + 1e-5 * w.abs()
        assert bool(((g - w).abs() <= bound).all()), path
        n_noisy += int(noisy.sum())
        n_all += w.numel()
    assert n_noisy <= 1e-2 * n_all, (n_noisy, n_all)
    # under remat (each period recomputed in the backward pass) the aux
    # term flows out of the checkpointed periods: the same loss, aux and
    # gradients
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [TLM.value_and_grad(lambda p: TLM.lm_loss(
        p, tcfg, tb["tokens"], tb["labels"], remat=remat), tparams)
        for remat in (True, False)]
    for k in ("loss", "aux"):
        _close(got[0][0][k], got[1][0][k].numpy(), f"remat {k}")
    for path, g, w in _pairs(got[0][1], got[1][1]):
        _close(g, w.numpy(), f"remat grad {path}")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_lm_train_state_checkpoint_read_by_reference(arch, tmp_path):
    """The checkpoint that ``launch.train`` writes for a dense, an MoE
    and an RG-LRU LM (bf16 weights, float32 router, Lambda and AdamW
    moments after one step) restores through the reference's
    ``restore_checkpoint`` into its own trainer's tree
    ``{"state", "step"}``, leaf for leaf, bit for bit; and the port's
    launcher resumes from it to the same state."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "1", "--batch",
            "2", "--seq", "16", "--ckpt-every", "1", "--ckpt-dir",
            str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = TTRAIN.main(argv)
        resumed = TTRAIN.main(argv)
    tcfg = TR.get_config(arch, smoke=True)
    template = {"state": jax.eval_shape(
        JR.make_train_step(JR.get_config(arch, smoke=True))[0],
        jax.random.key(0)), "step": 0}
    got, step = JCK.restore_checkpoint(str(tmp_path), template)
    assert step == 1 and int(got["step"]) == 1
    want = TCK.tree_flatten(TLM.train_state_to_stacked(trainer.state, tcfg))
    leaves = jax.tree.leaves(got["state"])
    spec = jax.tree.leaves(template["state"])
    assert len(leaves) == len(want) == len(spec)
    for a, b, s in zip(leaves, want, spec):
        assert a.shape == s.shape and a.dtype == s.dtype
        assert a.tobytes() == np.asarray(
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        ).tobytes()
    assert resumed.step == 1 and resumed.history == []
    assert all(torch.equal(a, b) for a, b in zip(
        TCK.tree_flatten(resumed.state), TCK.tree_flatten(trainer.state)))


def test_param_count_matches_reference_for_all_ten_archs():
    """Total and active counts of every registered arch, full and smoke,
    equal the reference's (the MoE configs' active count is smaller)."""
    assert sorted(TR.ARCHS) == sorted(JR.ARCHS)
    for arch in TR.ARCHS:
        for smoke in (False, True):
            assert TR.param_count(TR.get_config(arch, smoke)) == \
                JR.param_count(JR.get_config(arch, smoke)), (arch, smoke)
    full = {a: TR.param_count(TR.get_config(a)) for a in TR.ARCHS}
    assert full["granite-moe-1b-a400m"] == (1_334_578_176, 428_608_512)
    assert full["kimi-k2-1t-a32b"][0] == 1_027_290_693_632
    assert full["recurrentgemma-9b"][0] == 7_482_638_336
    assert full["whisper-tiny"][0] == 37_179_264
