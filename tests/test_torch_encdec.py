"""Port parity of the encoder-decoder (``repro_torch.models.encdec``,
cross-attention in ``models.layers.attn_apply``, the registry's encdec
steps and ``launch/train.py``'s encdec batches) against the JAX
package's, at the whisper-tiny smoke config in float32; and the
reference launcher's whisper fault, pinned on both sides.

Weights are drawn by the port and carried across as the same tree.
Every comparison holds within 1e-5 (relative and absolute): both
packages multiply the same float32 operands and differ only in the
order of float32 sums.  Each JAX reference is jitted once; torch runs on
one thread."""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.launch import train as JTRAIN
from repro.models import encdec as JED
from repro.models import registry as JR
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.models import encdec as TED
from repro_torch.models import registry as TR

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
ARCH = "whisper-tiny"


def _jnp(t: torch.Tensor):
    t = t.detach()
    if t.dtype == torch.bfloat16:                 # exact through float32
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JR.get_config(ARCH, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TR.get_config(ARCH, smoke=True),
                               dtype=torch.float32)
    tparams = TED.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = jax.tree.map(_jnp, tparams)
    back = TED.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                 CPU)
    assert all(torch.equal(a, b) for a, b in
               zip(TCK.tree_flatten(tparams), TCK.tree_flatten(back)))
    return jcfg, jparams, tcfg, tparams


B, S_SRC, S_TGT = 2, 24, 40          # 40 > max_target 32: positions wrap


def test_encode_and_decode_train_match_reference(model):
    """``encode`` of (B, 24, D) frames, then the teacher-forced decoder
    over 40 tokens, more than the 32 rows of ``pos_dec`` (positions
    wrap, as in the reference)."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(B, S_SRC, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, S_TGT)).astype(np.int32)

    @jax.jit
    def reference(p, f, t):
        enc = JED.encode(p, jcfg, f)
        return enc, JED.decode_train(p, jcfg, enc, t)

    jenc, jlog = reference(jparams, jnp.asarray(frames), jnp.asarray(toks))
    tenc = TED.encode(tparams, tcfg, torch.from_numpy(frames))
    _close(tenc, jenc, "encode")
    tlog = TED.decode_train(tparams, tcfg, tenc, torch.from_numpy(toks))
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, "decode_train")


def test_prefill_and_decode_steps_match_reference(model):
    """The registry's prefill (encoder + ``init_dec_cache``) and serve
    steps against the reference's, step by step: logits, the self
    caches and the cross K/V; and each step against the teacher-forced
    decoder at its position."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(B, S_SRC, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, 10)).astype(np.int32)
    jc = jax.jit(JR.make_prefill_step(jcfg, 0))(jparams, jnp.asarray(frames))
    tc = TR.make_prefill_step(tcfg, 0)(tparams, torch.from_numpy(frames))
    jstep = jax.jit(JR.make_serve_step(jcfg))
    tstep = TR.make_serve_step(tcfg)
    full = TED.decode_train(tparams, tcfg,
                            TED.encode(tparams, tcfg,
                                       torch.from_numpy(frames)),
                            torch.from_numpy(toks))
    for i in range(toks.shape[1]):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]),
                       jnp.int32(i))
        tl, tc = tstep(tparams, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(tl, jl, f"decode {i}")
        _close(tl, full[:, i].numpy(), f"decode {i} vs decode_train")
    for layer, (a, b) in enumerate(zip(jc["layers"], tc["layers"])):
        assert b["self"]["k"].shape[1] == jcfg.max_target
        for n in ("k", "v"):
            _close(b["self"][n], a["self"][n], f"layer {layer} self {n}")
        for n in ("cross_k", "cross_v"):
            _close(b[n], a[n], f"layer {layer} {n}")


def _train_batch(seed, cfg):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    return {"frames": rng.normal(size=(3, 16, cfg.d_model)
                                 ).astype(np.float32),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


# An element whose gradient is within float32 noise of 0 is moved by
# Adam by lr * g / (|g| + eps): a noise-driven fraction of lr.  As in
# tests/test_torch_lm_train.py, such elements are held to 2 lr and must
# stay under 1% of all.  Most of them here are the key biases, whose
# gradient is 0 in exact arithmetic (a constant added to every key
# shifts each query's scores alike, which the softmax ignores).
NOISE_GRAD = 1e-7
LR = 3e-4


def test_encdec_loss_and_train_step_match_reference(model):
    """``encdec_loss``, and one registry train step (clip 1.0, AdamW 3e-4,
    weight decay 0.1): loss, grad norm, AdamW's moments within 1e-5, and
    the new parameters within 1e-5 but where ``NOISE_GRAD`` applies."""
    jcfg, jparams, tcfg, tparams = model
    batch = _train_batch(3, jcfg)
    _, jstep = JR.make_train_step(jcfg)
    _, tstep = TR.make_train_step(tcfg)
    js = {"params": jparams, "opt": JR._optimizer(jcfg)[0](jparams)}
    js, jm = jax.jit(jstep)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = {"params": tparams, "opt": TR._optimizer(tcfg)[0](tparams)}
    ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    for part in ("mu", "nu"):
        got = TCK.tree_flatten(getattr(ts["opt"], part))
        want = jax.tree.leaves(getattr(js["opt"], part))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, part)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(js["params"])]
    n_noisy = n_all = 0
    for path, g, w, m in zip(paths, TCK.tree_flatten(ts["params"]),
                             jax.tree.leaves(js["params"]),
                             jax.tree.leaves(js["opt"].mu)):
        w, m = torch.from_numpy(np.array(w)), torch.from_numpy(np.array(m))
        noisy = (m.abs() / 0.1 < NOISE_GRAD) & (m != 0)
        bound = torch.where(noisy, 2 * LR, 0.0) + 1e-5 + 1e-5 * w.abs()
        assert bool(((g - w).abs() <= bound).all()), path
        n_noisy += int(noisy.sum())
        n_all += w.numel()
    assert n_noisy <= 1e-2 * n_all, (n_noisy, n_all)


def test_encdec_checkpoint_read_by_reference(model, tmp_path):
    """A bf16 whisper train state written by the port's
    ``save_checkpoint`` restores through the reference's
    ``restore_checkpoint`` into its own train state's structure, leaf
    for leaf, bit for bit."""
    cfg = TR.get_config(ARCH, smoke=True)
    init, _ = TR.make_train_step(cfg)
    state = init(torch.Generator().manual_seed(4), CPU)
    path = TCK.save_checkpoint(str(tmp_path), 3, state, max_shard_bytes=4096)
    template = jax.eval_shape(JR.make_train_step(JR.get_config(
        ARCH, smoke=True))[0], jax.random.key(0))
    got, step = JCK.restore_checkpoint(str(tmp_path), template)
    assert step == 3 and path.endswith("step_00000003")
    leaves, spec = jax.tree.leaves(got), jax.tree.leaves(template)
    want = TCK.tree_flatten(state)
    assert len(leaves) == len(want) == len(spec)
    assert any(b.dtype == torch.bfloat16 for b in want)
    for a, b, s in zip(leaves, want, spec):
        assert a.shape == s.shape and a.dtype == s.dtype
        assert a.tobytes() == np.asarray(
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        ).tobytes()


def test_reference_whisper_launcher_fault_and_port_error(tmp_path):
    """A fault of the reference, pinned: ``repro.launch.train --arch
    whisper-tiny`` at its defaults (``--smoke --seq 64``) draws 64 frames
    for a smoke config whose learned table holds ``max_source`` = 32
    rows, and ``encode`` fails on the broadcast.  The port raises
    ``ValueError`` naming ``max_source``, from ``encode`` and from its
    launcher at the same defaults."""
    jcfg = JR.get_config(ARCH, smoke=True)
    batch = next(JTRAIN.batches_for(jcfg, 8, 64))
    params = jax.eval_shape(lambda k: JED.init_params(k, jcfg),
                            jax.random.key(0))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax.eval_shape(lambda p, f: JED.encode(p, jcfg, f), params,
                       batch["frames"])
    tcfg = TR.get_config(ARCH, smoke=True)
    frames = next(TTRAIN.batches_for(tcfg, 8, 64, device=CPU))["frames"]
    assert tuple(frames.shape) == tuple(batch["frames"].shape)
    tparams = TED.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="max_source = 32"):
        TED.encode(tparams, tcfg, frames)
    with pytest.raises(ValueError, match="max_source"):
        TTRAIN.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


def test_encdec_batches_are_the_references():
    """``batches_for``'s encdec branch: the reference's numpy draws, in
    its order and dtypes (frames bf16, tokens and labels int32)."""
    cfg = TR.get_config(ARCH, smoke=True)
    jb = JTRAIN.batches_for(JR.get_config(ARCH, smoke=True), 3, 20, seed=7)
    tb = TTRAIN.batches_for(cfg, 3, 20, seed=7, device=CPU)
    for _ in range(2):
        j, t = next(jb), next(tb)
        assert t["frames"].dtype == torch.bfloat16
        assert np.array_equal(t["frames"].float().numpy(),
                              np.asarray(j["frames"], np.float32))
        for k in ("tokens", "labels"):
            assert t[k].dtype == torch.int32
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("arch,argv", [
    ("granite-moe-1b-a400m", []),
    ("recurrentgemma-9b", []),
    (ARCH, ["--seq", "32"]),
])
def test_launch_train_each_new_family(arch, argv, tmp_path):
    """``launch.train`` at the reference's smoke configs, two steps on
    the CPU: a finite loss, a checkpoint written, and for the MoE model
    its aux term printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = TTRAIN.main(["--arch", arch, "--device", "cpu",
                               "--steps", "2", "--batch", "2",
                               "--ckpt-every", "2", "--log-every", "1",
                               "--ckpt-dir", str(tmp_path)] + argv)
    out = buf.getvalue()
    assert trainer.step == 2 and trainer.recoveries == 0
    assert np.isfinite(trainer.history[-1]["loss"])
    assert trainer.manager.steps() == [2]
    assert (" aux=" in out) == arch.startswith("granite"), out


def test_serve_whisper_exits_with_the_references_message():
    with pytest.raises(SystemExit, match="use the encdec example"):
        TSERVE.main(["--arch", ARCH, "--device", "cpu"])
