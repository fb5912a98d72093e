"""Port parity of LM training (``repro_torch.models.lm`` loss and train
step, ``optim/schedules``, ``data/tokens``, ``checkpoint``,
``runtime``) against the JAX package, and the training examples run
in-process at small arguments.

Parity runs on the qwen2.5-3b smoke config in float32, its weights drawn
by the port, carried into the reference's layout and back with
``train_state_from_numpy``;
the sparse-control draws fed to the port are the reference's own
``jax.random`` draws, made in this process from the reference's salted
``hash()`` of each leaf's path.  The optimizer is the registry's AdamW
(lr 3e-4, weight decay 0.1): Adam's first step moves an element by
lr * g / (|g| + eps), so an element whose gradient is within float32
noise of 0 moves by a noise-driven fraction of lr, and such elements
are held to what Adam can move them (``NOISE_GRAD`` below); every other
element agrees within 1e-5.  Each JAX
reference is jitted once per module; torch runs on one thread."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import zlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.data import tokens as JTOK
from repro.models import lm as JLM
from repro.models import registry as JR
from repro.optim import schedules as JSCH
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.data import tokens as TTOK
from repro_torch.models import lm as TLM
from repro_torch.models import registry as TR
from repro_torch.optim import schedules as TSCH
from repro_torch.optim.adamw import (adamw, apply_updates, tree_leaves,
                                     tree_map)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
SPARSE = dict(sparse_ffn=True, sparse_fan_in=8, sparse_phase_T=4)


def _cfgs(**over):
    jcfg = dataclasses.replace(JR.get_config("qwen2.5-3b", smoke=True),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(TR.get_config("qwen2.5-3b", smoke=True),
                               dtype=torch.float32, **over)
    return jcfg, tcfg


def _batch(seed, B=4, S=8, vocab=128):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _assert_tree_close(got, want, what):
    """Leaf by leaf, matched by key."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _assert_tree_close(got[k], want[k], f"{what}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_close(a, b, f"{what}/{i}")
    else:
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   err_msg=what, **TOL)


def reference_draws(jparams, step, tcfg):
    """The reference's ``apply_sparse_control`` draws at ``step``, in
    this process, keyed as the port's ``apply_sparse_control`` takes
    them: {(layer, name): (normal, uniform)}."""
    by_path = {}

    def walk(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name.endswith("_theta"):
            p = "/".join(str(x) for x in path)
            h = jnp.uint32(abs(hash(p)) % (2 ** 31))      # as lm.py:655
            key = jax.random.fold_in(jax.random.key(h), step)
            keys = jax.random.split(key, leaf.shape[0]) if leaf.ndim == 3 \
                else [key]
            by_path[p] = []
            for k in keys:
                kn, ku = jax.random.split(k)
                by_path[p].append(
                    (torch.from_numpy(np.array(jax.random.normal(
                        kn, leaf.shape[-2:]))),
                     torch.from_numpy(np.array(jax.random.uniform(
                         ku, leaf.shape[-2:])))))
        return leaf

    jax.tree_util.tree_map_with_path(walk, jparams)
    out = {}
    for layer in range(tcfg.n_layers):
        site, g = TLM.reference_site(tcfg, layer)
        for name in ("w_gate_theta", "w_in_theta"):
            out[(layer, name)] = by_path[f"{site}/['ffn']/['{name}']"][g or 0]
    return out


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

N_STEPS = 3


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.detach().numpy())


@pytest.fixture(scope="module")
def start():
    """A sparse-FFN train state drawn by the port and carried into the
    reference's layout, AdamW's state made by each package's own init
    (the port's through ``train_state_from_numpy``), and the configs."""
    jcfg, tcfg = _cfgs(**SPARSE)
    tparams = TLM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    jparams = {k: jax.tree.map(_jnp, tparams[k])
               for k in ("embed", "final_norm")}
    jparams.update(TLM.layers_to_stacked(
        [jax.tree.map(_jnp, b) for b in tparams["blocks"]], tcfg,
        jnp.stack))
    js = {"params": jparams, "opt": JR._optimizer(jcfg)[0](jparams)}
    return jcfg, tcfg, js


# ---------------------------------------------------------------------------
# three sparse-FFN train steps from a carried-across JAX state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectory(start):
    """Three steps of both packages from one JAX state, the port fed
    the reference's draws; each step's port input is cloned first."""
    jcfg, tcfg, js = start
    _, jstep = JLM.make_train_step(jcfg, JR._optimizer(jcfg), remat=False)
    _, tstep = TLM.make_train_step(tcfg, TR._optimizer(tcfg), remat=False)
    ts = TLM.train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, CPU)
    jstep = jax.jit(jstep)
    out = []
    for s in range(N_STEPS):
        b = _batch(10 + s)
        draws = reference_draws(js["params"], s + 1, tcfg)
        if s == 0:
            first = dict(state=ts, batch=b, draws=draws)
        before = [t.clone() for t in tree_leaves(ts)]
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        inp = ts
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                       draws=draws)
        out.append(dict(
            jstate=jax.tree.map(np.asarray, js), jm=jm, tstate=ts, tm=tm,
            unchanged=all(torch.equal(a, b) for a, b in
                          zip(before, tree_leaves(inp)))))
    return tcfg, out, first


def test_softmax_xent_and_lm_loss_gradients_match_reference(trajectory):
    """``softmax_xent``; then the gradient of ``lm_loss`` (under
    ``remat``) at the start against ``jax.value_and_grad``'s inside the
    reference's first step, read back from AdamW's first moment
    (mu = 0.1 g once g is clipped by the step's ``grad_norm``)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TLM.softmax_xent(torch.from_numpy(logits),
                         torch.from_numpy(labels)).numpy(),
        np.asarray(JLM.softmax_xent(jnp.asarray(logits),
                                    jnp.asarray(labels))), **TOL)

    tcfg, steps, first = trajectory
    tparams = first["state"]["params"]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tparams)]
    it = iter(leaves)
    params = tree_map(lambda _: next(it), tparams)
    b = first["batch"]
    tl, _ = TLM.lm_loss(params, tcfg, torch.from_numpy(b["tokens"]),
                        torch.from_numpy(b["labels"]), remat=True)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()),
                               float(steps[0]["jm"]["loss"]), **TOL)
    gn = float(steps[0]["jm"]["grad_norm"])
    scale = min(1.0, 1.0 / (gn + 1e-9))
    mu = TLM.train_state_from_numpy(steps[0]["jstate"], tcfg, CPU)["opt"].mu
    it = iter(grads)
    got = tree_map(lambda _: next(it), tparams)
    n = 0
    for path, g, m in _pairs(got, mu):
        np.testing.assert_allclose(g.numpy(), (m / 0.1 / scale).numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=path)
        n += 1
    assert n == len(leaves)


def _pairs(got, want, path=""):
    """(path, got leaf, want leaf), matched by key."""
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


# An element whose gradient is within float32 noise of 0 is moved by
# Adam by lr * g / (|g| + eps) with eps 1e-8: a noise-driven fraction of
# lr, which the two packages' noise sets differently (one wq element at
# |g| = 2.4e-9, 1e-6 of its neighbours', parts by 1.2e-5).  Elements
# whose reference gradient fell below NOISE_GRAD at any step so far are
# held to what Adam can move them, 2 lr a step; they must stay rare
# (under 1%; 0.1% here, most of them sign leaves whose theta is 1e-12).
NOISE_GRAD = 1e-7
LR = 3e-4


def _check_step(got, want, s, prev_mu, noisy):
    """One step's state against the reference's: AdamW moments within
    1e-5, parameters within 1e-5 but where ``NOISE_GRAD`` applies,
    equal active sets.  Returns this step's mu (by path)."""
    assert int(got["opt"].step) == int(want["opt"].step) == s + 1
    _assert_tree_close(got["opt"].mu, want["opt"].mu, f"step {s} mu")
    mus = dict((p, w) for p, _, w in _pairs(got["opt"].mu, want["opt"].mu))
    n_noisy = n_all = 0
    for path, g, w in _pairs(got["params"], want["params"]):
        grad = (mus[path] if prev_mu is None
                else mus[path] - 0.9 * prev_mu[path]) / 0.1
        noisy[path] = noisy.get(path, torch.zeros_like(w, dtype=bool)) \
            | ((grad.abs() < NOISE_GRAD) & (grad != 0))
        err = (g - w).abs()
        bound = torch.where(noisy[path], 2 * LR * (s + 1), 0.0) \
            + 1e-5 + 1e-5 * w.abs()
        assert bool((err <= bound).all()), (s, path, float(err.max()))
        n_noisy += int(noisy[path].sum())
        n_all += w.numel()
    assert n_noisy <= 1e-2 * n_all, (s, n_noisy, n_all)
    for i, name in TLM.theta_leaves(got["params"]):
        a = got["params"]["blocks"][i]["ffn"][name] > 0
        b = want["params"]["blocks"][i]["ffn"][name] > 0
        assert torch.equal(a, b), (s, i, name)
    return mus


def test_three_sparse_train_steps_match_reference(trajectory):
    """Equal active sets and losses, step by step; every AdamW moment
    and every parameter within 1e-5, but for elements whose gradient is
    float noise (``NOISE_GRAD``), held to 2 lr a step and counted."""
    tcfg, steps, _ = trajectory
    noisy, prev_mu = {}, None
    for s, st in enumerate(steps):
        np.testing.assert_allclose(float(st["tm"]["loss"]),
                                   float(st["jm"]["loss"]), **TOL)
        np.testing.assert_allclose(float(st["tm"]["grad_norm"]),
                                   float(st["jm"]["grad_norm"]), rtol=1e-5)
        want = TLM.train_state_from_numpy(st["jstate"], tcfg, CPU)
        prev_mu = _check_step(st["tstate"], want, s, prev_mu, noisy)
    got = steps[-1]["tstate"]
    fan = [(t > 0).sum(0) for i, n in TLM.theta_leaves(got["params"])
           for t in [got["params"]["blocks"][i]["ffn"][n]]]
    assert all(int(f.max()) <= 8 for f in fan)    # F_o after the ramp


def test_reference_trains_the_sparse_signs(trajectory):
    """A fault of the reference, reproduced: ``ffn_init`` keeps the
    "frozen" signs as float leaves of ``params`` and ``make_train_step``
    differentiates all of ``params``, so AdamW moves them off {-1, +1}.
    The port moves them as the reference does (within 1e-5)."""
    tcfg, steps, _ = trajectory
    got = steps[-1]["tstate"]["params"]
    want = TLM.train_state_from_numpy(steps[-1]["jstate"], tcfg,
                                      CPU)["params"]
    for i, name in TLM.theta_leaves(got):
        sname = name.replace("_theta", "_sign")
        g, w = got["blocks"][i]["ffn"][sname], want["blocks"][i]["ffn"][sname]
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        assert float((w.abs() - 1).abs().max()) > 1e-4    # moved
        assert float((g.abs() - 1).abs().max()) > 1e-4


def test_train_step_leaves_its_input_unchanged(trajectory):
    _, steps, _ = trajectory
    assert all(st["unchanged"] for st in steps)


def test_accum2_matches_reference(trajectory):
    """``accum=2`` (two micro-batches, the port's under ``remat``): the
    reference's accumulated gradient is the mean of its micro-batches'
    means, the full batch's mean; so one port step is held to the
    reference's first full-batch step from the same start, batch and
    draws, as that step is held above."""
    tcfg, steps, first = trajectory
    _, tstep = TLM.make_train_step(tcfg, TR._optimizer(tcfg), remat=True,
                                   accum=2)
    b = first["batch"]
    ts, tm = tstep(first["state"],
                   {k: torch.from_numpy(v) for k, v in b.items()},
                   draws=first["draws"])
    np.testing.assert_allclose(float(tm["loss"]),
                               float(steps[0]["jm"]["loss"]), **TOL)
    want = TLM.train_state_from_numpy(steps[0]["jstate"], tcfg, CPU)
    _check_step(ts, want, 0, None, {})


def test_schedules_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    for jf, tf in ((JSCH.constant(3e-4), TSCH.constant(3e-4)),
                   (JSCH.cosine(1e-3, 30, 0.1), TSCH.cosine(1e-3, 30, 0.1)),
                   (JSCH.warmup_cosine(3e-4, 20, 100),
                    TSCH.warmup_cosine(3e-4, 20, 100))):
        for s in steps:
            np.testing.assert_allclose(
                float(tf(torch.tensor(s, dtype=torch.int32))),
                float(jf(jnp.asarray(s, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------------------
# sparse-control draws: stable in the port, salted in the reference
# ---------------------------------------------------------------------------

DRAW_PROBE = """
import sys, zlib, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.models import lm, registry
cfg = registry.get_config("qwen2.5-3b", smoke=True)
import dataclasses
cfg = dataclasses.replace(cfg, sparse_ffn=True, dtype=torch.float32)
params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
d = lm.control_draws(cfg, params, 7)
print(zlib.crc32(b"".join(n.numpy().tobytes() + u.numpy().tobytes()
                          for n, u in d.values())))
"""


def test_port_sparse_draws_alike_in_every_process():
    """A process with another string-hash salt draws the same control
    noise for the same step as this one."""
    env = dict(os.environ, PYTHONHASHSEED="12345", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", DRAW_PROBE, os.path.join(ROOT, "src")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    cfg = dataclasses.replace(TR.get_config("qwen2.5-3b", smoke=True),
                              sparse_ffn=True, dtype=torch.float32)
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d = TLM.control_draws(cfg, params, 7)
    here = zlib.crc32(b"".join(n.numpy().tobytes() + u.numpy().tobytes()
                               for n, u in d.values()))
    assert proc.stdout.strip() == str(here)


def test_reference_sparse_draws_are_salted_per_process():
    """A fault of the reference, not reproduced: ``apply_sparse_control``
    seeds each leaf's key from ``hash()`` of its path (``lm.py:655``),
    which Python salts per process, so two runs of one command prune and
    regrow differently."""
    expr = ("print(abs(hash(\"['stacks']/[0]/['ffn']/['w_in_theta']\")) "
            "% (2 ** 31))")
    seeds = {subprocess.run([sys.executable, "-c", expr], text=True,
                            capture_output=True,
                            env=dict(os.environ, PYTHONHASHSEED=s)
                            ).stdout.strip() for s in ("1", "2")}
    assert len(seeds) == 2


# ---------------------------------------------------------------------------
# data/tokens and checkpoints
# ---------------------------------------------------------------------------

def test_token_stream_and_batches_bit_for_bit():
    for vocab, n, seed in ((128, 3000, 0), (8192, 2000, 3)):
        a = JTOK.synthetic_token_stream(vocab, n, seed=seed)
        b = TTOK.synthetic_token_stream(vocab, n, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ja = JTOK.lm_batch_iterator(a, 4, 16, seed=5)
    tb = TTOK.lm_batch_iterator(b, 4, 16, seed=5, device="cpu")
    for _ in range(3):
        j, t = next(ja), next(tb)
        for k in ("tokens", "labels"):
            assert t[k].dtype == torch.int32
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


class _Opt(NamedTuple):
    step: object
    mu: object


def _ckpt_tree(rng, bf16, zeros):
    """A tree with a bf16 leaf, 0-d leaves, a leaf chunked by a small
    shard size, a named tuple, a list and a None."""
    return {
        "w": bf16(rng.normal(size=(37, 3)).astype(np.float32)),
        "z": {"b": zeros(rng.normal(size=(5,)).astype(np.float32)),
              "i": zeros(np.asarray(7, np.int32))},
        "opt": _Opt(step=zeros(np.asarray(3, np.int32)),
                    mu=[zeros(rng.normal(size=(64, 8)).astype(np.float32)),
                        None,
                        bf16(np.asarray(1.5, np.float32))]),
        "step": 11,
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    jtree = _ckpt_tree(np.random.default_rng(0),
                       lambda a: jnp.asarray(a, jnp.bfloat16), jnp.asarray)
    ttree = _ckpt_tree(np.random.default_rng(0),
                       lambda a: torch.from_numpy(a).to(torch.bfloat16),
                       torch.from_numpy)
    small = 200                   # bytes: the (64, 8) leaf goes in chunks
    if writer == "jax":
        path = JCK.save_checkpoint(str(tmp_path), 11, jtree,
                                   max_shard_bytes=small)
        got, step = TCK.restore_checkpoint(str(tmp_path), ttree)
        want = ttree
    else:
        path = TCK.save_checkpoint(str(tmp_path), 11, ttree,
                                   max_shard_bytes=small)
        got, step = JCK.restore_checkpoint(str(tmp_path), jtree)
        want = jtree
    assert step == 11 and os.path.isdir(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert any(len(e["chunks"]) > 1 for e in manifest["leaves"])
    assert {e["dtype"] for e in manifest["leaves"]} >= {"bfloat16",
                                                        "float32", "int32"}
    assert isinstance(got["opt"], _Opt) and got["opt"].mu[1] is None
    leaves = (TCK.tree_flatten(got), TCK.tree_flatten(want)) \
        if writer == "jax" else (jax.tree.leaves(got), jax.tree.leaves(want))
    assert len(leaves[0]) == len(leaves[1]) == 7
    for a, b in zip(*leaves):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                               b.view(torch.uint8) if b.dim() else b)
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_async_checkpointer_snapshots_a_copy(tmp_path):
    """A CPU tensor changed after ``save`` is called does not change what
    is written (``.numpy()`` would alias it)."""
    t = torch.zeros(4)
    ck = TCK.AsyncCheckpointer(TCK.CheckpointManager(str(tmp_path)))
    ck.save(1, {"t": t})
    t.add_(1.0)
    ck.wait()
    got, _ = TCK.restore_checkpoint(str(tmp_path), {"t": t})
    assert torch.equal(got["t"], torch.zeros(4))


# ---------------------------------------------------------------------------
# the trainer (the contract of tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _quadratic_step():
    """Toy step: minimize ||w||^2, returns (new state, metrics)."""
    opt_init, opt_update = adamw(1e-1)

    def init(seed):
        w = torch.randn(4, generator=torch.Generator().manual_seed(seed))
        return {"params": w, "opt": opt_init(w)}

    def step(state, batch):
        w = state["params"].detach().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum(w ** 2), w)
        updates, opt = opt_update(g, state["opt"], state["params"])
        params = apply_updates(state["params"], updates)
        return {"params": params, "opt": opt}, {"loss": torch.sum(params ** 2)}

    return init, step


def _batches():
    return itertools.repeat({"x": torch.zeros(())})


def test_trainer_runs_and_checkpoints(tmp_path):
    init, step = _quadratic_step()
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                 step, init(0))
    tr.run(_batches(), 20, log_every=5)
    assert tr.step == 20
    assert len(tr.manager.steps()) >= 1
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


def test_trainer_recovers_from_injected_crash(tmp_path):
    init, step = _quadratic_step()
    crashed = {"done": False}

    def failure_hook(s):
        if s == 12 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected preemption")

    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                 step, init(0), failure_hook=failure_hook)
    tr.run(_batches(), 20)
    assert tr.step == 20 and tr.recoveries == 1 and crashed["done"]


def test_trainer_gives_up_after_max_retries(tmp_path):
    init, step = _quadratic_step()

    def always_fail(s):
        raise RuntimeError("deterministic bug")

    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), max_retries=2),
                 step, init(0), failure_hook=always_fail)
    with pytest.raises(RuntimeError):
        tr.run(_batches(), 5)
    assert tr.recoveries == 3


def test_trainer_detects_nan(tmp_path):
    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), max_retries=1),
                 nan_step, {"w": torch.zeros(())})
    with pytest.raises(FloatingPointError):
        tr.run(_batches(), 3)


def test_trainer_resume_from_checkpoint(tmp_path):
    init, step = _quadratic_step()
    tr1 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                  step, init(0))
    tr1.run(_batches(), 10)
    tr1.ckpt.wait()
    # a new process: fresh state, resume from disk
    tr2 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                  step, init(1))
    assert tr2.try_resume()
    assert tr2.step == 10
    assert torch.equal(tr2.state["params"], tr1.state["params"])
    assert torch.equal(tr2.state["opt"].nu, tr1.state["opt"].nu)


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(window=20, threshold=2.0, warmup=5)
    for _ in range(10):
        assert not mon.observe(0.1)
    assert mon.observe(1.0)        # 10x median
    assert not mon.observe(0.1)


# ---------------------------------------------------------------------------
# the examples and the train launcher, in-process at small arguments
# ---------------------------------------------------------------------------

def _example(name):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_example_lm_sparse_train(tmp_path, capsys):
    ex = _example("torch_lm_sparse_train")
    tr = ex.main(["--steps", "1", "--batch", "1", "--seq", "8",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert tr.step == 1 and tr.recoveries == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if "_theta" in l]
    assert len(lines) == 24          # 12 layers x (w_in, w_gate)
    assert all("min=64 max=64" in l for l in lines)


def test_example_mnist_sparselut(capsys):
    res = _example("torch_mnist_sparselut").main(["--steps", "2",
                                                  "--device", "cpu"])
    assert len(res["random"]) == 3
    assert all(0.0 <= a <= 1.0 for a in res["random"] + [res["deepr"],
                                                         res["sparselut"]])
    assert "SparseLUT connectivity acc" in capsys.readouterr().out


def test_example_lut_serve(tmp_path, monkeypatch):
    ex = _example("torch_lut_serve")
    res = ex.main(["--train-steps", "2", "--requests", "64", "--device",
                   "cpu", "--artifact-dir", str(tmp_path)])
    for mid in ("jsc-base", "jsc-lite"):
        assert res[mid]["served"] == 64
        assert res[mid]["failed"] == res[mid]["dropped"] == 0
    # --shards N splits each microbatch over N CPU entries, which the
    # host must allow first (repro_torch.device.ensure_host_devices)
    monkeypatch.setenv("REPRO_TORCH_HOST_DEVICES", "2")
    res = ex.main(["--train-steps", "2", "--requests", "64", "--device",
                   "cpu", "--artifact-dir", str(tmp_path), "--shards", "2"])
    for mid in ("jsc-base", "jsc-lite"):
        assert res[mid]["served"] == 64
        assert res[mid]["failed"] == res[mid]["dropped"] == 0
    with pytest.raises(ValueError, match="3 devices requested"):
        ex.main(["--shards", "3", "--device", "cpu"])


def test_train_launcher_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--steps", "3", "--ckpt-every", "2",
            "--log-every", "1", "--sparse-ffn", "--ckpt-dir", str(tmp_path)]
    tr = train.main(args)
    assert tr.step == 3 and tr.manager.steps() == [2]
    tr2 = train.main(args[:3] + ["4"] + args[4:])
    assert tr2.step == 4
    assert "arch=qwen2.5-3b-smoke device=cpu steps=4" in \
        capsys.readouterr().out
