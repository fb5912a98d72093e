"""Port parity of the WKV6 plain versions (``repro_torch.models.
recurrent.wkv_chunked_ref`` / ``wkv_naive``, what the CUDA kernel's
wrapper runs on CPU tensors) against the JAX package's ``wkv_naive``
and ``wkv_chunked_ref`` at the LM's chunk of 32 tokens.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance: rtol = atol = 2e-4 in float32, the bound
``tests/test_kernels.py`` holds the reference kernel to (the chunked
form sums in another order than the sequential one)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as JRC
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import recurrent as TRC

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, S, H, K, seed, clamp=False, with_s0=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    if clamp:
        logw = np.full((B, S, H, K), JRC.LOG_DECAY_MIN, np.float32)
    else:   # the LM's decays: -exp(w0 + lora), clamped
        logw = np.maximum(-np.exp(-1.5 + 0.5 * rng.standard_normal(
            (B, S, H, K))), JRC.LOG_DECAY_MIN).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, K))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, K)).astype(np.float32)
          if with_s0 else None)
    return r, k, v, logw, u, s0


def _jax(fn, args, **kw):
    o, s = fn(*[None if a is None else jnp.asarray(a) for a in args], **kw)
    return np.asarray(o), np.asarray(s)


def _torch(fn, args, **kw):
    o, s = fn(*[None if a is None else torch.from_numpy(a) for a in args],
              **kw)
    return o.numpy(), s.numpy()


@pytest.mark.parametrize("S,with_s0", [
    (45, True),       # ragged S: one chunk of 32 and 13 tokens
    (20, True),       # S shorter than one chunk
    (40, False),      # s0 = None
])
def test_plain_wkv_matches_reference(S, with_s0):
    args = _inputs(2, S, 2, 16, seed=S, with_s0=with_s0)
    want_naive = _jax(JRC.wkv_naive, args)
    want_chunk = _jax(JRC.wkv_chunked_ref, args, chunk=JRC.WKV_CHUNK)
    got_chunk = _torch(TRC.wkv_chunked_ref, args)
    got_naive = _torch(TRC.wkv_naive, args)
    got_wrapper = _torch(wkv_ops.wkv6, args)   # CPU: the chunked form
    for got in (got_chunk, got_naive, got_wrapper):
        for g, w_n, w_c in zip(got, want_naive, want_chunk):
            np.testing.assert_allclose(g, w_n, **TOL)
            np.testing.assert_allclose(g, w_c, **TOL)


def test_plain_wkv_state_carry_composes():
    """Two calls split at S/2, the state carried, equal one call."""
    r, k, v, logw, u, s0 = _inputs(2, 64, 2, 16, seed=9)
    h = 32
    o_full, s_full = _torch(TRC.wkv_chunked_ref, (r, k, v, logw, u, s0))
    o1, s_mid = _torch(TRC.wkv_chunked_ref,
                       (r[:, :h], k[:, :h], v[:, :h], logw[:, :h], u, s0))
    o2, s_end = _torch(TRC.wkv_chunked_ref,
                       (r[:, h:], k[:, h:], v[:, h:], logw[:, h:], u, s_mid))
    np.testing.assert_allclose(np.concatenate([o1, o2], axis=1), o_full,
                               **TOL)
    np.testing.assert_allclose(s_end, s_full, **TOL)
    want_o, want_s = _jax(JRC.wkv_naive, (r, k, v, logw, u, s0))
    np.testing.assert_allclose(o_full, want_o, **TOL)
    np.testing.assert_allclose(s_full, want_s, **TOL)


def test_plain_wkv_finite_at_the_decay_clamp():
    """Every decay at LOG_DECAY_MIN: the chunk-32 form stays finite and
    matches the sequential definition; the chunk-128 form (the reference
    kernel's default) overflows exp(-cum) and does not."""
    args = _inputs(2, 256, 2, 16, seed=4, clamp=True, with_s0=False)
    o, s = _torch(TRC.wkv_chunked_ref, args)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    want_o, want_s = _jax(JRC.wkv_naive, args)
    np.testing.assert_allclose(o, want_o, **TOL)
    np.testing.assert_allclose(s, want_s, **TOL)
    o128, _ = _torch(TRC.wkv_chunked_ref, args, chunk=128)
    assert not np.isfinite(o128).all()
