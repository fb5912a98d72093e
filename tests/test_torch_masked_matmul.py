"""Port parity of the masked-matmul plain versions (``repro_torch.
kernels.masked_matmul.ref``, what the CUDA kernel's wrapper runs on CPU
tensors) against the JAX package's ``ref.masked_matmul`` and
``masked_matmul_dense``.

Inputs are drawn with numpy from a seed.  Tolerance rtol 1e-5 (atol
1e-6): the F-term sums of float32 products are taken in another order
by each form."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_matmul import ref as jref
from repro_torch.kernels.masked_matmul import ops as tops
from repro_torch.kernels.masked_matmul import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(B, n_in, n_out, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n_in)).astype(np.float32)
    conn = rng.integers(0, n_in, (n_out, F)).astype(np.int32)
    w = rng.standard_normal((n_out, F)).astype(np.float32)
    b = rng.standard_normal((n_out,)).astype(np.float32)
    return x, conn, w, b


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B,n_in,n_out,F", [
    (37, 784, 250, 6),        # the kernels-bench layer, ragged, cut in B
    (8, 16, 40, 16),          # fan-in as wide as the input: repeats
])
def test_plain_masked_matmul_matches_reference(B, n_in, n_out, F,
                                               with_bias):
    x, conn, w, b = _inputs(B, n_in, n_out, F, seed=n_in + F)
    jb = jnp.asarray(b) if with_bias else None
    tb = torch.from_numpy(b) if with_bias else None
    jx, jc, jw = jnp.asarray(x), jnp.asarray(conn), jnp.asarray(w)
    tx, tc, tw = (torch.from_numpy(a) for a in (x, conn, w))
    want = np.asarray(jref.masked_matmul(jx, jc, jw, jb))
    want_dense = np.asarray(jref.masked_matmul_dense(jx, jc, jw, n_in, jb))
    got = {
        "ref": tref.masked_matmul(tx, tc, tw, tb),
        "dense": tref.masked_matmul_dense(tx, tc, tw, n_in, tb),
        "wrapper": tops.masked_matmul(tx, tc, tw, tb),  # CPU: plain
    }
    for name, y in got.items():
        assert y.dtype == torch.float32 and y.shape == (B, n_out), name
        np.testing.assert_allclose(y.numpy(), want, err_msg=name, **TOL)
        np.testing.assert_allclose(y.numpy(), want_dense, err_msg=name,
                                   **TOL)


def test_wrapper_refuses_out_of_range_conn_on_cpu():
    x, conn, w, b = _inputs(4, 10, 3, 2, seed=1)
    tx, tc, tw = (torch.from_numpy(a) for a in (x, conn, w))
    for bad in (10, -1):
        tc2 = tc.clone()
        tc2[2, 1] = bad
        with pytest.raises(ValueError, match="outside"):
            tops.masked_matmul(tx, tc2, tw)
