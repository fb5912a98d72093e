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


# the card the geometry is planned for: an H100's SMs
N_SMS = 132


@pytest.mark.parametrize("n_in", [16, 37, 784, 4096])
@pytest.mark.parametrize("B", [1, 7, 1024, 4096, 16384])
def test_mm_geometry_fits_covers_every_row_once_in_one_wave(B, n_in):
    """``mm_geometry`` (the kernel's launch, a pure function): its
    shared-memory ledger fits the budget, its blocks' tiles cover every
    batch row exactly once and its neuron tiles every neuron, and its
    grid is at most one wave of the blocks the card holds resident."""
    from repro_torch.kernels.lut_gather import lut_gather as LG
    from repro_torch.kernels.masked_matmul import masked_matmul as MM

    for n_out, F in ((256, 6), (300, 12), (19, 1), (129, 8)):
        g = MM.mm_geometry(B, N_SMS, n_in, n_out, F)
        assert 0 < g.smem_bytes <= MM.SMEM_BUDGET_BYTES
        assert g.smem_bytes == MM.mm_smem_bytes(g.rows, n_in, g.stages)
        assert 1 <= g.stages <= min(MM.MAX_STAGES, g.tiles)
        assert g.ntile <= g.threads <= MM.MAX_THREADS
        assert g.threads % 32 == 0
        assert (g.neuron_tiles - 1) * g.ntile < n_out \
            <= g.neuron_tiles * g.ntile
        n_tiles = -(-B // g.rows)
        seen = np.zeros(B, np.int64)
        for b in range(g.grid):                  # block b's row tiles
            walked = range(b, n_tiles, g.grid)
            assert 0 < len(walked) <= g.tiles
            for t in walked:
                seen[t * g.rows:(t + 1) * g.rows] += 1
        assert (seen == 1).all()
        resident = LG.resident_blocks(
            g.threads, g.smem_bytes, regs_per_thread=MM.regs_per_thread(F))
        assert g.grid * g.neuron_tiles <= resident * N_SMS
        assert g.blocks_per_sm <= resident


def test_mm_geometry_reads_a_row_too_wide_for_shared_memory_unstaged():
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    g = MM.mm_geometry(5, N_SMS, 70000, 33, 4)
    assert (g.stages, g.smem_bytes) == (0, 0)
    assert g.grid * g.rows >= 5
