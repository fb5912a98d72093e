"""Plain PyTorch versions of the fan-in-sparse masked matmul (port of
``repro.kernels.masked_matmul.ref``).

Every output neuron reads exactly F inputs selected by an integer
connectivity table (SparseLUT's learned mask, or the random baseline):

    y[b, n] = sum_f w[n, f] * x[b, conn[n, f]] + bias[n]
"""
from __future__ import annotations

from typing import Optional

import torch


def masked_matmul(x: torch.Tensor, conn: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, n_in); conn: (n_out, F) int; w: (n_out, F).  Returns
    (B, n_out) = sum_f x[:, conn[n, f]] * w[n, f] (+ bias)."""
    gathered = x[:, conn.long()]                 # (B, n_out, F)
    y = torch.einsum("bnf,nf->bn", gathered, w)
    if bias is not None:
        y = y + bias
    return y


def dense_weights(conn: torch.Tensor, w: torch.Tensor,
                  n_in: int) -> torch.Tensor:
    """(conn, w) scattered into the equivalent (n_in, n_out) matrix;
    repeated fan-in slots add up."""
    n_out, F = conn.shape
    dense = torch.zeros((n_in, n_out), dtype=w.dtype, device=w.device)
    cols = torch.arange(n_out, device=w.device)[:, None].expand(n_out, F)
    return dense.index_put_((conn.reshape(-1).long(), cols.reshape(-1)),
                            w.reshape(-1), accumulate=True)


def masked_matmul_dense(x: torch.Tensor, conn: torch.Tensor,
                        w: torch.Tensor, n_in: int,
                        bias: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The equivalent dense form: scatter (conn, w) into a (n_in, n_out)
    matrix and multiply (the second oracle of the tests)."""
    y = x @ dense_weights(conn, w, n_in)
    if bias is not None:
        y = y + bias
    return y
