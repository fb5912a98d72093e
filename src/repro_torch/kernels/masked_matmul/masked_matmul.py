"""CUDA fan-in-sparse masked matmul for Hopper and its wrapper (port of
the Pallas kernel
``repro.kernels.masked_matmul.masked_matmul.masked_matmul_pallas``).

The kernel, in ``csrc/masked_matmul.cu``, gathers each output's F
inputs directly through ``conn`` (the TPU kernel's one-hot selection
matmul is not ported) from a block's rows of x staged in shared memory.
Forward only, as in the reference; inputs are taken as float32, as the
reference kernel casts them.

The wrapper takes the plain version (``ref.masked_matmul``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and adds one to its count in ``LIBRARY`` where it launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, check_rc, stream
from repro_torch.kernels.masked_matmul import ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "masked_matmul.cu")
# H100: most shared memory one block may use (dynamic, opted in above 48 KB)
SMEM_BUDGET_BYTES = 232_448
# batch rows per block: 4 rows of 256 outputs keep a 256-thread block at
# 4 outputs a thread, and a B=1024 batch spreads over 256 blocks
BLOCK_ROWS = 4


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_mm_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
    lib.masked_mm_launch.restype = i


LIBRARY = KernelLibrary(SOURCE, ("masked_matmul",), _bind)
build = LIBRARY.load
reset_launch_counts = LIBRARY.reset_counts
launch_counts = LIBRARY.counts


def block_plan(n_in: int):
    """(rows per block, shared-memory bytes): BLOCK_ROWS rows of x staged
    when they fit, fewer when only fewer do, and (BLOCK_ROWS, 0) -- the
    unstaged kernel -- when not even one row fits."""
    row_bytes = 4 * n_in
    rows = min(BLOCK_ROWS, SMEM_BUDGET_BYTES // row_bytes)
    if rows == 0:
        return BLOCK_ROWS, 0
    return rows, rows * row_bytes


def masked_matmul(x: torch.Tensor, conn: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, n_in); conn: (n_out, F) int32; w: (n_out, F); bias:
    (n_out,) or None.  Returns (B, n_out) float32.

    A fan-in index outside [0, n_in) raises ValueError for CPU tensors;
    on the card the kernel checks each index as it reads it and makes
    that output NaN, with no read outside x and no host sync."""
    dev = x.device
    for name, t in (("conn", conn), ("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if dev.type == "cpu":
        n_in = x.shape[-1]
        if conn.numel() and (int(conn.min()) < 0
                             or int(conn.max()) >= n_in):
            raise ValueError(f"conn indexes outside [0, {n_in})")
        return ref.masked_matmul(x.float(), conn, w.float(),
                                 None if bias is None else bias.float())
    if dev.type != "cuda":
        raise ValueError(f"no masked-matmul kernel for device {dev}")

    if x.dim() != 2 or conn.dim() != 2 or w.shape != conn.shape:
        raise ValueError("want x (B, n_in), conn and w (n_out, F)")
    B, n_in = x.shape
    n_out, F = conn.shape
    if bias is not None and tuple(bias.shape) != (n_out,):
        raise ValueError(f"bias of shape {tuple(bias.shape)}, want "
                         f"{(n_out,)}")
    if conn.dtype != torch.int32:
        raise TypeError("conn must be int32")
    y = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    if B == 0 or n_out == 0:
        return y
    x = x.to(torch.float32).contiguous()
    conn = conn.contiguous()
    w = w.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    rows, smem = block_plan(n_in)
    vec4 = int(x.data_ptr() % 16 == 0 and n_in % 4 == 0)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.masked_mm_launch(
            x.data_ptr(), conn.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            B, n_in, n_out, F, rows, smem, vec4, stream(dev))
    check_rc(rc, "masked_matmul")
    LIBRARY.count("masked_matmul")
    return y
