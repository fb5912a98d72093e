"""CUDA fan-in-sparse masked matmul for Hopper and its wrapper (port of
the Pallas kernel
``repro.kernels.masked_matmul.masked_matmul.masked_matmul_pallas``).

The kernel, in ``csrc/masked_matmul.cu``, gathers each output's F
inputs directly through ``conn`` (the TPU kernel's one-hot selection
matmul is not ported).  Tiles of x rows stream into a ring of stages in
shared memory by bulk asynchronous copy; each thread holds one neuron's
indices and weights in registers.  ``mm_geometry`` picks the launch for
each call from the batch and the card.  Forward only, as in the
reference; inputs are taken as float32, as the reference kernel casts
them.

The wrapper takes the plain version (``ref.masked_matmul``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and adds one to its count in ``LIBRARY`` where it launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, check_rc, stream
from repro_torch.kernels.lut_gather import lut_gather as LG
from repro_torch.kernels.masked_matmul import ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "masked_matmul.cu")
SMEM_BUDGET_BYTES = LG.SMEM_BUDGET_BYTES
# threads a block, one neuron each, and the registers the kernel's launch
# bound leaves a thread: 256 threads and 6 blocks an SM, 4 for the
# fan-ins 7 and 8, whose indices and weights would spill at 40
MAX_THREADS = 256
MAX_REGS_PER_THREAD = 40
WIDE_F_REGS_PER_THREAD = 64
# rows a tile: about STAGE_TARGET_BYTES of x a stage (four rows of 784
# floats), fewer where the batch would leave SMs without
# BLOCKS_PER_SM_TARGET tiles, at most MAX_TILE_ROWS
STAGE_TARGET_BYTES = 16 * 1024
BLOCKS_PER_SM_TARGET = 2
MAX_TILE_ROWS = 64
# the ring: at most MAX_STAGES stages, each rounded up to 16 bytes with
# STAGE_SLACK floats of room to land a tile at its 16-byte offset, behind
# a slot of BARRIER_BYTES for their mbarriers
MAX_STAGES = 4
STAGE_SLACK = 4
BARRIER_BYTES = 32


def regs_per_thread(F: int) -> int:
    """The register cap of the kernel compiled for fan-in ``F``."""
    return WIDE_F_REGS_PER_THREAD if F in (7, 8) else MAX_REGS_PER_THREAD


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_mm_launch.argtypes = [vp] * 5 + [i] * 12 + [vp]
    lib.masked_mm_launch.restype = i


LIBRARY = KernelLibrary(SOURCE, ("masked_matmul",), _bind)
build = LIBRARY.load
reset_launch_counts = LIBRARY.reset_counts
launch_counts = LIBRARY.counts


def mm_smem_bytes(rows: int, n_in: int, stages: int) -> int:
    """The ledger: shared memory of one block with ``stages`` stages of
    ``rows`` x ``n_in`` floats, exactly what the kernel lays out."""
    return BARRIER_BYTES + 4 * stages * (-(-rows * n_in // 4) * 4
                                         + STAGE_SLACK)


@dataclasses.dataclass(frozen=True)
class MMGeometry:
    """One launch of the kernel: tiles of ``rows`` batch rows, blocks of
    ``threads`` threads each taking ``ntile`` neurons (one a thread),
    ``grid`` x ``neuron_tiles`` blocks, each walking at most ``tiles``
    row tiles through a ring of ``stages`` stages (0: x read unstaged
    from device memory), ``smem_bytes`` of dynamic shared memory a
    block, ``blocks_per_sm`` blocks meant to be resident and the
    shared-memory ``carveout`` they need (-1: left to CUDA)."""
    rows: int
    threads: int
    ntile: int
    grid: int
    neuron_tiles: int
    tiles: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    carveout: int

    def launch_args(self) -> tuple:
        """The ints ``masked_mm_launch`` takes after F."""
        return (self.rows, self.threads, self.ntile, self.grid,
                self.neuron_tiles, self.stages, self.smem_bytes,
                self.carveout)


def _resident(threads: int, smem: int, F: int) -> int:
    return LG.resident_blocks(threads, smem,
                              regs_per_thread=regs_per_thread(F))


@functools.lru_cache(maxsize=256)
def mm_geometry(B: int, n_sms: int, n_in: int, n_out: int,
                F: int) -> MMGeometry:
    """The launch geometry for a batch of ``B`` rows of ``n_in`` floats
    into ``n_out`` neurons of fan-in ``F`` on a card of ``n_sms`` SMs — a
    pure function of its arguments.

    One neuron a thread, up to MAX_THREADS a block; wider layers split
    their neurons over ``neuron_tiles`` blocks.  Rows a tile: the power
    of two nearest B / (BLOCKS_PER_SM_TARGET * #SMs), but no more than
    fill a STAGE_TARGET_BYTES stage (at least one row) or MAX_TILE_ROWS.
    The grid is one wave of what the card holds resident, or one block a
    tile where that is fewer, and block b walks tiles b, b + grid, ...;
    a block takes as many stages (up to MAX_STAGES, no more than the
    tiles it walks) as keep that wave resident: the 784 -> 256 layer
    runs 4-row tiles, one a block on 256 blocks at B=1024, 1-2 a block
    on 792 blocks through two stages at B=4096 and 5-6 through three at
    B=16384.  A row too wide for one stage in the shared-memory budget is
    read unstaged (``stages`` 0)."""
    if min(B, n_sms, n_in, n_out) < 1 or F < 0:
        raise ValueError(f"no geometry for B={B}, n_sms={n_sms}, "
                         f"n_in={n_in}, n_out={n_out}, F={F}")
    threads = min(MAX_THREADS, 32 * -(-n_out // 32))
    ntile = min(n_out, threads)
    neuron_tiles = -(-n_out // ntile)
    staged = mm_smem_bytes(1, n_in, 1) <= SMEM_BUDGET_BYTES
    rows = LG._pow2_nearest(B * neuron_tiles
                            / (BLOCKS_PER_SM_TARGET * n_sms))
    if staged:
        rows = min(rows, LG._pow2_floor(STAGE_TARGET_BYTES // (4 * n_in)))
    rows = max(1, min(rows, MAX_TILE_ROWS, LG._pow2_ceil(B)))
    while staged and rows > 1 and \
            mm_smem_bytes(rows, n_in, 1) > SMEM_BUDGET_BYTES:
        rows //= 2
    n_tiles = -(-B // rows)
    one = mm_smem_bytes(rows, n_in, 1) if staged else 0
    wave = _resident(threads, one, F) * n_sms
    # every resident slot takes a block, each walking tiles b, b + grid,
    # ...: blocks differ by at most one tile, and so do SMs (a grid of
    # ceil(n_tiles / tiles) blocks would leave some SMs a block short)
    grid = max(1, min(n_tiles, wave // neuron_tiles))
    tiles = -(-n_tiles // grid)
    need = -(-grid * neuron_tiles // n_sms)      # blocks an SM must hold
    stages, smem = 0, 0
    if staged:
        stages, smem = 1, one
        for s in range(2, min(MAX_STAGES, tiles) + 1):
            b = mm_smem_bytes(rows, n_in, s)
            if b > SMEM_BUDGET_BYTES or _resident(threads, b, F) < need:
                break
            stages, smem = s, b
    resident = min(_resident(threads, smem, F), need)
    return MMGeometry(rows=rows, threads=threads, ntile=ntile, grid=grid,
                      neuron_tiles=neuron_tiles, tiles=tiles, stages=stages,
                      smem_bytes=smem, blocks_per_sm=resident,
                      carveout=LG._carveout(resident, smem) if staged
                      else -1)


def masked_matmul(x: torch.Tensor, conn: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, n_in); conn: (n_out, F) integers; w: (n_out, F); bias:
    (n_out,) or None.  Returns (B, n_out) float32.

    One contract on both branches, checked before the device branch:
    the shapes above (ValueError otherwise), ``conn`` of an integer
    dtype cast to int32 as the reference's dtype rules cast it (a float
    ``conn`` raises TypeError).  A fan-in index outside [0, n_in) raises
    ValueError for CPU tensors; on the card the kernel checks each index
    as it loads it and makes that output NaN, with no read outside x and
    no host sync."""
    dev = x.device
    for name, t in (("conn", conn), ("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dim() != 2 or conn.dim() != 2 or w.shape != conn.shape:
        raise ValueError("want x (B, n_in), conn and w (n_out, F)")
    B, n_in = x.shape
    n_out, F = conn.shape
    if bias is not None and tuple(bias.shape) != (n_out,):
        raise ValueError(f"bias of shape {tuple(bias.shape)}, want "
                         f"{(n_out,)}")
    if conn.dtype.is_floating_point or conn.dtype.is_complex \
            or conn.dtype == torch.bool:
        raise TypeError(f"conn must be integers, got {conn.dtype}")
    conn = conn.to(torch.int32)
    if dev.type == "cpu":
        if conn.numel() and (int(conn.min()) < 0
                             or int(conn.max()) >= n_in):
            raise ValueError(f"conn indexes outside [0, {n_in})")
        return ref.masked_matmul(x.float(), conn, w.float(),
                                 None if bias is None else bias.float())
    if dev.type != "cuda":
        raise ValueError(f"no masked-matmul kernel for device {dev}")

    if B == 0 or n_out == 0:
        return torch.empty((B, n_out), dtype=torch.float32, device=dev)
    if n_in == 0:
        raise ValueError("x has no columns for conn to index")
    x = x.to(torch.float32).contiguous()
    conn = conn.contiguous()
    w = w.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    return _launch(x, conn, w, bias,
                   mm_geometry(B, LG._sm_count(dev.index), n_in, n_out, F))


def _launch(x: torch.Tensor, conn: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor], g: MMGeometry) -> torch.Tensor:
    """One launch of the kernel as ``g`` says, on checked contiguous
    float32 / int32 CUDA tensors of at least one row and neuron."""
    B, n_in = x.shape
    n_out, F = conn.shape
    y = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.masked_mm_launch(
            x.data_ptr(), conn.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            B, n_in, n_out, F, *g.launch_args(), stream(x.device))
    check_rc(rc, "masked_matmul")
    LIBRARY.count("masked_matmul")
    return y
