"""CUDA LUT kernels for Hopper and their wrappers (port of the Pallas
kernels in ``repro.kernels.lut_gather.lut_gather``).

Three kernels, in ``csrc/lut_gather.cu``:

* ``lut_gather`` — one layer, a block per tile of rows x tile of neurons
  (``layer_geometry``), its rows' codes staged in shared memory; replaces
  ``lut_gather_pallas``.  ``lut_gather`` runs one layer; ``lut_layers``
  runs a chain of layers (the ``per_layer`` plan's forward), one launch
  a layer, from one host call.
* ``lut_network_fused(pipeline=False)`` — every layer of the network in
  one launch, one block per tile of batch rows (rows chosen per call
  from the batch: ``fused_geometry``), inter-layer codes in
  shared memory; replaces ``lut_network_fused_pallas`` in grid mode.
* ``lut_network_fused(pipeline=True)`` — the persistent form: a grid
  sized to what the card holds resident, each block walking its tiles
  while the next tiles' input codes arrive by bulk asynchronous copy in
  a ring of stages; replaces the double-buffered ``pipeline=True`` mode.

Each wrapper takes the plain version (``ref.py``) only for tensors on
the CPU; for a CUDA tensor it launches its kernel or raises.  Each adds
one to its count in ``LIBRARY`` for each kernel launch.

Build: ``repro_torch.kernels.build`` compiles the source with ``nvcc``
at first use into ``_build/`` beside this file and loads it with
``ctypes``.

Shared-memory ledger of the fused kernels (the port's counterpart of the
reference's VMEM estimate, which is a TPU number and does not carry
over): a block holds int32 codes for ``rows`` batch rows — the input
codes (one slot, two stages for the pipelined kernel, each with 16 bytes
of alignment slack, beside its two barriers) plus two buffers for hidden
layers' outputs, P for even layers and Q for odd ones.  Table slabs are
not staged: they are read through the read-only path and stay in L2, and
in L1 as far as the carveout leaves room.  The ledger at
``MAX_BLOCK_ROWS`` rows (fewer when the 227 KB per-block limit says so)
is the cap that decides how a network is segmented
(``ops.plan_segments``).  Within the cap, ``fused_geometry`` picks the
rows of each launch from the batch at call time: few rows a
block for a small batch, so it spreads over the card's SMs; more for a
large one, with several blocks resident on each SM.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.build import KernelLibrary, check_rc, stream
from repro_torch.kernels.lut_gather import ref

# H100: most shared memory one block may use (dynamic, opted in above 48 KB)
SMEM_BUDGET_BYTES = 232_448
# the ledger's cap on rows per block: 32 rows, one warp's lanes, the most
# one neuron's row group may span (the kernels put rows fastest across
# lanes); also the cap that decides segmentation
MAX_BLOCK_ROWS = 32
# threads per block (each kernel's launch bound caps it: MAX_*_THREADS,
# and holds it to MAX_REGS_PER_THREAD registers).  Grid mode takes 128: on
# the H100 a rows x threads sweep put 128-thread blocks ahead at B=256 and
# B=4096
FUSED_THREADS = 128
PIPELINED_THREADS = 128
GATHER_THREADS = 128
MAX_FUSED_THREADS = 512
MAX_PIPELINED_THREADS = 256
MAX_GATHER_THREADS = 256
MAX_REGS_PER_THREAD = 64
# grid mode and kernel 3: rows per block near B / (BLOCKS_PER_SM_TARGET *
# #SMs), never so many that that many blocks no longer fit one SM's shared
# memory, and at least MIN_SHARED_ROWS once the batch gives each SM that
# many rows (lanes of a neuron share its conn and table reads across rows)
BLOCKS_PER_SM_TARGET = 4
MIN_SHARED_ROWS = 2
# the pipelined kernel: rows a block from the batch (about one block an
# SM), held to PIPELINED_NEURONS_PER_THREAD neurons of the widest layer
# a thread (the H100 sweep's best at B=4096 for HDR-Add2 and
# JSC-XL-Add2: kernel_ab.py --sweep), with at least PIPELINED_THREADS
# threads; a ring of PIPELINE_STAGES input stages (one where each block
# takes one tile), each with PIPELINE_STAGE_SLACK codes of room to land
# a tile at its 16-byte alignment, behind a 16-byte slot of barriers
PIPELINED_NEURONS_PER_THREAD = 16
PIPELINE_STAGES = 2
PIPELINE_STAGE_SLACK = 4
PIPELINE_BARRIER_BYTES = 16
# an SM's shared memory at the largest carveout (228 KB), CUDA's
# reservation per resident block, and the SM's thread, block and
# register limits
SM_SMEM_BYTES = 233_472
BLOCK_SMEM_RESERVED = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
SM_REGISTERS = 65_536
# SMs of the H100 SXM, the card the geometry is written for: the count a
# geometry is worked out for where no card is at hand (CPU tables)
H100_SM_COUNT = 132

ENC_U8, ENC_I32, ENC_INT4, ENC_NONE = 0, 1, 2, -1

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "lut_gather.cu")


class _LayerDesc(ctypes.Structure):
    """Mirror of ``struct LayerDesc`` in lut_gather.cu."""
    _fields_ = [("conn", ctypes.c_void_p), ("sub", ctypes.c_void_p),
                ("add", ctypes.c_void_p)] + \
        [(n, ctypes.c_int32) for n in (
            "n_in", "n_out", "A", "F", "in_bits", "sub_bits", "K", "Ka",
            "sub_enc", "add_enc", "pad0", "pad1")]


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.lut_desc_size.argtypes = []
    lib.lut_desc_size.restype = i
    lib.lut_layers_launch.argtypes = [vp, vp, i, vp, i, vp, vp, vp, i, vp]
    lib.lut_layers_launch.restype = i
    lib.lut_fused_launch.argtypes = [vp, vp, i, vp] + [i] * 9 + [vp]
    lib.lut_fused_launch.restype = i
    if lib.lut_desc_size() != ctypes.sizeof(_LayerDesc):
        raise RuntimeError("LayerDesc layout differs between "
                           "lut_gather.cu and lut_gather.py")


LIBRARY = KernelLibrary(SOURCE, ("lut_gather", "lut_network_fused",
                                 "lut_network_fused_pipelined"), _bind)
build = LIBRARY.load
reset_launch_counts = LIBRARY.reset_counts
launch_counts = LIBRARY.counts


# ---------------------------------------------------------------------------
# validated layer arguments
# ---------------------------------------------------------------------------

def _pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _encoding(slab: torch.Tensor, packed: bool, what: str) -> int:
    if packed:
        if slab.dtype != torch.uint8:
            raise TypeError(f"{what}: int4-packed slab must be uint8")
        return ENC_INT4
    if slab.dtype == torch.uint8:
        return ENC_U8
    if slab.dtype == torch.int32:
        return ENC_I32
    raise TypeError(f"{what}: slab dtype {slab.dtype} (want uint8/int32)")


@dataclasses.dataclass(frozen=True)
class LayerArgs:
    """One layer's slabs and metadata, checked once for the kernels."""

    conn: torch.Tensor
    sub_table: torch.Tensor
    add_table: torch.Tensor
    in_bits: int
    sub_bits: int
    sub_packed: bool
    add_packed: bool
    n_in: int

    @property
    def n_out(self) -> int:
        return self.conn.shape[0]

    @property
    def use_adder(self) -> bool:
        return self.add_table.shape[-1] > 0

    @property
    def K(self) -> int:
        return self.sub_table.shape[-1] * (2 if self.sub_packed else 1)

    @property
    def Ka(self) -> int:
        return self.add_table.shape[-1] * (2 if self.add_packed else 1)

    def plain(self) -> tuple:
        """Positional arguments of ``ref.lut_layer`` after the codes."""
        return (self.conn, self.sub_table, self.add_table, self.in_bits,
                self.sub_bits, self.sub_packed, self.add_packed)

    def desc(self) -> _LayerDesc:
        n_out, A, F = self.conn.shape
        return _LayerDesc(
            self.conn.data_ptr(), self.sub_table.data_ptr(),
            self.add_table.data_ptr() if self.use_adder else 0,
            self.n_in, n_out, A, F, self.in_bits, self.sub_bits, self.K,
            self.Ka if self.use_adder else 1,
            _encoding(self.sub_table, self.sub_packed, "sub_table"),
            (_encoding(self.add_table, self.add_packed, "add_table")
             if self.use_adder else ENC_NONE), 0, 0)


def layer_args(conn, sub_table, add_table, in_bits: int, sub_bits: int,
               sub_packed: bool = False, add_packed: bool = False, *,
               n_in: int, check_conn: bool = False) -> LayerArgs:
    """Check one layer's slabs for the kernels and bundle them.
    Adder on/off is decided by the real ``add_table`` width before
    anything else; an adder-off layer's slab is never read or packed.
    ``check_conn`` also proves every fan-in index lies in [0, n_in)
    (one device sync — done once when an engine is built)."""
    if conn.dim() != 3 or sub_table.dim() != 3 or add_table.dim() != 2:
        raise ValueError("want conn (n_out, A, F), sub_table (n_out, A, K) "
                         "and add_table (n_out, Ka)")
    n_out, A, F = conn.shape
    use_adder = add_table.shape[-1] > 0
    a = LayerArgs(conn=conn, sub_table=sub_table, add_table=add_table,
                  in_bits=int(in_bits), sub_bits=int(sub_bits),
                  sub_packed=bool(sub_packed),
                  add_packed=bool(add_packed) and use_adder, n_in=int(n_in))
    dev = conn.device
    for name in ("conn", "sub_table", "add_table"):
        t = getattr(a, name)
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, conn on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if conn.dtype != torch.int32:
        raise TypeError("conn must be int32")
    if sub_table.shape[:2] != (n_out, A) or add_table.shape[0] != n_out:
        raise ValueError("slab shapes disagree with conn")
    _encoding(sub_table, a.sub_packed, "sub_table")
    if use_adder:
        _encoding(add_table, a.add_packed, "add_table")
    if not _pow2(a.K) or (use_adder and not _pow2(a.Ka)):
        raise ValueError(f"table widths must be powers of two "
                         f"(K={a.K}, Ka={a.Ka})")
    if a.in_bits * F > 30 or (use_adder and a.sub_bits * A > 30):
        raise ValueError("packed table address wider than 30 bits")
    if check_conn and conn.numel() and (
            int(conn.min()) < 0 or int(conn.max()) >= a.n_in):
        raise ValueError(f"conn indexes outside [0, {a.n_in})")
    return a


def _device_of(codes: torch.Tensor, tables: torch.device) -> torch.device:
    """The device a call runs on: the tables' and the codes' alike, the
    CPU (plain version) or a CUDA card (kernel)."""
    if codes.device != tables:
        raise ValueError(f"codes on {codes.device}, tables on {tables}")
    if tables.type not in ("cpu", "cuda"):
        raise ValueError(f"no LUT kernel for device {tables}")
    return tables


def _codes_arg(codes: torch.Tensor, n_in: int) -> torch.Tensor:
    """The one contract of every LUT wrapper's codes, checked before
    the device branch, so the CPU (plain version) and the card (kernel)
    accept and refuse the same input: (B, n_in) integer codes, cast to
    contiguous int32 as the reference's dtype rules cast them.  A width
    other than ``n_in`` raises ValueError and a float or bool dtype
    TypeError on both branches — stricter than the reference, whose
    engine ignores extra columns."""
    if codes.dim() != 2 or codes.shape[1] != n_in:
        raise ValueError(f"codes of shape {tuple(codes.shape)}, want "
                         f"(B, {n_in})")
    if codes.dtype.is_floating_point or codes.dtype.is_complex \
            or codes.dtype == torch.bool:
        raise TypeError(f"codes must be integers, got {codes.dtype}")
    return codes.to(torch.int32).contiguous()


def resident_blocks(threads: int, block_smem: int,
                    regs_per_thread: int = MAX_REGS_PER_THREAD) -> int:
    """Blocks of ``threads`` threads and ``block_smem`` bytes of dynamic
    shared memory that one SM holds at once: the least of its thread,
    register (at ``regs_per_thread``, a kernel's launch bound),
    shared-memory and block limits."""
    return max(1, min(MAX_THREADS_PER_SM // threads,
                      SM_REGISTERS // (regs_per_thread * threads),
                      SM_SMEM_BYTES // (block_smem + BLOCK_SMEM_RESERVED),
                      MAX_BLOCKS_PER_SM))


def _carveout(blocks_per_sm: int, block_smem: int) -> int:
    """Percent of the SM's 228 KB of shared memory that ``blocks_per_sm``
    resident blocks need; the rest of its 256 KB stays L1."""
    return min(100, -(-100 * blocks_per_sm * (block_smem
                                              + BLOCK_SMEM_RESERVED)
                      // SM_SMEM_BYTES))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# kernel 3: one layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """One launch of kernel 3: ``rows`` batch rows x ``ntile`` neurons a
    block, ``threads`` threads, ``row_tiles`` x ``neuron_tiles`` blocks,
    ``smem_bytes`` of dynamic shared memory a block (the rows' input
    codes; 0 when they do not fit and are read from device memory),
    ``blocks_per_sm`` meant to be resident and the ``carveout`` they
    need."""
    rows: int
    threads: int
    ntile: int
    row_tiles: int
    neuron_tiles: int
    smem_bytes: int
    blocks_per_sm: int
    carveout: int

    @property
    def grid(self) -> int:
        return self.row_tiles * self.neuron_tiles

    def launch_args(self) -> tuple:
        """The ints a layer that ``lut_layers_launch`` reads."""
        return (self.rows, self.threads, self.ntile, self.row_tiles,
                self.neuron_tiles, self.smem_bytes)


def layer_geometry(B: int, n_sms: int, n_in: int, n_out: int,
                   budget: int = SMEM_BUDGET_BYTES) -> LayerGeometry:
    """The launch geometry of kernel 3 for one layer of ``n_in`` ->
    ``n_out`` codes on a batch of ``B`` rows, on a card of ``n_sms`` SMs
    — a pure function of its arguments.

    GATHER_THREADS threads a block; rows per block as grid mode picks
    them (the power of two nearest B / (4 * #SMs), at least two once the
    batch gives each SM two rows), fewer if that many rows' codes would
    not fit ``budget``; a layer too wide for one row is read unstaged.
    The neurons split over several blocks only where the row tiles
    leave SMs idle and a thread would carry more than one pair of
    neurons: a 256-row batch through a 100-wide layer runs 128 blocks of
    2 rows, each with every neuron."""
    threads = GATHER_THREADS
    want = max(_pow2_nearest(B / (BLOCKS_PER_SM_TARGET * n_sms)),
               min(MIN_SHARED_ROWS, _pow2_nearest(B / n_sms)))
    rows = min(MAX_BLOCK_ROWS, threads, want,
               max(1, budget // (4 * max(1, n_in))))
    smem = 4 * rows * n_in
    if smem > budget:
        smem = 0                           # read the codes unstaged
    row_tiles = -(-int(B) // rows)
    pairs = -(-n_out // (2 * (threads // rows)))
    splits = max(1, min(n_sms // max(1, row_tiles), pairs))
    ntile = -(-n_out // splits)
    neuron_tiles = -(-n_out // ntile)
    grid = row_tiles * neuron_tiles
    resident = min(resident_blocks(threads, smem), -(-grid // n_sms))
    return LayerGeometry(rows=rows, threads=threads, ntile=ntile,
                         row_tiles=row_tiles, neuron_tiles=neuron_tiles,
                         smem_bytes=smem, blocks_per_sm=resident,
                         carveout=_carveout(resident, smem))


def _chain_args(geometries: Sequence[LayerGeometry]) -> tuple:
    """(the ints ``lut_layers_launch`` reads, the carveout the chain
    needs) for kernel 3's launches."""
    geo = (ctypes.c_int32 * (6 * len(geometries)))(
        *[v for g in geometries for v in g.launch_args()])
    return geo, max(g.carveout for g in geometries)


def _launch_layers(codes: torch.Tensor, descs, n_layers: int, chain: tuple,
                   widths: Sequence[int], wp: int, wq: int) -> torch.Tensor:
    """One host call: kernel 3 over ``n_layers`` layers whose host
    descriptors start at address ``descs``, launched as ``chain``
    (``_chain_args``) says, the hidden codes through two ping-pong
    buffers allocated here."""
    lib = build()
    dev = codes.device
    B = codes.shape[0]
    out = torch.empty((B, widths[-1]), dtype=torch.int32, device=dev)
    buf = (torch.empty((B * (wp + wq),), dtype=torch.int32, device=dev)
           if n_layers > 1 else None)
    ptr = 0 if buf is None else buf.data_ptr()
    geo, carveout = chain
    with torch.cuda.device(dev):
        rc = lib.lut_layers_launch(
            codes.data_ptr(), out.data_ptr(), B, descs, n_layers,
            ptr, ptr + 4 * B * wp, ctypes.addressof(geo), carveout,
            stream(dev))
    check_rc(rc, "lut_gather")
    LIBRARY.count("lut_gather", n_layers)
    return out


def lut_gather(codes: torch.Tensor, layer: LayerArgs) -> torch.Tensor:
    """codes (B, n_in) integers -> (B, n_out) int32 through one layer
    (codes as ``_codes_arg`` takes them)."""
    dev = _device_of(codes, layer.conn.device)
    codes = _codes_arg(codes, layer.n_in)
    if dev.type == "cpu":
        return ref.lut_layer(codes, *layer.plain())
    g = layer_geometry(codes.shape[0], _sm_count(dev.index), layer.n_in,
                       layer.n_out)
    d = layer.desc()
    return _launch_layers(codes, ctypes.addressof(d), 1, _chain_args([g]),
                          [layer.n_out], 0, 0)


# ---------------------------------------------------------------------------
# kernels 1 and 2: the fused network
# ---------------------------------------------------------------------------

def buffer_widths(widths: Sequence[int]):
    """(wP, wQ): widest hidden output of the even / odd layers (the last
    layer writes device memory and needs no buffer)."""
    hidden = list(widths[:-1])
    return (max(hidden[0::2], default=0), max(hidden[1::2], default=0))


def smem_bytes_per_row(n_in0: int, widths: Sequence[int],
                       pipeline: bool) -> int:
    """Shared memory one batch row claims in a fused block: its input
    codes (one slot, or two stages for the pipelined kernel) plus its P
    and Q hidden-layer buffers, int32 each."""
    wp, wq = buffer_widths(widths)
    return 4 * ((PIPELINE_STAGES if pipeline else 1) * n_in0 + wp + wq)


def _stage_codes(rows: int, n_in0: int) -> int:
    """Codes one stage of the pipelined kernel's ring holds: a tile,
    rounded up to 16 bytes, and the slack to land it at its alignment."""
    return -(-rows * n_in0 // 4) * 4 + PIPELINE_STAGE_SLACK


def fused_smem_bytes(n_in0: int, widths: Sequence[int], rows: int,
                     pipeline: bool, stages: int = PIPELINE_STAGES) -> int:
    """The ledger: shared memory of one fused block of ``rows`` rows,
    exactly what the kernel lays out (``rows`` times
    ``smem_bytes_per_row``, and for the pipelined kernel its barriers and
    the stages' rounding and slack, under 80 bytes a block).  The
    pipelined kernel's ledger counts its full ring; a launch whose blocks
    take one tile each lays out ``stages=1``, less."""
    if not pipeline:
        return rows * smem_bytes_per_row(n_in0, widths, False)
    wp, wq = buffer_widths(widths)
    return PIPELINE_BARRIER_BYTES + 4 * (
        stages * _stage_codes(rows, n_in0) + rows * (wp + wq))


def block_rows(n_in0: int, widths: Sequence[int], pipeline: bool,
               budget: int = SMEM_BUDGET_BYTES) -> int:
    """The ledger's cap on rows per block: as many as the budget holds,
    up to MAX_BLOCK_ROWS; 0 when not even one row fits."""
    rows = min(MAX_BLOCK_ROWS,
               budget // smem_bytes_per_row(n_in0, widths, pipeline))
    while rows > 0 and fused_smem_bytes(n_in0, widths, rows,
                                        pipeline) > budget:
        rows -= 1
    return rows


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """One fused launch: ``rows`` batch rows and ``threads`` threads per
    block, ``grid`` blocks each walking at most ``tiles`` tiles of rows
    (1 in grid mode), ``smem_bytes`` of dynamic shared memory a block
    (the ledger at ``rows`` and ``stages``), ``blocks_per_sm`` blocks
    meant to be resident on each SM, and the shared-memory ``carveout``
    (percent of the SM's 228 KB) they need; the rest of the SM's 256 KB
    is L1.  ``stages``: the pipelined kernel's input stages (0 in grid
    mode)."""
    rows: int
    threads: int
    grid: int
    smem_bytes: int
    blocks_per_sm: int
    carveout: int
    tiles: int = 1
    stages: int = 0


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def _pow2_nearest(x: float) -> int:
    """The power of two nearest to ``x`` on a log scale, at least 1."""
    return 1 << max(0, round(math.log2(x))) if x > 0 else 1


def _pow2_ceil(x: float) -> int:
    return 1 << max(0, math.ceil(math.log2(x))) if x > 1 else 1


def fused_geometry(B: int, n_sms: int, n_in0: int, widths: Sequence[int],
                   pipeline: bool, max_rows: Optional[int] = None,
                   rows: Optional[int] = None,
                   budget: int = SMEM_BUDGET_BYTES) -> FusedGeometry:
    """The launch geometry of a fused kernel for a batch of ``B`` rows on
    a card of ``n_sms`` SMs — a pure function of its arguments.

    The cap is the ledger's (``block_rows``), lowered to ``max_rows``
    when given (a plan's ``block_b``).  Grid mode takes FUSED_THREADS
    threads and the power of two of rows nearest B / (4 * #SMs), about
    four blocks per SM, but at least two once the batch gives each SM two
    rows, and never more than the cap or than lets four blocks share an
    SM's shared memory: HDR-Add2 runs 2 rows a block on 128 blocks at
    B=256, 8 rows on 512 blocks at B=4096, and one block at B=1.

    The pipelined kernel takes the power of two of rows nearest B / #SMs
    (about one block an SM), but no more than keep the widest layer at
    PIPELINED_NEURONS_PER_THREAD neurons a thread with
    MAX_PIPELINED_THREADS threads, and as many threads (at least
    PIPELINED_THREADS) as hold it there: HDR-Add2 runs 2 rows x 128
    threads on 128 blocks at B=256 and 16 x 256 on 256 blocks at
    B=4096; JSC-XL-Add2 (128 wide) 32 x 256 on 128 blocks at B=4096.
    Each block takes one tile, with one input stage, while the card
    holds a block for every tile; past that the grid is what the card
    holds resident, the tiles divided over it as evenly as they go, and
    where the two-stage ring costs no resident block each block's next
    tile arrives while it computes the current one.  ``rows`` overrides
    the choice of rows (within the budget)."""
    cap = block_rows(n_in0, widths, pipeline, budget)
    if max_rows is not None:
        cap = min(cap, int(max_rows))
    if rows is None:
        if cap < 1:
            raise ValueError(
                f"not one row fits a block's shared memory "
                f"({fused_smem_bytes(n_in0, widths, 1, pipeline)} > "
                f"{budget} bytes); split the network (ops.plan_segments)")
        if pipeline:
            by_width = PIPELINED_NEURONS_PER_THREAD * MAX_PIPELINED_THREADS \
                // max(widths)
            rows = max(1, min(cap, _pow2_nearest(B / n_sms),
                              _pow2_floor(by_width)))
        else:
            per_row = smem_bytes_per_row(n_in0, widths, False)
            fit = (SM_SMEM_BYTES // BLOCKS_PER_SM_TARGET
                   - BLOCK_SMEM_RESERVED) // per_row
            want = max(_pow2_nearest(B / (BLOCKS_PER_SM_TARGET * n_sms)),
                       min(MIN_SHARED_ROWS, _pow2_nearest(B / n_sms)))
            rows = max(1, min(cap, _pow2_floor(fit), want))
    rows = int(rows)
    threads = FUSED_THREADS
    if pipeline:
        threads = min(MAX_PIPELINED_THREADS, max(
            PIPELINED_THREADS, _pow2_ceil(
                rows * max(widths) / PIPELINED_NEURONS_PER_THREAD)))
    smem = fused_smem_bytes(n_in0, widths, rows, pipeline)
    if rows < 1 or smem > budget:
        raise ValueError(f"{rows} rows per block need {smem} bytes of "
                         f"shared memory (limit {budget}); split the "
                         f"network (ops.plan_segments)")
    most = MAX_PIPELINED_THREADS if pipeline else MAX_FUSED_THREADS
    if not rows <= threads <= most:
        raise ValueError(f"{rows} rows x {threads} threads: want rows <= "
                         f"threads <= {most}")
    n_tiles = -(-int(B) // rows)
    stages = 0
    if pipeline:
        # one tile a block while the card holds a block for each; the
        # second stage only where blocks walk several tiles and it costs
        # no resident block (more blocks in flight beat the overlap)
        one = fused_smem_bytes(n_in0, widths, rows, True, 1)
        tiles = max(1, -(-n_tiles // (resident_blocks(threads, one)
                                      * n_sms)))
        stages = 1
        if tiles > 1 and resident_blocks(threads, smem) == \
                resident_blocks(threads, one):
            stages = PIPELINE_STAGES
        smem = fused_smem_bytes(n_in0, widths, rows, True, stages)
        grid = -(-n_tiles // tiles)
    else:
        grid = n_tiles
    resident = min(resident_blocks(threads, smem), -(-grid // n_sms))
    return FusedGeometry(rows=rows, threads=threads, grid=grid,
                         smem_bytes=smem, blocks_per_sm=resident,
                         carveout=_carveout(resident, smem),
                         tiles=-(-n_tiles // max(1, grid)), stages=stages)


class FusedNet:
    """A chain of layers ready for the kernels: the checked layer
    arguments and, on a CUDA device, the layers' descriptors in host
    memory (kernel 3 takes each by value) and, built at the first fused
    launch, in device memory (the fused kernels read them there); both
    hold the slabs' addresses, so the layers are kept alive here."""

    def __init__(self, layers: Sequence[LayerArgs]):
        self.layers: List[LayerArgs] = list(layers)
        if not self.layers:
            raise ValueError("a fused network needs at least one layer")
        for prev, nxt in zip(self.layers, self.layers[1:]):
            if nxt.n_in != prev.n_out:
                raise ValueError("layer widths do not chain")
        self.device = self.layers[0].conn.device
        self.n_in0 = self.layers[0].n_in
        self.widths = [a.n_out for a in self.layers]
        self.wp, self.wq = buffer_widths(self.widths)
        self.host_desc = None
        self._desc = None
        self._geometry, self._chain = {}, {}
        self.n_sms = 0
        if self.device.type == "cuda":
            self.host_desc = (_LayerDesc * len(self.layers))(
                *[a.desc() for a in self.layers])
            self.n_sms = _sm_count(self.device.index)

    @property
    def desc(self) -> torch.Tensor:
        """The descriptor array in device memory (built at first use).
        The copy from host memory may still be in flight when the call
        returns, and a net may be launched from several streams (the
        shards of a mesh on one card), so the first build waits for it."""
        if self._desc is None:
            desc = torch.frombuffer(bytearray(bytes(self.host_desc)),
                                    dtype=torch.uint8).to(self.device)
            torch.cuda.current_stream(self.device).synchronize()
            self._desc = desc
        return self._desc

    def rows(self, pipeline: bool, budget: int = SMEM_BUDGET_BYTES) -> int:
        """The ledger's cap on rows per block."""
        return block_rows(self.n_in0, self.widths, pipeline, budget)

    def geometry(self, B: int, pipeline: bool,
                 max_rows: Optional[int] = None,
                 rows: Optional[int] = None) -> FusedGeometry:
        """``fused_geometry`` for a batch of ``B`` rows on this card
        (remembered for each batch size: a server's calls repeat a few)."""
        key = (B, pipeline, max_rows, rows)
        g = self._geometry.get(key)
        if g is None:
            g = self._geometry[key] = fused_geometry(
                B, self.n_sms, self.n_in0, self.widths, pipeline,
                max_rows=max_rows, rows=rows)
        return g

    def layer_geometries(self, B: int) -> List[LayerGeometry]:
        """``layer_geometry`` of each layer for a batch of ``B`` rows."""
        return [layer_geometry(B, self.n_sms, a.n_in, a.n_out)
                for a in self.layers]

    def chain(self, B: int) -> tuple:
        """``_chain_args`` of kernel 3 over every layer for a batch of
        ``B`` rows (remembered for each batch size)."""
        c = self._chain.get(B)
        if c is None:
            c = self._chain[B] = _chain_args(self.layer_geometries(B))
        return c


def lut_layers(codes: torch.Tensor, net: FusedNet) -> torch.Tensor:
    """codes (B, n_in0) integers -> (B, n_out_last) int32 through every
    layer of ``net`` by kernel 3, one launch a layer, all from one host
    call (the ``per_layer`` plan's forward)."""
    dev = _device_of(codes, net.device)
    codes = _codes_arg(codes, net.n_in0)
    if dev.type == "cpu":
        return ref.lut_network(codes, [a.plain() for a in net.layers])
    return _launch_layers(codes, ctypes.addressof(net.host_desc),
                          len(net.layers), net.chain(codes.shape[0]),
                          net.widths, net.wp, net.wq)


def lut_network_fused(codes: torch.Tensor, net: FusedNet,
                      rows: Optional[int] = None, pipeline: bool = False,
                      max_rows: Optional[int] = None) -> torch.Tensor:
    """codes (B, n_in0) integers -> (B, n_out_last) int32 through every
    layer of ``net`` in one launch (codes as ``_codes_arg`` takes them).  The geometry comes from
    ``fused_geometry`` for this batch, within ``max_rows`` and the
    ledger; ``rows`` forces the rows per block."""
    dev = _device_of(codes, net.device)
    codes = _codes_arg(codes, net.n_in0)
    if dev.type == "cpu":
        return ref.lut_network(codes, [a.plain() for a in net.layers])
    return _launch_fused(codes, net, net.geometry(
        codes.shape[0], pipeline, max_rows=max_rows, rows=rows))


def _launch_fused(codes: torch.Tensor, net: FusedNet,
                  g: FusedGeometry) -> torch.Tensor:
    """One launch of kernel 1 (``g.stages == 0``) or kernel 2 over every
    layer of ``net``, as ``g`` says."""
    lib = build()
    B = codes.shape[0]
    out = torch.empty((B, net.widths[-1]), dtype=torch.int32,
                      device=net.device)
    with torch.cuda.device(net.device):
        rc = lib.lut_fused_launch(
            codes.data_ptr(), out.data_ptr(), B, net.desc.data_ptr(),
            len(net.layers), g.rows, g.threads, net.wp, net.wq,
            g.smem_bytes, g.stages, g.grid, g.carveout,
            stream(net.device))
    name = ("lut_network_fused_pipelined" if g.stages
            else "lut_network_fused")
    check_rc(rc, name)
    LIBRARY.count(name)
    return out
