#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the three CUDA kernel libraries (LUT, WKV6, masked
             matmul) from the checkout's sources, one nvcc each, all
             started together; print the build seconds, nvcc's
             ``-Xptxas -v`` report and each kernel's registers and spill
             bytes.
3. golden  — load ``tests/golden/`` (packed and unpacked): every kernel
             reproduces ``golden_io.npz["outputs"]`` exactly and the
             recomputed artifact id matches.
4. width   — HDR-Add2 (MNIST 784 -> 256,100x4,10, F=4, A=2) and
             JSC-XL-Add2 (7-bit inputs, 4096-entry adder tables) tables
             drawn from a numpy seed: each kernel equals its plain
             PyTorch version on the card bit for bit, at B=4096, a
             ragged B=1000, the registry's B=256 and B=1, slabs packed
             and unpacked, printing the geometry each kernel picks at each
             batch (the fused kernel's rows x threads / blocks, the
             pipelined one's and the tiles a block walks, the per-layer
             one's for each layer); timed at B=4096 and B=256 with CUDA
             events, the profiler's device clock and with the calls
             queued ahead of the card (``queued_ms``), against the plain
             version and the bytes bound.
5. serve   — the main path: HDR-Add2 saved as an artifact, served through
             ``ModelRegistry`` on ``cuda`` (~2000 Poisson requests, one
             hot-swap to a second seed mid-stream: 0 failed, 0 dropped,
             every answer equal to the plain forward of the version that
             answered), then the same artifact through the pipelined and
             per-layer plans of ``make_network_fn`` (the per-layer one a
             chain of kernel-3 launches from one host call).  Launch counts are
             zeroed just before and read just after; every kernel must
             have launched.
6. wkv     — the WKV6 kernel against its plain version
             (``wkv_chunked_ref`` at chunk 32, run on the card) at
             rwkv6-3b shapes: B=4 S=512 H=40 K=64 in
             bf16 and f32, one decode token (S=1) with a nonzero state, a
             ragged S=77, and every decay at the clamp (S=512; both must
             be finite); timed with CUDA events, on the device clock and
             queued, against the plain version and the bound.
7. masked_mm — the masked-matmul kernel against both plain versions at
             the kernels-bench layer (n_in 784, n_out 256, F 6) at
             B=1024 and B=4096; timed (CUDA events, device clock)
             against the plain gather, the dense ``torch.addmm`` form
             (the library call) and the bound; then its entry point (``ops.masked_matmul``) once
             at each batch, counts zeroed just before and read after.
8. lm      — rwkv6-3b at full width (32 layers, d_model 2560, vocab
             65536, bf16), weights from a fixed seed on the card, served
             through ``repro_torch.launch.serve``: a B=4 x 512-token
             prefill and 32 greedy decode steps, counts zeroed just
             before and read just after (32 x 33 WKV launches).  All
             logits finite.  The kernel path agrees with the plain WKV:
             in bf16 block by block on the same inputs (prefill and a
             decode step), and with the same weights in float32 over
             the whole model (prefill and 32 decode steps fed the same
             tokens).  A 64-token prefill leaves the state that 64
             single-token decode steps leave, block by block in bf16
             and over the whole float32 model.  A profiler trace of one
             prefill and two decode steps gives the device's busy and
             idle share and the WKV kernel's share of device time.

Output: a ``kernels`` JSON line (each kernel's ``ms`` by CUDA events
and ``device_ms`` on the device clock, beside its bound, plain and
library times, at the shape where its path launches it: the LUT kernels
at HDR-Add2's 256-row micro-batch with int4 slabs, WKV6 at the prefill
call), the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet): device memory bandwidth, and the
# fp32 rate outside the tensor cores, the closest listed rate for the
# kernels' integer shift/add/mask work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# the TPU kernels replaced: lut_network_fused_pallas (:467) in grid mode,
# its pipeline=True body _fused_pipelined_kernel (:386), and
# lut_gather_pallas (:280)
TPU_KERNEL = "src/repro/kernels/lut_gather/lut_gather.py"
CUDA_SOURCE = "src/repro_torch/kernels/lut_gather/csrc/lut_gather.cu"
KERNELS = {
    "lut_network_fused": dict(source=CUDA_SOURCE,
                              replaces=f"{TPU_KERNEL}:467"),
    "lut_network_fused_pipelined": dict(source=CUDA_SOURCE,
                                        replaces=f"{TPU_KERNEL}:386"),
    "lut_gather": dict(source=CUDA_SOURCE, replaces=f"{TPU_KERNEL}:280"),
}
LUT_KERNELS = tuple(KERNELS)
KERNELS.update({
    "masked_matmul": dict(
        source="src/repro_torch/kernels/masked_matmul/csrc/masked_matmul.cu",
        replaces="src/repro/kernels/masked_matmul/masked_matmul.py:59"),
    "wkv6": dict(source="src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                 replaces="src/repro/kernels/wkv6/wkv6.py:88"),
})

# Tolerances, each against the plain version on the same card:
# WKV6: both sides compute in float32 (bf16 inputs are widened exactly)
# but sum in another order; the reference's own kernel test bound,
# here relative to the largest magnitude of the output.
WKV_TOL = 2e-4
# masked matmul: F float32 products summed in another order
MM_RTOL = MM_ATOL = 1e-5
# rwkv6-3b, relative to the largest magnitude of what is compared.
# bf16, each block on the same inputs, kernel path vs plain WKV: the
# WKV outputs differ in float32 rounding only and flip a rare bf16
# rounding of the normed output; 2e-2 is about 5 bf16 ulps (2^-8) of
# the scale.  bf16, each block, 64-token prefill vs 64 decode steps:
# matmuls of 256 rows and of 4 rows round in bf16 at other places;
# 5e-2.  float32 weights, whole model (kernel vs plain WKV, and prefill
# vs decode steps): float32 roundings (1e-7) that 32 random-weight
# blocks amplify; 1e-3.
LM_KERNEL_TOL = 2e-2
LM_STATE_TOL = 5e-2
LM_F32_TOL = 1e-3
# bf16, whole model, prefill and every decode step: the kernel path's
# logits may part from the plain-WKV model's by at most twice what the
# plain-WKV model's own logits move when every input embedding value is
# nudged by one bf16 ulp (how far the model amplifies the smallest
# change the served dtype can make; the factor 2 allows for two draws
# of that amplification differing).
LM_NUDGE_SLACK = 2.0


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# networks drawn from a numpy seed
# ---------------------------------------------------------------------------

def random_tables(spec, seed: int, device):
    """Truth tables of ``spec``'s shapes with random contents: the codes
    each slab may hold, in the dtype synthesis would emit."""
    import torch
    from repro_torch.core.lut_synth import LayerTables, table_dtype_for

    rng = np.random.default_rng(seed)
    out = []
    for s in spec.layer_specs():
        A, F = s.adder_width, s.fan_in
        out_code_bits = 16 if s.is_output else s.out_quant.bits
        K = 2 ** (s.in_quant.bits * F)
        conn = rng.integers(0, s.n_in, (s.n_out, A, F)).astype(np.int32)
        if A > 1:
            sub_bits = s.sub_quant.bits
            sub_dt = table_dtype_for(sub_bits)
            Ka = 2 ** (A * sub_bits)
            add_dt = table_dtype_for(out_code_bits)
            add = rng.integers(0, 2 ** out_code_bits, (s.n_out, Ka))
        else:
            sub_bits = out_code_bits
            sub_dt = table_dtype_for(sub_bits)
            add_dt = sub_dt
            add = np.zeros((s.n_out, 0))
        sub = rng.integers(0, 2 ** sub_bits, (s.n_out, A, K))

        def t(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype=dt, device=device)

        out.append(LayerTables(
            conn=t(conn, torch.int32), sub_table=t(sub, sub_dt),
            add_table=t(add, add_dt), in_bits=s.in_quant.bits,
            sub_bits=sub_bits, out_bits=s.out_quant.bits, fan_in=F,
            adder_width=A, is_output=s.is_output, out_quant=s.out_quant,
            sub_quant=s.sub_quant, table_dtype=sub_dt))
    return out


def random_codes(rng, B: int, n_in: int, bits: int, device):
    import torch
    return torch.from_numpy(
        rng.integers(0, 2 ** bits, (B, n_in)).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, inputs, iters: int = 40, warm: int = 3) -> float:
    """Mean ms per call over ``iters`` calls with CUDA events, cycling
    through ``inputs`` (together larger than the 50 MB L2, so every call
    reads its codes from device memory as a server's fresh batch does)."""
    import torch
    for i in range(warm):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(fn):
    """Run ``fn`` once under ``torch.profiler`` -> (host wall ms, {kernel
    name: (device ms, launches)}): the card's own clock for each kernel,
    so host time between launches is not counted.  A kernel's ms is the
    length of the union of its launches' intervals: launches that
    overlap (a programmatic dependent launch starts before the launch
    it waits on ends) count once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    per = {}
    for name, iv in spans.items():
        us, reach = 0.0, float("-inf")
        for a, b in sorted(iv):
            us += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        per[name] = (us / 1e3, len(iv))
    return wall, per


def device_ms(fn, inputs, kernel: str = "", per_call=1, iters: int = 20,
              tries: int = 3):
    """Mean device time per call of the kernels whose name contains
    ``kernel`` that ``fn`` launches, over ``iters`` calls cycling through
    ``inputs`` (profiler trace, the card's own clock).  The trace must
    hold exactly ``iters * per_call`` such kernels (any number above 0
    when ``per_call`` is None, for a library call whose kernels are not
    ours): one that misses some is taken again, up to ``tries`` times,
    and then the time is None (not measured), never a partial sum."""
    fn(inputs[0])
    for _ in range(tries):
        _, per = profile_kernels(
            lambda: [fn(inputs[i % len(inputs)]) for i in range(iters)])
        hits = [(ms, n) for name, (ms, n) in per.items() if kernel in name]
        n = sum(n for _, n in hits)
        if n == iters * per_call if per_call is not None else n > 0:
            return sum(ms for ms, _ in hits) / iters
        log(f"[trace] {kernel}: {n} of {iters * per_call} launches in the "
            f"trace ({sum(k for _, k in per.values())} kernels of "
            f"{len(per)} names); tracing again")
    return None


def queued_ms(fn, inputs, iters: int = 20, spin_s: float = 0.02) -> float:
    """Mean time per call on the card with the host out of the way: a spin
    kernel (``torch.cuda._sleep``) holds the stream while ``iters`` calls
    are queued behind it, then CUDA events bracket the calls, which the
    card runs back to back (gaps between launches included).  Valid only
    if the spin was still running when the last call was queued; else
    the spin is doubled and the calls queued again."""
    import torch
    fn(inputs[0])
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2.0e9))   # >= spin_s at <= 2 GHz
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_s *= 2
    raise AssertionError("the host could not queue the calls ahead of "
                         "the card")


def slab_bytes(tables) -> int:
    return sum(t.conn.numel() * 4 + t.sub_table.numel()
               * t.sub_table.element_size() + t.add_table.numel()
               * t.add_table.element_size() for t in tables)


def layer_ops(t) -> int:
    """Integer ops per output code: per sub-neuron F shift+add pairs,
    the mask and the slab read's address arithmetic; the adder's A
    shift+add pairs, mask and read."""
    n_out, A, F = t.conn.shape
    per = A * (2 * F + 3) + (2 * A + 2 if t.add_table.shape[-1] else 0)
    return n_out * per


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def bound_ms(nbytes: int, ops: int):
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / ALU_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.lut_gather import lut_gather as LG
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.wkv6 import wkv6 as W
    libs = [LG.LIBRARY, W.LIBRARY, MM.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(lib.load) for lib in libs]:
            fut.result()
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    log(f"[build] {len(libs)} libraries in {secs:.2f} s")
    for lib in libs:
        log(f"[build] {lib.name}: {lib.info['seconds']:.2f} s -> "
            f"{lib.info['path']}")
        for line in str(lib.info["log"]).splitlines():
            log(f"[build] {line}")
        regs = ptxas_registers(str(lib.info["log"]))
        log(f"[build] {lib.name} registers (spill stores/loads bytes): "
            + ", ".join(f"{k} {r} ({st}/{ld})"
                        for k, (r, st, ld) in regs.items()))
        out[lib.name] = {"seconds": lib.info["seconds"],
                         "ptxas": lib.info["log"], "registers": regs}
    return out


def ptxas_registers(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    nvcc's ``-Xptxas -v`` report, for each entry function (kernel),
    named by its unmangled identifier."""
    import re
    out, fn, props, props_of = {}, None, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props_of = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            props[props_of] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
            fn = None

    def name(mangled):
        m = re.match(r"_Z(\d+)(\w+)", mangled)
        return m.group(2)[:int(m.group(1))] if m else mangled

    return {name(k): (r, *props.get(k, (0, 0))) for k, r in out.items()}


def _engines(tables, n_in0):
    """The three kernels as whole-network functions: fused grid, fused
    pipelined, and the per-layer chain as the ``per_layer`` plan runs it
    (``make_network_fn(fused=False)``: kernel 3 once a layer) — and the
    plain version."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    args = ops._layer_args(tables, n_in0, check_conn=True)
    net = K.FusedNet(args)
    per_layer = ops.make_network_fn(tables, n_in0=n_in0, fused=False,
                                    device=args[0].conn.device)
    return {
        "lut_network_fused": lambda c: K.lut_network_fused(c, net),
        "lut_network_fused_pipelined":
            lambda c: K.lut_network_fused(c, net, pipeline=True),
        "lut_gather": per_layer,
        "plain": lambda c: ref.lut_network(c, [a.plain() for a in args]),
    }, args


def phase_golden(dev):
    import hashlib
    import torch
    from repro_torch.artifact import load_artifact, verify_artifact
    io = np.load(os.path.join(GOLDEN, "golden_io.npz"))
    want = torch.from_numpy(io["outputs"]).to(dev)
    codes = torch.from_numpy(io["inputs"]).to(dev)
    manifest = verify_artifact(GOLDEN)
    recomputed = hashlib.sha256(json.dumps(
        {"layers": manifest["layers"], "slabs": manifest["slabs"]},
        sort_keys=True).encode()).hexdigest()
    check(recomputed == str(io["artifact_id"]) == manifest["artifact_id"],
          "golden artifact id does not recompute")
    for unpack in (True, False):
        art = load_artifact(GOLDEN, unpack_int4=unpack, device=dev)
        check(unpack or any(t.sub_packed for t in art.tables),
              "packed golden load has no packed slab")
        engines, _ = _engines(art.tables, art.n_in)
        for name, fn in engines.items():
            got = fn(codes)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"golden: {name} (unpack_int4={unpack}) differs")
    log(f"[golden] id {recomputed[:12]} recomputed; 3 kernels + plain "
        f"reproduce {tuple(want.shape)} outputs, packed and unpacked")


# batch sizes held bit for bit against the plain version: offline
# scoring, a ragged batch, the registry's micro-batch, one request
WIDTH_BATCHES = (4096, 1000, 256, 1)
# the fused kernels' symbols, as the profiler names them
LUT_SYMBOLS = {"lut_network_fused": "lut_fused_kernel",
               "lut_network_fused_pipelined": "lut_fused_pipelined_kernel",
               "lut_gather": "lut_gather_kernel"}


def phase_width(dev, results):
    import torch
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.lut_synth import pack_tables_int4
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref

    rng = np.random.default_rng(2024)
    errs = {}
    for spec, seed in ((PM.hdr_add2(), 11), (PM.jsc_xl_add2(), 12)):
        base = random_tables(spec, seed, dev)
        bits0 = spec.layer_specs()[0].in_quant.bits
        for packed in (False, True):
            tables = pack_tables_int4(base) if packed else base
            engines, args = _engines(tables, spec.in_features)
            net = K.FusedNet(args)
            for B in WIDTH_BATCHES:
                codes = random_codes(rng, B, spec.in_features, bits0, dev)
                want = engines["plain"](codes)
                for name in LUT_KERNELS:
                    got = engines[name](codes)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    errs[name] = max(errs.get(name, 0), err)
                    check(err == 0 and got.shape == want.shape,
                          f"{spec.name} packed={packed} B={B}: {name} "
                          f"differs from its plain version")
                # kernel 3 layer by layer against ref.lut_layer
                c = codes
                for a in args:
                    got = K.lut_gather(c, a)
                    w = ref.lut_layer(c, *a.plain())
                    torch.cuda.synchronize()
                    err = max_abs_err(got, w)
                    errs["lut_gather"] = max(errs["lut_gather"], err)
                    check(err == 0, f"{spec.name} lut_gather layer "
                          f"differs from ref.lut_layer")
                    c = w
            log(f"[width] {spec.name} packed={packed}: 3 kernels == plain "
                f"at B={list(WIDTH_BATCHES)}")
        for line in geometry_lines(net):
            log(f"[width] {spec.name} {line}")
    time_lut(dev, results, rng)
    # the kernels line: the shape at which the serve phase launches them
    # (time_lut holds every timed shape to an error of 0)
    for name in LUT_KERNELS:
        main = results[f"{name}_int4_b256"]
        results[name] = dict(main, max_abs_err=max(errs[name],
                                                   main["max_abs_err"]))


def geometry_lines(net, batches=WIDTH_BATCHES):
    """What each LUT kernel launches at each batch: kernel 1 rows x
    threads / blocks; kernel 2 rows x threads / blocks x tiles a block;
    kernel 3, per layer, rows x threads x neurons / row tiles x neuron
    tiles, with "u" where the codes are read unstaged."""
    out = []
    for B in batches:
        g1, g2 = net.geometry(B, False), net.geometry(B, True)
        g3 = net.layer_geometries(B)
        out.append(
            f"B={B}: fused {g1.rows}x{g1.threads}/{g1.grid}; pipelined "
            f"{g2.rows}x{g2.threads}/{g2.grid}x{g2.tiles} (cap "
            f"{net.rows(True)} rows); per-layer " + " ".join(
                f"{g.rows}x{g.threads}x{g.ntile}/{g.row_tiles}x"
                f"{g.neuron_tiles}{'' if g.smem_bytes else 'u'}"
                for g in g3))
    return out


# the networks and batches timed: offline scoring and the registry's
# micro-batch, for the model the serve phase runs and the widest one
TIMED_NETS = (("", "hdr_add2", 11), ("jsc_xl_add2_", "jsc_xl_add2", 12))
TIMED_BATCHES = (4096, 256)


def time_lut(dev, results, rng):
    """HDR-Add2 and JSC-XL-Add2 at B=4096 (offline scoring) and at the
    registry's micro-batch of 256, slabs unpacked (uint8/int32) and
    int4-packed (as the registry loads them), each kernel first held
    against the plain version on the timed inputs: CUDA events over
    back-to-back calls (host time included), the profiler's device clock,
    and the card's time with the calls queued ahead (``queued_ms``).
    Keys: ``[jsc_xl_add2_]<kernel>_<u8|int4>_b<B>``."""
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.lut_synth import pack_tables_int4

    for prefix, model, seed in TIMED_NETS:
        spec = getattr(PM, model)()
        n_in0, widths = spec.in_features, list(spec.widths)
        bits0 = spec.layer_specs()[0].in_quant.bits
        dims = [n_in0] + widths
        base = random_tables(spec, seed, dev)
        for B in TIMED_BATCHES:
            # together larger than the 50 MB L2 at B=4096
            inputs = [random_codes(rng, B, n_in0, bits0, dev)
                      for _ in range(8)]
            for packed in (True, False):
                tables = pack_tables_int4(base) if packed else base
                engines, args = _engines(tables, n_in0)
                slabs = slab_bytes(tables)
                ops = B * sum(layer_ops(t) for t in tables)
                fused_bytes = 4 * B * (n_in0 + widths[-1]) + slabs
                per_layer_bytes = sum(4 * B * (dims[i] + dims[i + 1])
                                      for i in range(len(widths))) + slabs
                want = engines["plain"](inputs[0])
                plain_ms = time_ms(engines["plain"], inputs, iters=10)
                for name, nbytes, launches in (
                        ("lut_network_fused", fused_bytes, 1),
                        ("lut_network_fused_pipelined", fused_bytes, 1),
                        ("lut_gather", per_layer_bytes, len(tables))):
                    err = max_abs_err(engines[name](inputs[0]), want)
                    check(err == 0, f"[width] {spec.name} {name} B={B} "
                          f"int4={packed} differs from its plain version")
                    ms = time_ms(engines[name], inputs)
                    dms = device_ms(engines[name], inputs,
                                    LUT_SYMBOLS[name], launches)
                    qms = queued_ms(engines[name], inputs)
                    bms, by = bound_ms(nbytes, ops)
                    key = (f"{prefix}{name}_{'int4' if packed else 'u8'}"
                           f"_b{B}")
                    results[key] = dict(
                        ms=ms, device_ms=dms, queued_ms=qms,
                        plain_ms=plain_ms, bound_ms=bms, max_abs_err=err,
                        bound_by=by, bytes=nbytes, ops=ops,
                        launches_per_forward=launches, batch=B, int4=packed,
                        model=spec.name)
                    dtxt = ("not measured" if dms is None
                            else f"{dms:.4f} ms")
                    log(f"[width] time {spec.name} {name} int4={packed}: "
                        f"{ms:.4f} ms/forward at B={B} ({launches} "
                        f"launch/forward; device {dtxt}, queued {qms:.4f} "
                        f"ms), plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
                        f"({by}: {nbytes} B, {ops} ops)")


def phase_serve(dev, results):
    import torch
    from repro_torch.artifact import load_artifact, save_artifact
    from repro_torch.configs import paper_models as PM
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.registry import ModelRegistry

    spec = PM.hdr_add2()
    n_req, rate = 2000, 4000.0
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4, (n_req, spec.in_features)).astype(np.int32)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        paths, want = [], {}
        for seed in (21, 22):
            tables = random_tables(spec, seed, dev)
            path = save_artifact(tmp, tables, name=f"hdr-add2-s{seed}",
                                 spec=spec)
            art = load_artifact(path, device=dev)
            plain = ref.lut_network(
                torch.from_numpy(rows).to(dev),
                [a.plain() for a in ops._layer_args(art.tables,
                                                    art.n_in)])
            want[art.artifact_id] = plain.cpu().numpy()
            paths.append(path)

        reg = ModelRegistry(microbatch=256, deadline_s=2e-3, device=dev)
        reg.register("hdr-add2", paths[0])   # warm-up builds + launches
        plan = reg.get("hdr-add2").plan
        log(f"[serve] registered {os.path.basename(paths[0])}: "
              f"{plan.describe()}")
        swap_report = {}

        def swapper():
            time.sleep(n_req / rate / 2)
            swap_report["r"] = reg.swap("hdr-add2", paths[1])

        # ---- the main path: counts zeroed just before, read just after
        K.reset_launch_counts()
        th = threading.Thread(target=swapper)
        th.start()
        handles = replay_open_loop(reg.client("hdr-add2"), rows, rate=rate,
                                   seed=3, timeout_s=120.0)
        th.join(timeout=120.0)
        check(not th.is_alive(), "swap did not finish")
        served_counts = K.launch_counts()
        # the pipelined and per-layer plans, on the same artifact
        art = load_artifact(paths[1], unpack_int4=False, device=dev)
        x = torch.from_numpy(rows).to(dev)
        for kw in ({"pipeline": True}, {"fused": False}):
            fn = ops.make_network_fn(art, device=dev, **kw)
            for lo in range(0, n_req, 256):
                got = fn(x[lo:lo + 256]).cpu().numpy()
                check(np.array_equal(got, want[art.artifact_id][lo:lo + 256]),
                      f"make_network_fn({kw}) differs from plain forward")
        counts = K.launch_counts()
        # ----
        stats = reg.stats()["hdr-add2"]
        reg.close()

    failed = sum(1 for h in handles if h is None or h.failed)
    check(len(handles) == n_req and failed == 0,
          f"{failed} of {n_req} requests failed or were dropped")
    tags = {}
    for i, h in enumerate(handles):
        check(h.tag in want, f"request {i} answered by unknown tag {h.tag}")
        check(np.array_equal(h.result(timeout=1.0), want[h.tag][i]),
              f"request {i} differs from the plain forward of {h.tag[:12]}")
        tags[h.tag] = tags.get(h.tag, 0) + 1
    check(len(tags) == 2, f"the swap did not land mid-stream: {tags}")
    check(served_counts["lut_network_fused"] > 0,
          "the registry served without launching the fused kernel")
    for name in LUT_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the "
              f"main path")
    p50, p99 = latency_percentiles_ms(handles, qs=(50, 99))
    r = swap_report["r"]
    log(f"[serve] {n_req} requests at {rate:.0f}/s: 0 failed, 0 dropped, "
        f"answers by version {[(k[:12], v) for k, v in tags.items()]}, "
        f"p50 {p50:.3f} ms p99 {p99:.3f} ms, swap warm "
        f"{r.warm_s * 1e3:.2f} ms blackout {r.blackout_s * 1e6:.1f} us, "
        f"flushes {stats['flushes']}")
    log(f"[serve] launches on the main path: {counts}")
    results["_serve"] = dict(requests=n_req, rate=rate, p50_ms=p50,
                             p99_ms=p99, tags=tags, swap_warm_s=r.warm_s,
                             swap_blackout_s=r.blackout_s,
                             served_counts=served_counts, counts=counts)
    return counts


def _rel_err(got, want):
    """(max |got - want|, that over max |want|), both as floats."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def wkv_inputs(dev, B, S, H, K, dtype, seed, clamp=False, with_s0=True):
    """RWKV6 time-mix inputs as the LM makes them: r, k, v ~ N(0, 1) in
    ``dtype``, log-decays -exp(-1.5 + 0.5 N) clamped at -1 in float32
    (or all at the clamp), bonus 0.1 N, state N(0, 1) or None."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = (n(B, S, H, K).to(dtype) for _ in range(3))
    logw = (torch.full((B, S, H, K), -1.0, device=dev) if clamp else
            torch.clamp(-torch.exp(-1.5 + 0.5 * n(B, S, H, K)), min=-1.0))
    s0 = n(B, H, K, K) if with_s0 else None
    return r, k, v, logw, 0.1 * n(H, K), s0


def wkv_bound(r, s0):
    """(bound ms, by, bytes, flops) of one WKV call: r, k, v in their
    dtype, logw, u and s0 in float32 read once, o and the final state
    written once; 4 K^2 flops per token and head (two K x K FMAs)."""
    B, S, H, K = r.shape
    n = B * S * H * K
    nbytes = 3 * n * r.element_size() + 4 * n + 4 * H * K + \
        (4 * B * H * K * K if s0 is not None else 0) + 4 * n + \
        4 * B * H * K * K
    flops = 4 * B * S * H * K * K
    bms, by = bound_ms(nbytes, flops)
    return bms, by, nbytes, flops


WKV_CASES = [  # name, shape at (B, S, H, K), dtype, clamp, with_s0
    ("prefill_bf16", "BSHK", "bfloat16", False, False),
    ("prefill_f32", "BSHK", "float32", False, False),
    ("decode_bf16", "B1HK", "bfloat16", False, True),
    ("ragged_f32", "B77HK", "float32", False, True),
    ("clamp_bf16", "BSHK", "bfloat16", True, False),
]


def _wkv_cases(B, S, H, K):
    import torch
    shapes = {"BSHK": (B, S, H, K), "B1HK": (B, 1, H, K),
              "B77HK": (B, 77, H, K)}
    return [(name, shapes[sh], getattr(torch, dt), clamp, s0)
            for name, sh, dt, clamp, s0 in WKV_CASES]


def phase_wkv(dev, results, B=4, S=512, H=40, K=64):
    """At rwkv6-3b's shapes by default (smaller ones rehearse it): the
    kernel against the plain version, then timed."""
    import torch
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.models.recurrent import WKV_CHUNK, wkv_chunked_ref

    max_abs = 0.0
    for i, (name, shape, dtype, clamp, with_s0) in enumerate(
            _wkv_cases(B, S, H, K)):
        args = wkv_inputs(dev, *shape, dtype, seed=100 + i, clamp=clamp,
                          with_s0=with_s0)
        want_o, want_s = wkv_chunked_ref(*args, chunk=WKV_CHUNK)
        want_finite = bool(torch.isfinite(want_o).all()
                           and torch.isfinite(want_s).all())
        o, s = ops.wkv6(*args)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(o).all() and torch.isfinite(s).all())
        check(finite and want_finite,
              f"[wkv] {name}: non-finite output (kernel {finite}, plain "
              f"{want_finite})")
        (eo, ro), (es, rs) = _rel_err(o, want_o), _rel_err(s, want_s)
        max_abs = max(max_abs, eo, es)
        log(f"[wkv] {name} {shape} {str(dtype)[6:]}: kernel vs plain "
            f"(chunk {WKV_CHUNK}) max abs err o {eo:.3e} s {es:.3e}, "
            f"relative to scale o {ro:.3e} s {rs:.3e} (tolerance "
            f"{WKV_TOL})")
        check(ro <= WKV_TOL and rs <= WKV_TOL,
              f"[wkv] {name}: kernel differs from its plain version")
        results[f"wkv6_{name}"] = dict(err_o=eo, err_s=es, rel_o=ro,
                                       rel_s=rs, shape=shape,
                                       dtype=str(dtype))
    time_wkv(dev, results, B, S, H, K)
    main = results["wkv6_prefill_bf16"]
    results["wkv6"] = dict(ms=main["ms"], device_ms=main["device_ms"],
                           plain_ms=main["plain_ms"],
                           bound_ms=main["bound_ms"],
                           bound_by=main["bound_by"], max_abs_err=max_abs,
                           library_ms=None)


def time_wkv(dev, results, B=4, S=512, H=40, K=64):
    """The LM's WKV calls: the B x S prefill (bf16 and float32 r/k/v) and
    one decode token with a state, by CUDA events, the profiler's device
    clock and ``queued_ms``, against the plain version and the bound."""
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.models.recurrent import wkv_chunked_ref

    for name in ("prefill_bf16", "prefill_f32", "decode_bf16"):
        _, shape, dtype, clamp, with_s0 = next(
            c for c in _wkv_cases(B, S, H, K) if c[0] == name)
        args = wkv_inputs(dev, *shape, dtype, seed=7, with_s0=with_s0)
        default = lambda a: ops.wkv6(*a)            # noqa: E731
        ms = time_ms(default, [args], iters=20)
        dms = device_ms(default, [args], "wkv6_kernel")
        qms = queued_ms(default, [args])
        plain_ms = time_ms(lambda a: wkv_chunked_ref(*a), [args], iters=5,
                           warm=1)
        bms, by, nbytes, flops = wkv_bound(args[0], args[5])
        r = results.setdefault(f"wkv6_{name}", {})
        r.update(ms=ms, device_ms=dms, queued_ms=qms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
        dtxt = "not measured" if dms is None else f"{dms:.4f} ms"
        rtxt = "" if dms is None else f" ({dms / bms:.1f}x on the device " \
            f"clock)"
        log(f"[wkv] time {name} {shape}: kernel {ms:.4f} ms (device "
            f"{dtxt}, queued {qms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bms:.5f} ms ({by}: {nbytes} B, {flops} flops), "
            f"{ms / bms:.1f}x the bound{rtxt}")


def phase_masked_mm(dev, results, batches=(1024, 4096)):
    import torch
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.masked_matmul import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # the dense oracle
    n_in, n_out, F = 784, 256, 6                    # kernels-bench layer
    g = torch.Generator(device=dev).manual_seed(44)
    conn = torch.randint(0, n_in, (n_out, F), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.randn((n_out, F), generator=g, device=dev)
    bias = torch.randn((n_out,), generator=g, device=dev)
    dense = ref.dense_weights(conn, w, n_in)
    cols = int(torch.unique(conn).numel())
    max_abs = 0.0
    xs_of = {}
    for B in batches:
        # rotating inputs, together larger than the 50 MB L2
        xs = [torch.randn((B, n_in), generator=g, device=dev)
              for _ in range(-(-64 * 2 ** 20 // (4 * B * n_in)))]
        xs_of[B] = xs[0]
        got = ops.masked_matmul(xs[0], conn, w, bias)
        for form, want in (
                ("gather", ref.masked_matmul(xs[0], conn, w, bias)),
                ("dense", ref.masked_matmul_dense(xs[0], conn, w, n_in,
                                                  bias))):
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_abs = max(max_abs, err)
            ok = torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL)
            log(f"[masked_mm] B={B}: kernel vs plain {form} max abs err "
                f"{err:.3e} (rtol {MM_RTOL}, atol {MM_ATOL}: "
                f"{'ok' if ok else 'FAIL'})")
            check(ok, f"[masked_mm] B={B}: kernel differs from the plain "
                  f"{form} form")
        ms = time_ms(lambda x: ops.masked_matmul(x, conn, w, bias), xs)
        plain_ms = time_ms(lambda x: ref.masked_matmul(x, conn, w, bias),
                           xs, iters=20)
        library_ms = time_ms(lambda x: torch.addmm(bias, x, dense), xs)
        dms = device_ms(lambda x: ops.masked_matmul(x, conn, w, bias), xs,
                        "masked_mm_kernel")
        library_dms = device_ms(lambda x: torch.addmm(bias, x, dense), xs,
                                per_call=None)
        nbytes = 4 * B * cols + 2 * 4 * n_out * F + 4 * n_out + \
            4 * B * n_out
        flops = 2 * B * n_out * F + B * n_out
        bms, by = bound_ms(nbytes, flops)
        results[f"masked_matmul_b{B}"] = dict(
            ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=library_dms, bound_ms=bms,
            bound_by=by, bytes=nbytes, flops=flops, columns_read=cols,
            rows_per_block=MM.block_plan(n_in)[0])
        log(f"[masked_mm] time B={B}: kernel {ms:.4f} ms (device "
            f"{dms:.4f} ms), plain gather {plain_ms:.4f} ms, dense addmm "
            f"(library) {library_ms:.4f} ms (device {library_dms:.4f} ms), "
            f"bound {bms:.5f} ms ({by}: {nbytes} B for {cols} of {n_in} "
            f"columns, {flops} flops), {ms / bms:.1f}x the bound "
            f"({dms / bms:.1f}x on the device clock)")
    main = results[f"masked_matmul_b{batches[0]}"]
    results["masked_matmul"] = dict(
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], max_abs_err=max_abs)

    # ---- its entry point (no caller in the package but the tests):
    # counts zeroed just before, read just after
    MM.reset_launch_counts()
    for x in xs_of.values():
        y = ops.masked_matmul(x, conn, w, bias)
        check(bool(torch.isfinite(y).all()), "[masked_mm] non-finite")
    counts = MM.launch_counts()
    # ----
    check(counts["masked_matmul"] == len(batches),
          f"[masked_mm] entry point launched {counts}")
    log(f"[masked_mm] launches through ops.masked_matmul: {counts}")
    return counts


def _cast_params(tree, dtype):
    """The same weights with every bf16 leaf in ``dtype`` (exact for
    float32)."""
    import torch
    if isinstance(tree, dict):
        return {k: _cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_params(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.bfloat16 else tree


def _nudge_embeddings(params):
    """The same weights with every embedding value one bf16 ulp further
    from zero (its bit pattern plus one): each input to the first block
    moved by the smallest step the served dtype has."""
    import torch
    table = params["embed"]["table"]
    assert table.dtype == torch.bfloat16
    nudged = (table.view(torch.int16) + 1).view(torch.bfloat16)
    return {**params, "embed": {**params["embed"], "table": nudged}}


def _block_inputs(cfg, params, toks, LM):
    """The residual stream entering each block of a kernel-path prefill
    of ``toks``."""
    x = LM._embed(cfg, params, toks)
    cache = LM.init_cache(cfg, toks.shape[0], toks.shape[1], toks.device)
    xs = []
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        xs.append(x)
        x, _ = LM.block_apply(cfg, kind, bp, x, cache["blocks"][i])
    return xs


def _state_rel(a, b):
    return max(_rel_err(a[k], b[k])[1] for k in ("S", "x_tm", "x_cm"))


def phase_lm(dev, results, smoke=False, B=4, P=512, GEN=32):
    """rwkv6-3b at full width by default (``smoke`` rehearses it)."""
    import dataclasses
    import torch
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import serve
    from repro_torch.models import lm as LM
    from repro_torch.models import registry as R

    torch.backends.cuda.matmul.allow_tf32 = False    # float32 checks
    t0 = time.perf_counter()
    cfg, params = serve.init_lm("rwkv6-3b", smoke=smoke, device=dev,
                                seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype)
          == (32, 2560, 65536, torch.bfloat16),
          f"[lm] not the full-width config: {cfg}")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, vocab "
        f"{cfg.vocab}, {str(cfg.dtype)[6:]}; {n_params} weights drawn "
        f"on the card in {init_s:.2f} s (param_count "
        f"{R.param_count(cfg)[0]})")
    prompt = serve.make_prompt(cfg, B, P, seed=0, device=dev)
    serve.serve_lm(params, cfg, prompt[:, :64], gen=2)      # warm-up

    # ---- the main path: counts zeroed just before, read just after
    wkv6.reset_launch_counts()
    res = serve.serve_lm(params, cfg, prompt, gen=GEN, keep_logits=True)
    counts = wkv6.launch_counts()
    # ----
    want_launches = cfg.n_layers * (1 + GEN)
    check(counts["wkv6"] == want_launches,
          f"[lm] {counts['wkv6']} WKV launches, want {want_launches}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          "[lm] non-finite logits")
    decode_ms = res.decode_s / GEN * 1e3
    log(f"[lm] served B={B} x {P}-token prefill + {GEN} greedy decode "
        f"steps: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{decode_ms:.3f} ms/token step, {res.tokens_per_s:.1f} tokens/s; "
        f"WKV launches {counts['wkv6']} = {cfg.n_layers} x (1 + {GEN}); "
        f"first tokens {res.tokens[0, :8].tolist()}")
    out = dict(batch=B, prompt_len=P, gen=GEN, init_s=init_s,
               prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_step=decode_ms,
               tokens_per_s=res.tokens_per_s, counts=counts,
               params=n_params)
    plain = dataclasses.replace(cfg, use_wkv_kernel=False)

    def whole_model(c, p):
        """Prefill logits, then each decode step's, fed res.tokens."""
        prefill = R.make_prefill_step(c, P + GEN)
        step = R.make_serve_step(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p, prompt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seq = [logits]
        for i in range(GEN):
            logits, cache = step(p, cache, res.tokens[:, i:i + 1], P + i)
            seq.append(logits)
        return seq, secs

    # (1) kernel vs plain WKV, bf16, block by block on the same inputs:
    # each block of the prefill, then one decode step through every
    # block from the prefill's state.  Random weights amplify a single
    # bf16 rounding flip from block to block (a whole-model bf16
    # comparison parts by ~15% of the logits' scale; see PERF.md), so
    # the bf16 check holds each block to its own inputs.
    xs = _block_inputs(cfg, params, prompt, LM)
    blk_rel = 0.0
    states = []
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        zero = LM.block_cache_init(cfg, kind, B, P, dev)
        yk, ck = LM.block_apply(cfg, kind, bp, xs[i], zero)
        yp, cp = LM.block_apply(plain, kind, bp, xs[i], zero)
        blk_rel = max(blk_rel, _rel_err(yk, yp)[1], _state_rel(ck, cp))
        states.append(ck)
    x = LM._embed(cfg, params, res.tokens[:, :1])
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        yk, ck = LM.block_apply(cfg, kind, bp, x, states[i])
        yp, cp = LM.block_apply(plain, kind, bp, x, states[i])
        blk_rel = max(blk_rel, _rel_err(yk, yp)[1], _state_rel(ck, cp))
        x = yk
    del xs, states
    log(f"[lm] kernel vs plain WKV, bf16, each block on the same inputs "
        f"(prefill and one decode step): block outputs and states max "
        f"error relative to scale {blk_rel:.3e} (tolerance "
        f"{LM_KERNEL_TOL})")
    check(blk_rel <= LM_KERNEL_TOL,
          "[lm] a block's kernel path differs from its plain-WKV path")

    # (2) the whole bf16 model, kernel path vs plain WKV, held to the
    # plain-WKV model against itself with each input nudged one bf16 ulp
    seq_p, plain_prefill_s = whole_model(plain, params)
    seq_n, _ = whole_model(plain, _nudge_embeddings(params))

    def gap(seq_a, seq_b):
        rels = [_rel_err(a, b)[1] for a, b in zip(seq_a, seq_b)]
        agree = float(torch.stack([a.argmax(-1) == b.argmax(-1) for a, b
                                   in zip(seq_a, seq_b)]).float().mean())
        return rels, agree

    bf16_rels, bf16_agree = gap(res.logits, seq_p)
    nudge_rels, nudge_agree = gap(seq_n, seq_p)
    del seq_p, seq_n
    log(f"[lm] whole model, bf16, prefill and {GEN} decode steps, logits "
        f"max error relative to scale: kernel vs plain WKV "
        f"{max(bf16_rels):.3e} (argmax agrees on {bf16_agree:.4f} of "
        f"rows); plain WKV vs itself with inputs nudged one ulp "
        f"{max(nudge_rels):.3e} (argmax {nudge_agree:.4f}); ratio "
        f"{max(bf16_rels) / max(nudge_rels):.3f} (tolerance "
        f"{LM_NUDGE_SLACK}); plain-WKV prefill "
        f"{plain_prefill_s * 1e3:.2f} ms")
    check(max(bf16_rels) <= LM_NUDGE_SLACK * max(nudge_rels),
          "[lm] bf16 model: the kernel path parts from plain WKV by more "
          "than a one-ulp nudge of the inputs moves it")

    # (3) the same weights in float32, whole model: kernel vs plain WKV
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    seq_k, _ = whole_model(c32, p32)
    seq_p, _ = whole_model(dataclasses.replace(c32, use_wkv_kernel=False),
                           p32)
    f32_rels = [_rel_err(a, b)[1] for a, b in zip(seq_k, seq_p)]
    del seq_k, seq_p
    log(f"[lm] kernel vs plain WKV, float32 weights, whole model: logits "
        f"max error relative to scale: prefill {f32_rels[0]:.3e}, decode "
        f"max {max(f32_rels[1:]):.3e} (tolerance {LM_F32_TOL})")
    check(max(f32_rels) <= LM_F32_TOL,
          "[lm] float32 model: kernel path differs from plain WKV")

    # (4) a 64-token prefill vs 64 single-token decode steps: bf16 block
    # by block on the same inputs, and the float32 whole model
    toks = serve.make_prompt(cfg, B, 64, seed=2, device=dev)
    xs = _block_inputs(cfg, params, toks, LM)
    state_rel = 0.0
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        _, cp = LM.block_apply(cfg, kind, bp, xs[i],
                               LM.block_cache_init(cfg, kind, B, 64, dev))
        cd = LM.block_cache_init(cfg, kind, B, 64, dev)
        for t in range(64):
            _, cd = LM.block_apply(cfg, kind, bp, xs[i][:, t:t + 1], cd)
        state_rel = max(state_rel, _state_rel(cd, cp))
    del xs
    lp, cache_p = LM.prefill(p32, c32, toks, 64)
    cache_d = LM.init_cache(c32, B, 64, dev)
    for t in range(64):
        ld, cache_d = LM.decode_step(p32, c32, cache_d, toks[:, t:t + 1], t)
    f32_state = max(_state_rel(d, q) for d, q in zip(cache_d["blocks"],
                                                     cache_p["blocks"]))
    f32_logit = _rel_err(ld, lp)[1]
    del p32, cache_p, cache_d
    torch.cuda.empty_cache()
    log(f"[lm] 64-token prefill vs 64 decode steps: bf16, each block on "
        f"the same inputs: state max error relative to scale "
        f"{state_rel:.3e} (tolerance {LM_STATE_TOL}); float32 weights, "
        f"whole model: state {f32_state:.3e}, last logits "
        f"{f32_logit:.3e} (tolerance {LM_F32_TOL})")
    check(state_rel <= LM_STATE_TOL,
          "[lm] prefill and decode steps leave different states")
    check(f32_state <= LM_F32_TOL and f32_logit <= LM_F32_TOL,
          "[lm] float32 model: prefill and decode steps differ")
    out.update(plain_wkv_prefill_ms=plain_prefill_s * 1e3,
               block_kernel_vs_plain_rel=blk_rel,
               bf16_whole_model_rel=bf16_rels, bf16_argmax_agree=bf16_agree,
               bf16_nudge_rel=nudge_rels, bf16_nudge_argmax_agree=nudge_agree,
               f32_kernel_vs_plain_rel=f32_rels,
               block_prefill_vs_decode_state_rel=state_rel,
               f32_prefill_vs_decode_state_rel=f32_state,
               f32_prefill_vs_decode_logits_rel=f32_logit)

    # where the time goes: one prefill, then two decode steps, traced
    prefill = R.make_prefill_step(cfg, P + GEN)
    step = R.make_serve_step(cfg)
    _, cache = prefill(params, prompt)
    for what, fn in (
            ("prefill", lambda: prefill(params, prompt)),
            ("2 decode steps", lambda: [step(params, cache, res.tokens[
                :, i:i + 1], P + i) for i in range(2)])):
        wall, per = profile_kernels(fn)
        busy = sum(ms for ms, _ in per.values())
        launches = sum(n for _, n in per.values())
        wkv_ms = sum(ms for name, (ms, _) in per.items()
                     if name.startswith("void wkv6_kernel"))
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
        log(f"[lm] trace, {what}: host wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}), "
            f"{launches} kernels; WKV kernel {wkv_ms:.3f} ms "
            f"({wkv_ms / busy:.3f} of device time); top: "
            + "; ".join(f"{name[:40]} {ms:.2f} ms x{n}"
                        for name, (ms, n) in top))
        out[f"trace_{what.replace(' ', '_')}"] = dict(
            wall_ms=wall, device_busy_ms=busy, kernels=launches,
            wkv_ms=wkv_ms, top=[(name, ms, n) for name, (ms, n) in top])
    results["_lm"] = out
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this test runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from the "
              f"repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = phase_device()
    build = phase_build()
    phase_golden(dev)
    results = {}
    phase_width(dev, results)
    counts = dict(phase_serve(dev, results))
    phase_wkv(dev, results)
    counts.update(phase_masked_mm(dev, results))
    counts.update(phase_lm(dev, results))

    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
        check(counts[name] > 0, f"kernel {name} never launched on its "
              f"path")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build": build, "results": results},
                  f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
