#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the CUDA LUT kernels from the checkout's sources;
             print the build seconds and nvcc's ``-Xptxas -v`` report.
3. golden  — load ``tests/golden/`` (packed and unpacked): every kernel
             reproduces ``golden_io.npz["outputs"]`` exactly and the
             recomputed artifact id matches.
4. width   — HDR-Add2 (MNIST 784 -> 256,100x4,10, F=4, A=2) and
             JSC-XL-Add2 (7-bit inputs, 4096-entry adder tables) tables
             drawn from a numpy seed: each kernel equals its plain
             PyTorch version on the card bit for bit, at B=4096 and a
             ragged B=1000, slabs packed and unpacked; timed with CUDA
             events against the plain version and the bytes bound.
5. serve   — the main path: HDR-Add2 saved as an artifact, served through
             ``ModelRegistry`` on ``cuda`` (~2000 Poisson requests, one
             hot-swap to a second seed mid-stream: 0 failed, 0 dropped,
             every answer equal to the plain forward of the version that
             answered), then the same artifact through the pipelined and
             per-layer plans of ``make_network_fn``.  Launch counts are
             zeroed just before and read just after; every kernel must
             have launched.

Output: a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Details go to
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
    from repro_torch.kernels.lut_gather import lut_gather as K
    t0 = time.perf_counter()
    K.build()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s -> {K.BUILD_INFO['path']}")
    for line in str(K.BUILD_INFO["log"]).splitlines():
        log(f"[build] {line}")
    return {"seconds": secs, "ptxas": K.BUILD_INFO["log"]}


def _engines(tables, n_in0):
    """The three kernels as whole-network functions: fused grid, fused
    pipelined, per-layer chain — and the plain version."""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    args = ops._layer_args(tables, n_in0, check_conn=True)
    net = K.FusedNet(args)

    def per_layer(c):
        for a in args:
            c = K.lut_gather(c, a)
        return c

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
            for B in (4096, 1000):
                codes = random_codes(rng, B, spec.in_features, bits0, dev)
                want = engines["plain"](codes)
                for name in KERNELS:
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
            net = K.FusedNet(args)
            log(f"[width] {spec.name} packed={packed}: 3 kernels == plain "
                f"at B=4096 and B=1000 (rows/block: fused "
                f"{net.rows(False)}, pipelined {net.rows(True)})")

    # timing: HDR-Add2 at B=4096 (offline scoring) and at the registry's
    # micro-batch of 256, slabs unpacked (uint8/int32) and int4-packed
    # (as the registry loads them); the kernels line reports B=4096
    # unpacked
    spec = PM.hdr_add2()
    n_in0, widths = spec.in_features, list(spec.widths)
    dims = [n_in0] + widths
    base = random_tables(spec, 11, dev)
    for B in (4096, 256):
        # together larger than the 50 MB L2 at B=4096
        inputs = [random_codes(rng, B, spec.in_features, 2, dev)
                  for _ in range(8)]
        for packed in (True, False):
            tables = pack_tables_int4(base) if packed else base
            engines, args = _engines(tables, spec.in_features)
            slabs = slab_bytes(tables)
            ops = B * sum(layer_ops(t) for t in tables)
            fused_bytes = 4 * B * (n_in0 + widths[-1]) + slabs
            per_layer_bytes = sum(4 * B * (dims[i] + dims[i + 1])
                                  for i in range(len(widths))) + slabs
            plain_ms = time_ms(engines["plain"], inputs, iters=10)
            for name, nbytes, launches in (
                    ("lut_network_fused", fused_bytes, 1),
                    ("lut_network_fused_pipelined", fused_bytes, 1),
                    ("lut_gather", per_layer_bytes, len(tables))):
                ms = time_ms(engines[name], inputs)
                bms, by = bound_ms(nbytes, ops)
                key = name + ("_int4" if packed else "") + \
                    ("" if B == 4096 else f"_b{B}")
                results[key] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bms, max_abs_err=errs[name],
                                    bound_by=by, bytes=nbytes, ops=ops,
                                    launches_per_forward=launches,
                                    batch=B, int4=packed)
                log(f"[width] time {name} int4={packed}: {ms:.4f} "
                    f"ms/forward at B={B} ({launches} launch/forward), "
                    f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}: "
                    f"{nbytes} B, {ops} ops)")
    net = K.FusedNet(args)
    results["_timing"] = dict(
        model="HDR-Add2",
        rows_fused=net.rows(False), rows_pipelined=net.rows(True),
        smem_fused=net.smem_bytes(net.rows(False), False),
        smem_pipelined=net.smem_bytes(net.rows(True), True))


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
    for name in KERNELS:
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
    counts = phase_serve(dev, results)

    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
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
