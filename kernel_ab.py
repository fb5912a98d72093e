#!/usr/bin/env python3
"""Time the LUT, WKV6 and masked-matmul kernels of one source tree on a
CUDA card, with the timers of ``chip_smoke.py``, so that two commits
compare on one card.

    python3 kernel_ab.py LABEL [--src DIR] [--one-thread-body]

builds the kernel libraries of the ``repro_torch`` package under ``DIR``
(default: this checkout's ``src/``), times its kernels as the ``[width]``,
``[wkv]`` and ``[masked_mm]`` phases of ``chip_smoke.py`` do (HDR-Add2 and
JSC-XL-Add2 at B=4096 and 256 with uint8 and int4 slabs; WKV6 at
rwkv6-3b's prefill call in bf16 and float32 and at a decode step; the
masked matmul at 784 -> 256, F=6, B=1024, 4096 and 16384, through the
tree's ``ops.masked_matmul``), then the pipelined kernel
against the grid-mode one at batches past what the card holds a block
for each (``LARGE_SHAPES``) and kernel 3 one layer at a time
(``LAYER_SHAPES``), writes ``chiprun_out/times_LABEL.json`` and prints
one JSON summary line.  Every time is from this file's timers whatever
tree it runs, which an older commit's own ``chip_smoke.py`` cannot
promise.

To compare a parent commit with a change, unpack the parent into the
gitignored ``_chipcheck/`` and run, in one session on one card, in turns:

    git archive <parent> | tar -x -C _chipcheck/parent
    for t in parentA changeA changeB parentB; do
      case $t in parent*) s=_chipcheck/parent/src;; *) s=src;; esac
      python3 kernel_ab.py $t --src $s
    done

``--one-thread-body`` times a copy of ``DIR``'s package (written under
``_chipcheck/one_thread_body/``) whose per-layer chain launches, in
place of kernel 3's rows x neurons blocks, the earlier body of one
thread an output (row, neuron) with the codes read from device memory
and the generic ``lut_neuron`` — with the same one host call and the
same programmatic dependent launches — so that the body and the launch
chain can be told apart.

    python3 kernel_ab.py LABEL --sweep

times instead the pipelined kernel (rows x threads x tiles a block) and
the per-layer chain (rows x threads x neuron splits, codes staged or
read unstaged) at every geometry
of a small grid, built here and launched through the package's launch
helpers, against the one each picks, at HDR-Add2 and JSC-XL-Add2 widths,
and the masked matmul (rows a tile x tiles a block x ring stages) at
its three batches (``chiprun_out/sweep_LABEL.json``; the card's time
with the calls queued ahead, ``queued_ms``, each geometry first held
against the plain version: bit for bit, and for the masked matmul
within ``chip_smoke.MM_RTOL``/``MM_ATOL``).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label", help="names chiprun_out/times_LABEL.json")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch is timed "
                    "(default: this checkout's src/)")
    ap.add_argument("--one-thread-body", action="store_true",
                    help="time a copy whose per-layer chain runs one "
                    "thread an output")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep kernels 2 and 3's geometries instead")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"kernel_ab: {src}/repro_torch not found", file=sys.stderr)
        return 2
    if args.one_thread_body:
        src = one_thread_body_tree(src, os.path.join(
            ROOT, "_chipcheck", "one_thread_body", "src"))
    sys.path.insert(0, src)
    import chip_smoke as CS
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        print(f"kernel_ab: repro_torch came from {repro_torch.__file__}, "
              f"not {src}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = CS.phase_device()
    CS.phase_build()
    if args.sweep:
        return sweep(dev, smi, args.label)
    results = {}
    CS.time_lut(dev, results, np.random.default_rng(2024))
    CS.time_wkv(dev, results)
    CS.time_masked_mm(dev, results)
    time_large(dev, results)
    time_layers(dev, results)
    keep = ("ms", "device_ms", "queued_ms", "plain_ms", "bound_ms")
    summary = {k: {m: v.get(m) for m in keep} for k, v in results.items()}
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, f"times_{args.label}.json"),
              "w") as f:
        json.dump({"device": smi, "src": src, "results": results}, f,
                  indent=1, default=str)
    print(json.dumps({"times": args.label, "src": src, "device": smi,
                      "results": summary}))
    return 0


# ---------------------------------------------------------------------------
# the earlier per-layer body under the same chain
# ---------------------------------------------------------------------------

ONE_THREAD_KERNEL = r"""
// The earlier kernel 3 body, for kernel_ab.py --one-thread-body: one
// thread an output (row, neuron), neuron fastest, the row's codes read
// from device memory by the generic lut_neuron; the chain's programmatic
// dependent launch as lut_gather_kernel takes it.
__global__ void __launch_bounds__(256)
lut_gather_kernel_per_output(const int32_t* __restrict__ codes,
                             int32_t* __restrict__ out, int B,
                             const LayerDesc L, int, int, int) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * L.n_out) return;
  const int b = static_cast<int>(t / L.n_out);
  const int n = static_cast<int>(t - static_cast<long long>(b) * L.n_out);
  out[t] = lut_neuron(L, codes + static_cast<long long>(b) * L.n_in, 1, n);
}

"""
ONE_THREAD_LAUNCH = """\
    cfg.gridDim = dim3(static_cast<unsigned>(
        (static_cast<long long>(B) * d[l].n_out + 255) / 256));
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 0;
    e = cudaLaunchKernelEx(&cfg, lut_gather_kernel_per_output,"""


def one_thread_body_tree(src: str, dst: str) -> str:
    """Copy ``src``'s ``repro_torch`` to ``dst`` with kernel 3's launches
    in ``lut_layers_launch`` replaced by ``ONE_THREAD_KERNEL``'s, at 256
    threads a block and one block per 256 outputs; returns ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src, "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = os.path.join(dst, "repro_torch", "kernels", "lut_gather", "csrc",
                      "lut_gather.cu")
    text = open(cu).read()
    anchor = 'extern "C" int lut_desc_size()'
    launch = "    e = cudaLaunchKernelEx(&cfg, lut_gather_kernel,"
    if text.count(anchor) != 1 or text.count(launch) != 1:
        raise SystemExit(f"kernel_ab: {cu} has no lut_layers_launch chain "
                         f"to give the one-thread body")
    text = text.replace(anchor, ONE_THREAD_KERNEL + anchor)
    text = text.replace(launch, ONE_THREAD_LAUNCH)
    with open(cu, "w") as f:
        f.write(text)
    return dst


# ---------------------------------------------------------------------------
# kernel 2 past one tile a block; kernel 3 layer by layer
# ---------------------------------------------------------------------------

# (model, seed, batch): the pipelined kernel's blocks walk several tiles,
# through a one-stage ring at HDR-Add2 and a two-stage one at JSC-XL-Add2
LARGE_SHAPES = (("hdr_add2", 11, 16384), ("jsc_xl_add2", 12, 32768))
# (model, seed, batch, int4): each layer of kernel 3 alone
LAYER_SHAPES = (("hdr_add2", 11, 256, True),
                ("jsc_xl_add2", 12, 4096, False))


def _net(model, seed, dev, packed=False):
    import chip_smoke as CS
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.lut_synth import pack_tables_int4
    from repro_torch.kernels.lut_gather import ops
    spec = getattr(PM, model)()
    base = CS.random_tables(spec, seed, dev)
    tables = pack_tables_int4(base) if packed else base
    return spec, tables, ops._layer_args(tables, spec.in_features,
                                         check_conn=True)


def time_large(dev, results):
    """Kernel 2 and kernel 1 at ``LARGE_SHAPES``, uint8, each held bit for
    bit against the plain version first, and kernel 2's two-stage launch
    again through one stage.  Keys ``<model>_<kernel>_b<B>``."""
    import chip_smoke as CS
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    rng = np.random.default_rng(2025)
    for model, seed, B in LARGE_SHAPES:
        spec, tables, args = _net(model, seed, dev)
        net = K.FusedNet(args)
        bits0 = spec.layer_specs()[0].in_quant.bits
        inputs = [CS.random_codes(rng, B, spec.in_features, bits0, dev)
                  for _ in range(4)]
        want = ref.lut_network(inputs[0], [a.plain() for a in args])
        nbytes = 4 * B * (spec.in_features + spec.widths[-1]) + \
            CS.slab_bytes(tables)
        ops_ = B * sum(CS.layer_ops(t) for t in tables)
        bms, by = CS.bound_ms(nbytes, ops_)
        for name, pipeline in (("lut_network_fused", False),
                               ("lut_network_fused_pipelined", True)):
            def fn(c, p=pipeline):
                return K.lut_network_fused(c, net, pipeline=p)
            CS.check(CS.max_abs_err(fn(inputs[0]), want) == 0,
                     f"[large] {model} B={B} {name} differs")
            g = net.geometry(B, pipeline)
            geo = (f"{g.rows}x{g.threads}/{g.grid}x"
                   f"{getattr(g, 'tiles', '?')} stages "
                   f"{getattr(g, 'stages', '?')}")
            r = dict(ms=CS.time_ms(fn, inputs),
                     device_ms=CS.device_ms(fn, inputs,
                                            CS.LUT_SYMBOLS[name], 1),
                     queued_ms=CS.queued_ms(fn, inputs), bound_ms=bms,
                     bound_by=by, geometry=geo, batch=B)
            results[f"{model}_{name}_b{B}"] = r
            CS.log(f"[large] {model} B={B} {name} {geo}: queued "
                   f"{r['queued_ms']:.4f} ms, device {r['device_ms']}, "
                   f"events {r['ms']:.4f}, bound {bms:.5f} ({by})")
            if getattr(g, "stages", 0) == 2:
                # the same launch through a one-stage ring: what the
                # second stage's copy overlap is worth
                one = dataclasses.replace(g, stages=1, smem_bytes=(
                    K.fused_smem_bytes(net.n_in0, net.widths, g.rows,
                                       True, 1)))
                def fn1(c):
                    return K._launch_fused(c, net, one)
                CS.check(CS.max_abs_err(fn1(inputs[0]), want) == 0,
                         f"[large] {model} B={B} one stage differs")
                q1 = CS.queued_ms(fn1, inputs)
                results[f"{model}_{name}_one_stage_b{B}"] = dict(
                    queued_ms=q1, batch=B)
                CS.log(f"[large] {model} B={B} {name} through one stage: "
                       f"queued {q1:.4f} ms")


def time_layers(dev, results):
    """Kernel 3 one layer at a time (``lut_gather``) at ``LAYER_SHAPES``,
    each layer's inputs the plain outputs of the layer before, held bit
    for bit first.  Keys ``<model>_<u8|int4>_b<B>_layer<l>``."""
    import chip_smoke as CS
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref
    rng = np.random.default_rng(2026)
    for model, seed, B, packed in LAYER_SHAPES:
        spec, _, args = _net(model, seed, dev, packed)
        bits0 = spec.layer_specs()[0].in_quant.bits
        inputs = [CS.random_codes(rng, B, spec.in_features, bits0, dev)
                  for _ in range(8)]
        for l, a in enumerate(args):
            outs = [ref.lut_layer(c, *a.plain()) for c in inputs]
            CS.check(CS.max_abs_err(K.lut_gather(inputs[0], a), outs[0])
                     == 0, f"[layers] {model} layer {l} differs")
            def fn(c, a=a):
                return K.lut_gather(c, a)
            r = dict(queued_ms=CS.queued_ms(fn, inputs),
                     device_ms=CS.device_ms(fn, inputs, "lut_gather", 1),
                     n_in=a.n_in, n_out=a.n_out, A=a.conn.shape[1],
                     F=a.conn.shape[2], batch=B)
            key = f"{model}_{'int4' if packed else 'u8'}_b{B}_layer{l}"
            results[key] = r
            CS.log(f"[layers] {key} {a.n_in}->{a.n_out} (A={r['A']}, "
                   f"F={r['F']}): queued {r['queued_ms']:.4f} ms, device "
                   f"{r['device_ms']}")
            inputs = outs


# ---------------------------------------------------------------------------
# the geometry sweep
# ---------------------------------------------------------------------------

# the sweep's shapes (model, batch, int4) and geometries
SWEEP_SHAPES = (("hdr_add2", 256, True), ("hdr_add2", 4096, False),
                ("jsc_xl_add2", 256, True), ("jsc_xl_add2", 4096, False))
SWEEP_ROWS = (1, 2, 4, 8, 16, 32)
SWEEP_THREADS = (64, 128, 256)
SWEEP_TILES = (1, 2, 4)          # kernel 2: tiles a block walks
SWEEP_SPLITS = (1, 2)            # kernel 3: neuron tiles a layer


def pipelined_at(K, net, B, rows, threads, tiles):
    """Kernel 2's launch at ``rows`` x ``threads``, each block walking
    ``tiles`` tiles, with ``fused_geometry``'s stage rule."""
    n_tiles = -(-B // rows)
    grid = -(-n_tiles // tiles)
    one, two = (K.fused_smem_bytes(net.n_in0, net.widths, rows, True, s)
                for s in (1, 2))
    stages = 2 if tiles > 1 and K.resident_blocks(threads, two) == \
        K.resident_blocks(threads, one) else 1
    smem = two if stages == 2 else one
    res = min(K.resident_blocks(threads, smem), -(-grid // net.n_sms))
    return K.FusedGeometry(rows=rows, threads=threads, grid=grid,
                           smem_bytes=smem, blocks_per_sm=res,
                           carveout=K._carveout(res, smem), tiles=tiles,
                           stages=stages)


def chain_at(K, net, B, rows, threads, splits, staged=True):
    """Kernel 3's chain with every layer at ``rows`` x ``threads`` and its
    neurons over ``splits`` blocks, staged as ``layer_geometry`` stages
    (or, with ``staged`` false, every layer's codes read unstaged)."""
    geos = []
    for a in net.layers:
        smem = 4 * rows * a.n_in
        smem = 0 if smem > K.SMEM_BUDGET_BYTES or not staged else smem
        row_tiles = -(-B // rows)
        ntile = -(-a.n_out // splits)
        tiles = -(-a.n_out // ntile)
        res = min(K.resident_blocks(threads, smem),
                  -(-row_tiles * tiles // net.n_sms))
        geos.append(K.LayerGeometry(
            rows=rows, threads=threads, ntile=ntile, row_tiles=row_tiles,
            neuron_tiles=tiles, smem_bytes=smem, blocks_per_sm=res,
            carveout=K._carveout(res, smem)))
    return K._chain_args(geos)


def sweep(dev, smi, label) -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ref

    rng = np.random.default_rng(2024)
    out = {}
    for model, B, packed in SWEEP_SHAPES:
        spec, _, args_ = _net(model, 11, dev, packed)
        net = K.FusedNet(args_)
        bits0 = spec.layer_specs()[0].in_quant.bits
        inputs = [CS.random_codes(rng, B, spec.in_features, bits0, dev)
                  for _ in range(8)]
        want = ref.lut_network(inputs[0], [a.plain() for a in args_])
        cap = net.rows(True)
        descs = ctypes.addressof(net.host_desc)
        cases = {"lut_network_fused_pipelined": [
            (r, t, n) for r in SWEEP_ROWS for t in SWEEP_THREADS
            for n in SWEEP_TILES if r <= min(cap, t) and -(-B // r) >= n],
            "lut_gather": [(r, t, n, st) for r in SWEEP_ROWS
                           for t in SWEEP_THREADS for n in SWEEP_SPLITS
                           for st in (True, False) if r <= t]}
        forced = {
            "lut_network_fused_pipelined": lambda c, k: K._launch_fused(
                c, net, pipelined_at(K, net, B, *k)),
            "lut_gather": lambda c, k: K._launch_layers(
                c, descs, len(net.layers), chain_at(K, net, B, *k),
                net.widths, net.wp, net.wq)}
        picked = {"lut_network_fused_pipelined":
                  lambda c: K.lut_network_fused(c, net, pipeline=True),
                  "lut_gather": lambda c: K.lut_layers(c, net)}
        tag = f"{model}_{'int4' if packed else 'u8'}_b{B}"
        fused_ms = CS.queued_ms(lambda c: K.lut_network_fused(c, net),
                                inputs)
        out[f"{tag}_lut_network_fused"] = dict(default_ms=fused_ms)
        CS.log(f"[sweep] {tag} lut_network_fused: default "
               f"{fused_ms:.4f} ms")
        for name, ks in cases.items():
            fns = [(None, picked[name])] + [
                (k, lambda c, k=k: forced[name](c, k)) for k in ks]
            rows_ = []
            for k, fn in fns:
                CS.check(torch.equal(fn(inputs[0]), want),
                         f"[sweep] {tag} {name} {k} differs")
                rows_.append((CS.queued_ms(fn, inputs), k))
            default = rows_[0][0]
            ranked = sorted(rows_[1:], key=lambda x: x[0])
            out[f"{tag}_{name}"] = dict(default_ms=default, sweep=ranked)
            CS.log(f"[sweep] {tag} {name}: default {default:.4f} ms; "
                   f"best " + "; ".join(f"{k} {ms:.4f}"
                                        for ms, k in ranked[:6]))
    sweep_masked_mm(dev, out)
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, f"sweep_{label}.json"), "w") as f:
        json.dump({"device": smi, "results": out}, f, indent=1,
                  default=str)
    print(json.dumps({"sweep": label, "device": smi}))
    return 0


# kernel 4's sweep: rows a tile, tiles a block walks, ring stages
MM_SWEEP_ROWS = (1, 2, 4, 8, 16)
MM_SWEEP_TILES = (1, 2, 4, 8)
MM_SWEEP_STAGES = (1, 2, 3, 4)


def mm_at(MM, LG, B, n_sms, rows, tiles, stages):
    """Kernel 4's launch at ``chip_smoke.MM_LAYER`` with ``rows``-row
    tiles, each block walking ``tiles`` of them through ``stages``
    stages, 256 threads; None where the ring does not fit."""
    import chip_smoke as CS
    n_in, n_out, F = CS.MM_LAYER
    n_tiles = -(-B // rows)
    grid = -(-n_tiles // tiles)
    smem = MM.mm_smem_bytes(rows, n_in, stages)
    if smem > MM.SMEM_BUDGET_BYTES or stages > tiles:
        return None
    res = min(MM._resident(256, smem, F), -(-grid // n_sms))
    return MM.MMGeometry(rows=rows, threads=256, ntile=n_out, grid=grid,
                         neuron_tiles=1, tiles=tiles, stages=stages,
                         smem_bytes=smem, blocks_per_sm=res,
                         carveout=LG._carveout(res, smem))


def sweep_masked_mm(dev, out):
    """Kernel 4 at ``chip_smoke.MM_BATCHES`` through every geometry of
    the grid above (launched by ``masked_matmul._launch``), each held
    against the plain gather first, beside the one ``mm_geometry``
    picks; queued ms, the inputs rotating through more than the L2."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels.lut_gather import lut_gather as LG
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.masked_matmul import ref

    n_in, n_out, F = CS.MM_LAYER
    g, conn, w, bias = CS.mm_operands(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in CS.MM_BATCHES:
        xs = [torch.randn((B, n_in), generator=g, device=dev)
              for _ in range(max(2, -(-64 * 2 ** 20 // (4 * B * n_in))))]
        want = ref.masked_matmul(xs[0], conn, w, bias)
        picked = MM.mm_geometry(B, sms, n_in, n_out, F)
        rows_ = []
        for k in [None] + [(r, t, s) for r in MM_SWEEP_ROWS
                           for t in MM_SWEEP_TILES
                           for s in MM_SWEEP_STAGES]:
            geo = picked if k is None else mm_at(MM, LG, B, sms, *k)
            if geo is None:
                continue

            def fn(x, geo=geo):
                return MM._launch(x, conn, w, bias, geo)

            CS.check(torch.allclose(fn(xs[0]), want, rtol=CS.MM_RTOL,
                                    atol=CS.MM_ATOL),
                     f"[sweep] masked_mm B={B} {k} differs")
            rows_.append((CS.queued_ms(fn, xs), k))
        default = rows_[0][0]
        ranked = sorted(rows_[1:], key=lambda x: x[0])
        out[f"masked_matmul_b{B}"] = dict(default_ms=default, sweep=ranked,
                                          picked=str(picked))
        CS.log(f"[sweep] masked_mm B={B}: default ({picked.rows} rows, "
               f"{picked.tiles} tiles, {picked.stages} stages) "
               f"{default:.4f} ms; best (rows, tiles, stages) "
               + "; ".join(f"{k} {ms:.4f}" for ms, k in ranked[:6]))


if __name__ == "__main__":
    sys.exit(main())
