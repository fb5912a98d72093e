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
             answered), five times, each under a ``FlushProbe``: p50 /
             p99, the flushes, the largest split into host, card and
             copy time, the garbage collections; no collection may
             hold a waiting or served request over
             ``COLLECTION_BOUND_MS`` (the host's own pauses measured
             first; the largest flushes are logged, not bounded).
             Then the same artifact through the pipelined and per-layer
             plans of ``make_network_fn`` (the per-layer one a chain of
             kernel-3 launches from one host call).  Launch counts are
             zeroed just before each stream and read just after (the
             kernels line counts the first and the two plans); every
             kernel must have launched.
6. fleet   — the serving fleet across processes: two worker processes
             on the card (``LutFleet(transport="process")``) serve
             HDR-Add2 from a saved artifact under 8000 Poisson requests
             at 4000/s, during which a two-phase swap to a second seed
             (its slab transfer to one worker corrupted in flight and
             re-fetched) and a SIGKILL of the other worker land: 0
             dropped, failed or hung, every answer equal to the plain
             forward of its version, no microbatch mixing versions, and
             kernel 1 launched in the surviving worker (counts zeroed in
             the workers just before, read back over the wire after).
             Prints p50/p99 latency, the swap's blackout and the counts.
7. shards  — the batch split over device meshes: ``serving_mesh()``
             over every visible card and ``serving_mesh(4, devices=
             [cuda:0] * 4)`` (four shards on one card).  HDR-Add2 (B=4096,
             4097, 37, 1) and JSC-XL-Add2 (B=4096, 37), uint8 and int4,
             plans auto / pipelined / per-layer / two segments: every
             sharded output equal to the unsharded kernel-1 output and
             the plain version bit for bit; the four-shard mesh against
             the unsharded call at B=4096 and 16384 (CUDA events and
             queued); ``tune_block_b`` on both networks (one time a
             launch, the largest level cap picked, each cap's time, every
             cap's output equal); ``ModelRegistry(mesh=)`` 4000
             requests at 4000/s (0 failed, bit for bit, p50/p99 beside
             [serve]'s), the pipelined and per-layer plans through
             ``make_network_fn(mesh=)`` (one launch a shard); ``serve
             --lut --shards 1`` (the unsharded run's accuracy) and
             ``--shards`` past the visible cards (ValueError);
             ``LutFleet(2, mesh=, transport="thread")`` 2000 requests
             across a swap (0 dropped) and the process transport's
             ValueError.  Counts zeroed just before the registry, read
             after the fleet.
8. train   — HDR-Add2 at full width trained by the port on the card:
             250 QAT steps (lr 5e-3, B=256, procedural MNIST, seed 0),
             test accuracy at least A_REF - 0.05 (A_REF: the JAX
             package's, ``aref_hdr_add2.py``); ms a step by CUDA events
             and the device's idle share over 10 traced steps.  Then
             ``synthesise`` on the card: ``lut_forward`` of the tables
             picks the QAT forward's argmax on every test sample (logits
             within ``OUTPUT_QUANT.step``; the codes where forward and
             tables disagree are counted), and kernel 1 equals the plain
             codes bit for bit.  The tables saved as an artifact and
             served by ``serve --lut --artifact-dir D --device cuda``
             five times (~2000 requests through the registry each, counts
             zeroed just before and read after: 0 failed, 0 dropped,
             kernel 1 launched; flushes probed and bounded as in
             ``serve``); then ``serve --lut --save-artifact`` trains the
             tiny jsc model from scratch on the card.
9. search  — the SparseLUT toolflow at HDR-Add2's published widths:
             a 4-member ``search_connectivity_population`` (100 steps,
             B=256, phase_frac 0.6, eps2 2e-3, lr 0.15; each member
             from ``init_search_model`` on a CPU generator, digests
             checked), after its first 5 steps were held against the
             CPU path from the same start and draws (equal active sets,
             theta within 1e-5; no TF32); exactly 8 actives a neuron in
             every layer of every member, ``fan_in_violation <= 0``
             after the ramp; ms a step, kernels a step and idle share;
             the best member's masks through ``masks_to_conn``, retrained
             from ``[train]``'s two starts (mean accuracy >=
             A_REF_SEARCH - 0.05, and >= ``[train]``'s random mean -
             0.01), synthesised, saved with ``search_provenance`` in the
             manifest and served by ``serve --lut`` (kernel 1 counted,
             flushes bounded as in ``serve``).
             The same search on ``serving_mesh(2, devices=[cuda:0] * 2)``
             (two members a shard) ends on the unsharded run's masks and
             active sets and selects the same best member.
10. wkv     — the WKV6 kernel against its plain version
             (``wkv_chunked_ref`` at chunk 32, run on the card) at
             rwkv6-3b shapes: B=4 S=512 H=40 K=64 in
             bf16 and f32, one decode token (S=1) with a nonzero state, a
             ragged S=77, and every decay at the clamp (S=512; both must
             be finite); timed with CUDA events, on the device clock and
             queued, against the plain version and the bound.
11. masked_mm — the masked-matmul kernel against both plain versions at
             the kernels-bench layer (n_in 784, n_out 256, F 6) at
             B=1024, 4096 and 16384 (past what the card holds resident);
             timed (CUDA events, device clock, queued) against the plain
             gather, the dense ``torch.addmm`` form (the library call)
             and the bound; then its entry point (``ops.masked_matmul``)
             once at each batch, counts zeroed just before and read after.
12. lm     — rwkv6-3b at full width (32 layers, d_model 2560, vocab
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

13. lm_attn — qwen2.5-3b at full width (36 layers, d_model 2048, 16
             heads with kv 2 x 128, d_ff 11008, vocab 151936, bf16, 3.09 B
             weights from a fixed seed on the card), served through
             ``repro_torch.launch.serve``: a B=4 x 512-token prefill and 32
             greedy decode steps, all logits finite.  The bf16 model against
             the same weights in float32, block by block on the same inputs
             and over the whole model; in float32, a 64-token prefill then
             decode steps against one forward over the same tokens; decode
             with the int8 KV cache against the bf16 cache; ``serve
             --kv-int8`` as a user calls it.  Prefill ms, decode ms a step,
             tokens/s, and a profiler trace of one prefill and two decode
             steps (idle share, top kernels).
14. lm_train — ``examples/torch_lm_sparse_train.py``'s model (12 layers x
             512 d, 8 heads with kv 4, d_ff 2048, vocab 8192, float32,
             SparseLUT FFN at F_o 64): the first 5 steps on the card against
             the CPU path from the same start, batches and draws (loss
             within 1e-5 relative; active sets equal but for swaps of
             near-tied thetas at the pruning boundary, which AdamW's
             noise-level updates can cause: at most 16 a step, each
             checked at its step); 100 steps at B=8 x 128
             through the port's ``Trainer`` with checkpoints every 25 steps
             and a failure injected at step 40 (recovered once); fan-in at
             most f(step) at every step and exactly 64 once the ramp has
             landed; a new ``Trainer`` resumes from the directory bit for
             bit; the last 10 steps' loss against the JAX package's
             (``aref_lm.py``); ms a step, kernels a step, idle share.
             Then ``launch.train --sparse-ffn`` at the reference's
             defaults (qwen2.5-3b smoke, 100 steps).
15. examples — ``torch_quickstart.py`` (argmax agreement 100.0%),
             ``torch_mnist_sparselut.py`` and ``torch_lut_serve.py`` (0
             failed, 0 dropped) on the card, kernel 1 counted.

16. lm_moe — granite-moe-1b-a400m at full width (24 layers, d_model
             1024, 16 heads with kv 8 x 64, 32 experts top 8 of d_ff 512,
             vocab 49155, bf16): served through ``launch.serve`` (B=4 x
             512 prefill, 32 greedy decode steps); one MoE block against
             an independent float32 loop over its experts (same routes
             and drops); two prefills equal bit for bit (no float
             atomics), their dropped assignments printed; bf16 against
             float32 block by block (over the tokens routed alike) and
             whole; float32 at capacity factor 16, prefill + decode
             against one forward on the rows routed alike; a trace (the
             dispatch's sorts, gathers and copies).  Then kimi-k2 at its
             published widths cut to 2 layers (dense layer 0, one MoE
             layer of 384 experts and the shared expert): B=2 x 128
             prefill and 8 decode steps, the MoE block against the
             float32 loop.
17. lm_rglru — recurrentgemma-9b at full width (38 layers: 26 RG-LRU and
             12 local attention with a 2048-slot ring, d_model 4096, MQA
             kv 1 x 256, d_rnn 4096, vocab 256000, bf16): served B=4 x 512
             + 32 steps, then B=1 x 2304 + 32 steps (the ring wraps);
             every decay at its floor finite; bf16 against float32 block
             by block and whole; float32 prefill + decode against one
             forward, and 64 decode steps' state against a 64-token
             prefill's; a trace and the float32 gate products' time.
18. encdec — whisper-tiny at full width (4 + 4 layers, d_model 384,
             bf16): the registry's prefill (encoder over B=4 x 1500
             frames, cross K/V) and 32 greedy decode steps; float32
             decode against ``decode_train``; bf16 against float32;
             ``serve --arch whisper-tiny`` exits with the reference's
             message.  Then ``launch.train`` for 20 steps each at the
             reference's smoke configs of granite-moe, recurrentgemma and
             whisper (``--seq 32``): finite loss, checkpoints, MoE aux.
             Each of the three phases prints its peak device memory.
19. mesh_lm — the LM's multi-rank half: granite-moe-1b-a400m at full
             width (bf16) with ``moe_ep`` on a 2x2 mesh of ``[cuda:0] * 4``
             (axes data x model; and on a mesh of every card when there are
             two or more): a B=4 x 512 prefill and 32 greedy decode steps
             through the serve loop (finite logits; ms a prefill, ms a
             decode step and peak memory beside the unsharded run's);
             two EP prefills, ``moe_ep_fsdp`` against ``moe_ep`` and
             ``seq_parallel`` against the plain model, each bit for bit;
             the bf16 EP prefill at capacity factor 1.25 (each data slice
             its own capacity, so each drops), every block's EP channel
             against a float32 loop run on each data slice's tokens with
             the same routes: the same drops, outputs within the stated
             tolerance; in float32 with nothing dropped, a decode step
             block by block and a 64-token prefill + 16 decode steps over
             the whole model through ``moe_apply_ep`` against
             ``moe_apply``; 5 float32 train steps of all 24 layers
             through the ``Trainer`` on the mesh against 5 plain steps
             (losses), then ``Trainer.try_resume(shardings=)`` with
             ``lm_rules(fsdp=True)`` shardings on the mesh: the whole
             state equal to the saved one, and every shard equal to its
             slice of the saved leaf.
20. dryrun — the dry-run cost pass (``launch/dryrun.py``): every
             (arch x shape) cell of the registry on the 256-chip
             ``single`` and 512-chip ``multi`` placeholder meshes, at full
             size, one process a cell, as many at once as the machine has
             cores: skipped cells with the registry's reasons, every other
             cell ``ok`` with its chip count, every roofline term >= 0, a
             dominant term, a per-device peak > 0 and a positive, finite
             ``useful_ratio``; one ``summarize_cell`` line a cell.  Where
             the batch splits over the data axes, a chip's FLOPs on 512
             chips are half its FLOPs on 256, and a train cell's bytes
             at most DRYRUN_TRAIN_BYTES_SPLIT_MAX of them.

``python3 chip_smoke.py --phases lm_attn,lm_train`` runs only the named
phases (after ``device``), prints no result line and writes their
details to ``chiprun_out/chip_smoke_partial.json`` (also when a check
fails).

Output: a ``kernels`` JSON line (each kernel's ``ms`` by CUDA events
and ``device_ms`` on the device clock, beside its bound, plain and
library times, at the shape where its path launches it: the LUT kernels
at HDR-Add2's 256-row micro-batch with int4 slabs, WKV6 at the prefill
call, the masked matmul at B=1024; ``launches`` counted over each
kernel's paths, kernel 1's over the serve phase, the fleet phase (read
back from the workers), the shards phase, the train and search phases'
``serve --lut`` and the examples; kernels 2 and 3 over the serve and
shards phases), the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import itertools
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
        want = "any" if per_call is None else iters * per_call
        log(f"[trace] {kernel or 'the call'}: {n} of {want} launches in "
            f"the trace ({sum(k for _, k in per.values())} kernels of "
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
# served flushes: each one's split, and the collections during it
# ---------------------------------------------------------------------------

# [serve]'s stream and [train]'s serve --lut each run STREAM_RUNS times;
# in every run (and in [search]'s serve --lut) no garbage collection may
# hold a waiting or served request over COLLECTION_BOUND_MS: before the
# heap was frozen while batchers serve (launch/batching.py), full passes
# of 177-267 ms held requests on H100 80GB HBM3 cards (700 W), and 52
# served runs after it on four hosts kept every such collection within
# 4.12 ms.  Each run's largest flush (FlushRecord.kernel_s: buffer fill,
# copy in, forward, copy back) is logged with its split, not bounded:
# the same runs kept every flush within 10.056 ms, but a flush stretches
# with the host's load, all of its parts at once, with no collection and
# the card idle (22.297 ms on one host; up to 27.431 ms
# beside 8 processes spinning on the CPU, serve_ab.py --burn 8, against
# 3.212 ms alone on the same host), and nothing the process can read
# there tells that time from its own: the CPU clocks count 10 ms ticks
# and charge a thread the host took its core from.  A flush is "long"
# past LONG_FLUSH_X times its run's median.
STREAM_RUNS = 5
COLLECTION_BOUND_MS = 20.0
LONG_FLUSH_X = 10


def _frames(frame, depth: int = 3) -> str:
    """The innermost ``depth`` frames of a stack, 'file:line func <
    ...'."""
    out = []
    while frame is not None and len(out) < depth:
        c = frame.f_code
        out.append(f"{os.path.basename(c.co_filename)}:{frame.f_lineno} "
                   f"{c.co_name}")
        frame = frame.f_back
    return " < ".join(out)


class FlushProbe:
    """While active, records every ``MicroBatcher`` flush in this
    process.  On the host clock (``time.monotonic``): the host's work
    before the forward (buffer fill, the batch's copy to the card),
    the forward's host call, the wait for the card with the copy back
    (to the end of ``kernel_s``), and completing the handles.  On the
    card (CUDA events): the flush's start to the forward (the copy in
    and anything queued before it) and the forward.  And every garbage
    collection (``gc.callbacks``; a full pass with the frames whose
    allocation set it off), and the CPU time of the process (every
    thread) and of the batcher during the flush, to the CPU clock's
    step (``host_pauses``).  It wraps ``MicroBatcher._flush_inner`` and
    ``ops.make_network_fn`` for its span and changes no result."""

    def __init__(self, tag: str):
        self.tag = tag
        self.recs, self.gcs = [], []
        self._tls = threading.local()
        self._seq = itertools.count()

    def __enter__(self):
        import gc

        import torch
        from repro_torch.kernels.lut_gather import ops
        from repro_torch.launch.batching import MicroBatcher

        probe, tls = self, self._tls
        self._orig = (MicroBatcher._flush_inner, ops.make_network_fn)
        orig_flush, orig_make = self._orig

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def flush_inner(mb, pending, cause, buf, n, fkey):
            rec = dict(seq=next(probe._seq), fill=n, cause=cause)
            rec["e0"] = event()
            tls.rec = rec
            rec["t0"] = time.monotonic()
            rec["c0"] = (time.process_time(), time.thread_time())
            try:
                return orig_flush(mb, pending, cause, buf, n, fkey)
            finally:
                rec["c3"] = (time.process_time(), time.thread_time())
                rec["t3"] = time.monotonic()
                tls.rec = None
                rec["flush"] = mb.flushes[-1]
                probe.recs.append(rec)

        def make_network_fn(*a, **kw):
            fn = orig_make(*a, **kw)

            @functools.wraps(fn)
            def timed(x):
                rec = getattr(tls, "rec", None)
                if rec is None:          # a warm-up outside any flush
                    return fn(x)
                rec["t1"] = time.monotonic()
                rec["e1"] = event()
                out = fn(x)
                rec["e2"] = event()
                rec["t2"] = time.monotonic()
                return out
            return timed

        def on_gc(phase, info):
            # a full pass also names the code whose allocation set it off
            where = (_frames(sys._getframe(1))
                     if phase == "start" and info["generation"] == 2 else "")
            probe.gcs.append((phase, info["generation"], time.monotonic(),
                              threading.current_thread().name, where))

        self._on_gc = on_gc
        MicroBatcher._flush_inner = flush_inner
        ops.make_network_fn = make_network_fn
        gc.callbacks.append(on_gc)
        self._t_start = time.monotonic()
        return self

    def __exit__(self, *exc):
        import gc

        from repro_torch.kernels.lut_gather import ops
        from repro_torch.launch.batching import MicroBatcher

        MicroBatcher._flush_inner, ops.make_network_fn = self._orig
        gc.callbacks.remove(self._on_gc)
        return False

    def report(self, p50: float, p99: float) -> dict:
        """Each flush's split (ms) and the run's summary; logs the run's
        line, its largest flush and every long one."""
        import torch
        torch.cuda.synchronize()
        # collections: (start, end, generation, thread name, where)
        colls, open_ = [], {}
        for phase, gen, t, name, where in self.gcs:
            if phase == "start":
                open_[name] = (t, gen, where)
            elif name in open_:
                t0, g, where = open_.pop(name)
                colls.append((t0, t, g, name, where))
        flushes = []
        for r in sorted(self.recs, key=lambda r: r["seq"]):
            fr = r["flush"]
            end = r["t0"] + fr.kernel_s
            f = dict(seq=r["seq"], fill=fr.fill, cause=fr.cause,
                     tag=(fr.tag or "")[:12], failed=fr.failed,
                     waited_ms=fr.waited_s * 1e3,
                     engine_ms=fr.kernel_s * 1e3,
                     flush_ms=(r["t3"] - r["t0"]) * 1e3,
                     cpu_ms=(r["c3"][0] - r["c0"][0]) * 1e3,
                     own_cpu_ms=(r["c3"][1] - r["c0"][1]) * 1e3,
                     t_ms=(r["t0"] - self._t_start) * 1e3)
            if "t2" in r:
                f.update(host_ms=(r["t1"] - r["t0"]) * 1e3,
                         launch_ms=(r["t2"] - r["t1"]) * 1e3,
                         copy_ms=(end - r["t2"]) * 1e3,
                         complete_ms=(r["t3"] - end) * 1e3,
                         dev_pre_ms=r["e0"].elapsed_time(r["e1"]),
                         dev_ms=r["e1"].elapsed_time(r["e2"]))
            # collections that overlap the flush or its oldest request's
            # wait
            f["gcs"] = [[g, round((b - a) * 1e3, 3), name] + ([where]
                        if where else [])
                        for a, b, g, name, where in colls
                        if a < r["t3"] and b > r["t0"] - fr.waited_s]
            flushes.append(f)
        eng = np.array([f["engine_ms"] for f in flushes])
        med = float(np.median(eng))
        big = max(flushes, key=lambda f: f["engine_ms"])
        long_ = [f for f in flushes if f["engine_ms"] > LONG_FLUSH_X * med]
        gen_n = [sum(1 for c in colls if c[2] == g) for g in range(3)]
        # the longest collection while a request was waiting or served
        in_flush = max((g[1] for f in flushes for g in f["gcs"]),
                       default=0.0)
        out = dict(p50_ms=p50, p99_ms=p99, flushes=len(flushes),
                   median_ms=med, max_ms=big["engine_ms"],
                   long=len(long_), gc_by_gen=gen_n,
                   gc_max_ms=max(((c[1] - c[0]) * 1e3 for c in colls),
                                 default=0.0), gc_in_flush_ms=in_flush,
                   max_waited_ms=max(f["waited_ms"] for f in flushes),
                   largest=big, long_flushes=long_, each=flushes)
        log(f"{self.tag} p50 {p50:.3f} ms p99 {p99:.3f} ms, {len(flushes)} "
            f"flushes, engine ms median {med:.3f} max "
            f"{big['engine_ms']:.3f}, {len(long_)} over {LONG_FLUSH_X}x "
            f"the median; collections by generation "
            f"{gen_n} (longest {out['gc_max_ms']:.2f} ms, while requests "
            f"waited {in_flush:.2f} ms); oldest wait at most "
            f"{out['max_waited_ms']:.3f} ms")
        for f in [big] + [f for f in long_ if f is not big][:8]:
            log(f"{self.tag}   flush {f['seq']} at {f['t_ms']:.1f} ms: "
                + _flush_line(f))
        return out


def _flush_line(f) -> str:
    split = ("" if "dev_ms" not in f else
             f"host {f['host_ms']:.3f} (card before the forward "
             f"{f['dev_pre_ms']:.3f}), forward call {f['launch_ms']:.3f} "
             f"(card {f['dev_ms']:.4f}), wait + copy back "
             f"{f['copy_ms']:.3f}, completing {f['complete_ms']:.3f}; ")
    return (f"engine {f['engine_ms']:.3f} ms, fill {f['fill']} "
            f"({f['cause']}), waited {f['waited_ms']:.3f}: {split}flush "
            f"{f['flush_ms']:.3f} ms, CPU the process's {f['cpu_ms']:.3f} "
            f"the batcher's {f['own_cpu_ms']:.3f}; collections {f['gcs']}")


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
    named by its unmangled identifier; a kernel compiled in several
    instantiations reports the most any of them uses."""
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

    worst: dict = {}
    for k, r in out.items():
        row = (r, *props.get(k, (0, 0)))
        prev = worst.get(name(k), (0, 0, 0))
        worst[name(k)] = tuple(max(a, b) for a, b in zip(prev, row))
    return worst


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


def host_pauses(seconds: float = 1.0, wait_s: float = 2e-3) -> dict:
    """The host's own pauses, with this process idle but for one thread:
    that thread reads the clock in a tight loop for ``seconds`` (every
    gap between two reads over 1 ms is time the thread did not run),
    then times ``seconds / 4 / wait_s`` waits of ``wait_s`` on an event
    that is never set (what a batcher's deadline wait overshoots by),
    and reads the step of the process's CPU clock (about a microsecond
    on most Linux hosts; one scheduler tick where CPU time is counted in
    ticks)."""
    gaps, t = [], time.monotonic()
    t_end = t + seconds
    while t < t_end:
        now = time.monotonic()
        if now - t > 1e-3:
            gaps.append((now - t) * 1e3)
        t = now
    ev, over = threading.Event(), []
    for _ in range(int(seconds / 4 / wait_s)):
        t = time.monotonic()
        ev.wait(wait_s)
        over.append((time.monotonic() - t - wait_s) * 1e3)
    steps = []
    for _ in range(2):
        c0 = time.process_time()
        while (c1 := time.process_time()) == c0:
            pass
        steps.append(c1 - c0)
    return dict(gaps_over_1ms=len(gaps), cpu_step_ms=max(steps) * 1e3,
                gaps_over_5ms=sum(g > 5 for g in gaps),
                largest_gap_ms=max(gaps, default=0.0),
                wait_over_ms_p50=float(np.percentile(over, 50)),
                wait_over_ms_p99=float(np.percentile(over, 99)),
                wait_over_ms_max=max(over))


def log_host_pauses(tag) -> dict:
    hp = host_pauses()
    log(f"{tag} the host's pauses over 1 s of a clock loop, this process "
        f"otherwise idle: {hp['gaps_over_1ms']} over 1 ms, "
        f"{hp['gaps_over_5ms']} over 5 ms, largest "
        f"{hp['largest_gap_ms']:.3f} ms; 2 ms waits overshoot by p50 "
        f"{hp['wait_over_ms_p50']:.3f} p99 {hp['wait_over_ms_p99']:.3f} "
        f"max {hp['wait_over_ms_max']:.3f} ms; the CPU clock's step "
        f"{hp['cpu_step_ms']:.3f} ms")
    return hp


def check_collections(tag, runs) -> None:
    """No garbage collection over ``COLLECTION_BOUND_MS`` while a request
    of any run waited or was served (checked after all runs have
    logged); the largest flush of all runs is logged."""
    for i, r in enumerate(runs):
        check(r["gc_in_flush_ms"] <= COLLECTION_BOUND_MS,
              f"{tag} run {i + 1}: a garbage collection held requests "
              f"{r['gc_in_flush_ms']:.3f} ms, over {COLLECTION_BOUND_MS} "
              f"ms")
    p50s = [r["p50_ms"] for r in runs]
    p99s = [r["p99_ms"] for r in runs]
    log(f"{tag} {len(runs)} runs: p50 {min(p50s):.3f}-{max(p50s):.3f} ms, "
        f"p99 {min(p99s):.3f}-{max(p99s):.3f} ms, largest flush "
        f"{max(r['max_ms'] for r in runs):.3f} ms, collections while "
        f"requests waited at most "
        f"{max(r['gc_in_flush_ms'] for r in runs):.3f} ms (bound "
        f"{COLLECTION_BOUND_MS} ms)")


def serve_stream(dev, run, paths, rows, want, rate):
    """One [serve] stream: ``paths[0]`` registered, ``len(rows)`` Poisson
    requests at ``rate`` through the registry, a swap to ``paths[1]``
    half-way, every flush under a ``FlushProbe``.  Checks 0 failed, 0
    dropped, every answer equal to the plain forward of the version that
    gave it, both versions answering, kernel 1 launched (counts zeroed
    just before the stream, read just after).  -> (report, counts)"""
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.registry import ModelRegistry

    n_req = len(rows)
    tag = f"[serve] run {run}:"
    with FlushProbe(tag) as probe:
        reg = ModelRegistry(microbatch=256, deadline_s=2e-3, device=dev)
        reg.register("hdr-add2", paths[0])   # warm-up builds + launches
        if run == 1:
            log(f"[serve] registered {os.path.basename(paths[0])}: "
                f"{reg.get('hdr-add2').plan.describe()}")
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
        counts = K.launch_counts()
        # ----
        reg.close()
    failed = sum(1 for h in handles if h is None or h.failed)
    check(len(handles) == n_req and failed == 0,
          f"{tag} {failed} of {n_req} requests failed or were dropped")
    tags = {}
    for i, h in enumerate(handles):
        check(h.tag in want, f"{tag} request {i} answered by unknown tag "
              f"{h.tag}")
        check(np.array_equal(h.result(timeout=1.0), want[h.tag][i]),
              f"{tag} request {i} differs from the plain forward of "
              f"{h.tag[:12]}")
        tags[h.tag] = tags.get(h.tag, 0) + 1
    check(len(tags) == 2, f"{tag} the swap did not land mid-stream: {tags}")
    check(counts["lut_network_fused"] > 0,
          f"{tag} the registry served without launching the fused kernel")
    r = swap_report["r"]
    log(f"{tag} {n_req} requests at {rate:.0f}/s: 0 failed, 0 dropped, "
        f"answers by version {[(k[:12], v) for k, v in tags.items()]}, "
        f"swap warm {r.warm_s * 1e3:.2f} ms blackout "
        f"{r.blackout_s * 1e6:.1f} us")
    rep = probe.report(*latency_percentiles_ms(handles, qs=(50, 99)))
    rep.update(tags=tags, swap_warm_s=r.warm_s, swap_blackout_s=r.blackout_s,
               counts=counts)
    return rep, counts


def phase_serve(dev, results):
    import torch
    from repro_torch.artifact import load_artifact, save_artifact
    from repro_torch.configs import paper_models as PM
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref

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

        # the stream STREAM_RUNS times; the kernels line counts run 1
        pauses = log_host_pauses("[serve]")
        runs, served_counts = [], None
        for run in range(1, STREAM_RUNS + 1):
            rep, c = serve_stream(dev, run, paths, rows, want, rate)
            runs.append(rep)
            served_counts = served_counts or c
        # the pipelined and per-layer plans, on the same artifact
        K.reset_launch_counts()
        art = load_artifact(paths[1], unpack_int4=False, device=dev)
        x = torch.from_numpy(rows).to(dev)
        for kw in ({"pipeline": True}, {"fused": False}):
            fn = ops.make_network_fn(art, device=dev, **kw)
            for lo in range(0, n_req, 256):
                got = fn(x[lo:lo + 256]).cpu().numpy()
                check(np.array_equal(got, want[art.artifact_id][lo:lo + 256]),
                      f"make_network_fn({kw}) differs from plain forward")
        counts = {k: served_counts[k] + n
                  for k, n in K.launch_counts().items()}

    results["_serve"] = dict(requests=n_req, rate=rate, runs=runs,
                             host_pauses=pauses,
                             served_counts=served_counts, counts=counts)
    check_collections("[serve]", runs)
    for name in LUT_KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the "
              f"main path")
    log(f"[serve] launches on the main path (run 1 and the two plans): "
        f"{counts}")
    return counts


def phase_fleet(dev, results, n_req=8000, rate=4000.0):
    """The serving fleet across processes: two worker processes on the
    card (``LutFleet(transport="process")``, each its own CUDA context,
    the kernels loaded from the library ``[build]`` made) serve
    HDR-Add2 from a saved artifact under an open-loop Poisson stream.
    During the stream: a two-phase swap to a second seeded version
    whose slab transfer to r1 is corrupted in flight (refused by the
    worker's re-hash, re-fetched), then a SIGKILL of r0.  Every request
    must be answered (0 dropped, failed or hung), each answer equal bit
    for bit to the plain forward of the version that answered, no
    microbatch mixing versions, and kernel 1 launched in the surviving
    worker (counts zeroed in the workers just before the stream and
    read back over the wire just after)."""
    import torch
    from repro_torch.artifact import load_artifact, save_artifact
    from repro_torch.configs import paper_models as PM
    from repro_torch.kernels.lut_gather import ops, ref
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.fleet import LutFleet

    spec = PM.hdr_add2()
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 4, (n_req, spec.in_features)).astype(np.int32)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        paths, want = [], {}
        for seed in (31, 32):
            tables = random_tables(spec, seed, dev)
            path = save_artifact(tmp, tables, name=f"hdr-add2-s{seed}",
                                 spec=spec)
            art = load_artifact(path, device=dev)
            want[art.artifact_id] = ref.lut_network(
                torch.from_numpy(rows).to(dev),
                [a.plain() for a in ops._layer_args(art.tables, art.n_in)]
            ).cpu().numpy()
            paths.append(path)
        tags = list(want)
        with LutFleet(2, microbatch=256, deadline_s=2e-3,
                      transport="process", device=str(dev),
                      store_root=os.path.join(tmp, "fleet")) as fleet:
            t_up = time.perf_counter() - t_start
            fleet.distribute_artifact(paths[0], "hdr-add2")
            log(f"[fleet] 2 workers up in {t_up:.2f} s (pids "
                f"{[r.proc.pid for r in fleet.replicas]}), {spec.name} "
                f"admitted {fleet.admitted_tags('hdr-add2')}")
            handles: list = []
            swap: dict = {}

            def faults():
                time.sleep(0.25)
                fleet.inject_fetch_corruption("r1", n=1)
                prepared = fleet.prepare_swap("hdr-add2", paths[1])
                swap["dist"] = prepared.distribution
                swap["report"] = fleet.commit_swap(prepared)
                time.sleep(0.2)
                swap["stream_running_at_kill"] = feeder.is_alive()
                fleet.kill_replica("r0")              # SIGKILL mid-stream

            feeder = threading.Thread(daemon=True, target=lambda: (
                handles.extend(replay_open_loop(
                    fleet.client("hdr-add2"), rows, rate=rate, seed=5,
                    timeout_s=120.0))))
            # ---- the fleet's path: counts zeroed in each worker just
            # before, read back over the wire just after
            fleet.launch_counts(reset=True)
            feeder.start()
            faults()
            feeder.join(timeout=180.0)
            check(not feeder.is_alive(), "[fleet] the stream hung")
            counts = fleet.launch_counts()
            # ----
            stats = fleet.stats()
            members = fleet.membership()
    wall = time.perf_counter() - t_start
    check(len(handles) == n_req, f"[fleet] {n_req - len(handles)} "
          f"requests dropped at submit")
    failed = sum(1 for h in handles if h is None or h.failed)
    check(failed == 0, f"[fleet] {failed} of {n_req} requests failed")
    by_tag = dict.fromkeys(tags, 0)
    flush_tags: dict = {}
    for i, h in enumerate(handles):
        check(h.version_tag in by_tag, f"[fleet] request {i} answered by "
              f"unknown tag {h.version_tag}")
        check(np.array_equal(h.result(timeout=1.0),
                             want[h.version_tag][i]),
              f"[fleet] request {i} differs from the plain forward of "
              f"{h.version_tag[:12]}")
        by_tag[h.version_tag] += 1
        flush_tags.setdefault(h.flush_key, set()).add(h.version_tag)
    mixed = sum(1 for t in flush_tags.values() if len(t) > 1)
    check(mixed == 0, f"[fleet] {mixed} microbatches mixed versions")
    check(all(by_tag.values()), f"[fleet] the swap did not land "
          f"mid-stream: {by_tag}")
    rep, dist = swap["report"], swap["dist"]
    check(rep.new_tag == tags[1] and not rep.not_cut,
          f"[fleet] swap report {rep}")
    check(dist["r1"].fetches == 2 and dist["r1"].verify_failures == 1,
          f"[fleet] the corrupt transfer to r1 was not re-fetched: "
          f"{dist['r1']}")
    check(swap["stream_running_at_kill"], "[fleet] the SIGKILL landed "
          "after the stream ended")
    check(set(counts) == {"r1"} and not stats["r0"]["healthy"],
          f"[fleet] survivors {sorted(counts)}, stats {stats}")
    for rid, c in counts.items():
        check(c["lut_network_fused"] > 0, f"[fleet] kernel 1 never "
              f"launched in surviving worker {rid}: {c}")
    retried = sum(h.retries for h in handles)
    p50, p99 = latency_percentiles_ms(handles, qs=(50, 99))
    log(f"[fleet] {n_req} requests at {rate:.0f}/s through 2 workers: 0 "
        f"dropped, 0 failed, 0 hung, {retried} re-dispatched after the "
        f"SIGKILL of r0; answers by version "
        f"{[(k[:12], v) for k, v in by_tag.items()]}, bit for bit; "
        f"{len(flush_tags)} microbatches, none mixed")
    log(f"[fleet] latency p50 {p50:.3f} ms p99 {p99:.3f} ms; swap prepare "
        f"{rep.prepare_s * 1e3:.1f} ms (r1 fetched "
        f"{dist['r1'].fetches}x, {dist['r1'].verify_failures} refused), "
        f"commit window {rep.commit_window_s * 1e3:.2f} ms, blackout "
        f"{rep.max_blackout_s * 1e6:.1f} us; epoch {members['epoch']} "
        f"({[e['event'] for e in members['events']]}); phase wall "
        f"{wall:.1f} s")
    log(f"[fleet] launches in the surviving worker: {counts}")
    results["_fleet"] = dict(
        requests=n_req, rate=rate, p50_ms=p50, p99_ms=p99, by_tag=by_tag,
        retried=retried, swap_prepare_s=rep.prepare_s,
        swap_commit_window_s=rep.commit_window_s,
        swap_blackout_s=rep.max_blackout_s, worker_counts=counts,
        epoch=members["epoch"], wall_s=wall)
    return {k: sum(c.get(k, 0) for c in counts.values())
            for k in LUT_KERNELS}


# The [shards] phase: the batch split over device meshes.  Bit for bit at
# these batches (4097 and 37 leave remainders on four shards), slabs
# uint8 and int4, plans auto, pipelined, per-layer and a two-segment plan
# forced by a budget one byte short of the whole network at one row.
SHARD_BATCHES = (("hdr_add2", 11, (4096, 4097, 37, 1)),
                 ("jsc_xl_add2", 12, (4096, 37)))
SHARD_TIMED_BATCHES = (4096, 16384)
SHARD_REQUESTS, SHARD_RATE = 4000, 4000.0
SHARD_FLEET_REQUESTS = 2000


def _shard_plans(ops, tables, n_in0):
    """{name: SegmentPlan} of the four plans the [shards] phase runs."""
    budget = ops.fused_smem_bytes(tables, 1, n_in0) - 1
    plans = {"auto": ops.plan_segments(tables, n_in0=n_in0),
             "pipeline": ops.plan_segments(tables, n_in0=n_in0,
                                           pipeline=True),
             "per_layer": ops._per_layer_plan(n_in0,
                                              ops.SMEM_BUDGET_BYTES),
             "two_segments": ops.plan_segments(tables, n_in0=n_in0,
                                               budget=budget)}
    check(plans["two_segments"].n_segments == 2,
          f"[shards] the forced plan has {plans['two_segments'].n_segments}"
          f" segments, not 2")
    return plans


def phase_shards(dev, results):
    """The batch split over device meshes (``ops.lut_network_fused_
    sharded``, ``make_network_fn(mesh=)``): ``serving_mesh()`` over every
    visible card and ``serving_mesh(4, devices=[cuda:0] * 4)``, four
    shards on one card (a check of the sharded path, not of scaling).
    (1) HDR-Add2 and JSC-XL-Add2 at published widths, every batch, slab
    encoding and plan of SHARD_BATCHES / ``_shard_plans``: equal to the
    unsharded kernel-1 output and to the plain version bit for bit, on
    both meshes.  (2) HDR-Add2 int4 at B=4096 and 16384, the four-shard
    mesh against the unsharded call (CUDA events, and queued).  (3)
    ``tune_block_b`` on both networks: one time a launch (caps of one
    ``fused_geometry`` at the probe share it), the cap picked the
    largest among the launches level with the fastest, each cap's time,
    every cap's output equal to the plain version.  (4) The registry on
    the four-shard mesh: 4000 requests at 4000/s, 0 failed, every answer
    equal to the plain forward; then the pipelined and per-layer plans
    through ``make_network_fn(mesh=)``, four launches a call (one a
    shard).  (5) ``serve --lut --shards 1`` in-process: the unsharded
    run's accuracy on the same artifact; ``--shards`` past the visible
    cards raises ValueError.  (6) ``LutFleet(2, mesh=four-shard,
    transport="thread")``: 2000 requests across a two-phase swap, 0
    dropped or failed, bit for bit; ``transport="process"`` with a mesh
    raises ValueError.  Launch counts zeroed just before (4)-(6) and
    read just after."""
    import contextlib
    import io

    import torch
    from repro_torch.artifact import load_artifact, save_artifact
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.lut_synth import pack_tables_int4
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.lut_gather import ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.fleet import LutFleet
    from repro_torch.launch.registry import ModelRegistry
    from repro_torch.parallel.sharding import serving_mesh

    t_phase = time.perf_counter()
    meshes = {"cards": serving_mesh(),
              "one-card x4": serving_mesh(4, devices=[dev] * 4)}
    four = meshes["one-card x4"]
    log(f"[shards] meshes: " + "; ".join(f"{k} {m}"
                                          for k, m in meshes.items()))
    rng = np.random.default_rng(2027)

    # (1) bit for bit
    n_calls = 0
    for model, seed, batches in SHARD_BATCHES:
        spec = getattr(PM, model)()
        n_in0 = spec.in_features
        bits0 = spec.layer_specs()[0].in_quant.bits
        base = random_tables(spec, seed, dev)
        for packed in (False, True):
            tables = pack_tables_int4(base) if packed else base
            args = ops._layer_args(tables, n_in0, check_conn=True)
            net = K.FusedNet(args)
            plans = _shard_plans(ops, tables, n_in0)
            for B in batches:
                codes = random_codes(rng, B, n_in0, bits0, dev)
                plain = ref.lut_network(codes, [a.plain() for a in args])
                kernel1 = K.lut_network_fused(codes, net)
                check(torch.equal(kernel1, plain), f"[shards] {spec.name} "
                      f"B={B}: unsharded kernel 1 differs from plain")
                for mname, mesh in meshes.items():
                    for pname, plan in plans.items():
                        got = ops.lut_network_fused_sharded(
                            tables, codes, mesh, plan=plan)
                        n_calls += 1
                        check(got.shape == plain.shape
                              and got.device == dev
                              and torch.equal(got, kernel1)
                              and torch.equal(got, plain),
                              f"[shards] {spec.name} int4={packed} B={B} "
                              f"{mname} {pname}: sharded output differs")
            log(f"[shards] {spec.name} int4={packed}: sharded == unsharded "
                f"kernel 1 == plain at B={list(batches)}, plans "
                f"{ {k: (p.mode, p.n_segments) for k, p in plans.items()} },"
                f" meshes {list(meshes)}")
    torch.cuda.synchronize()
    log(f"[shards] {n_calls} sharded calls bit for bit")

    # (2) times: four shards on one card against the unsharded call
    spec = PM.hdr_add2()
    n_in0 = spec.in_features
    bits0 = spec.layer_specs()[0].in_quant.bits
    hdr = pack_tables_int4(random_tables(spec, 11, dev))
    single = ops.make_network_fn(hdr, n_in0=n_in0, device=dev)
    sharded = ops.make_network_fn(hdr, n_in0=n_in0, mesh=four)
    times = {}
    for B in SHARD_TIMED_BATCHES:
        inputs = [random_codes(rng, B, n_in0, bits0, dev) for _ in range(8)]
        check(torch.equal(sharded(inputs[0]), single(inputs[0])),
              f"[shards] timed B={B}: sharded differs from unsharded")
        row = {}
        for name, fn in (("unsharded", single), ("four shards", sharded),
                         ("four shards again", sharded),
                         ("unsharded again", single)):
            row[name] = (time_ms(fn, inputs), queued_ms(fn, inputs))
        times[B] = row
        log(f"[shards] time HDR-Add2 int4 B={B} (ms a forward, CUDA "
            f"events / queued): " + "; ".join(
                f"{k} {a:.4f} / {q:.4f}" for k, (a, q) in row.items()))

    # (3) the tuner
    tuned = {}
    for model, seed, _ in SHARD_BATCHES:
        spec_t = getattr(PM, model)()
        tables = pack_tables_int4(random_tables(spec_t, seed, dev))
        best, timings = ops.tune_block_b(tables, n_in0=spec_t.in_features)
        args = ops._layer_args(tables, spec_t.in_features)
        net = K.FusedNet(args)
        codes = random_codes(rng, 2048, spec_t.in_features,
                             spec_t.layer_specs()[0].in_quant.bits, dev)
        plain = ref.lut_network(codes, [a.plain() for a in args])
        for cap in timings:
            check(torch.equal(K.lut_network_fused(codes, net, max_rows=cap),
                              plain), f"[shards] tune {spec_t.name}: cap "
                  f"{cap} differs from plain")
        # one time a launch (caps of one fused_geometry share it), and
        # the largest cap among the launches level with the fastest
        widths = [t.conn.shape[0] for t in tables]
        launches = {}
        for cap in timings:
            launches.setdefault(K.fused_geometry(
                2048, net.n_sms, spec_t.in_features, widths, False,
                max_rows=cap), []).append(cap)
        level = [c for c, t in timings.items()
                 if t <= min(timings.values()) * (1 + ops.TUNE_LEVEL_MARGIN)]
        check(all(len({timings[c] for c in caps}) == 1
                  for caps in launches.values()) and best == max(level),
              f"[shards] tune {spec_t.name}: not one time a launch, or "
              f"cap {best} is not the largest level cap {max(level)}")
        tuned[model] = dict(best=best, seconds=timings,
                            launches=sorted(launches.values()))
        log(f"[shards] tune_block_b {spec_t.name} int4 at B=2048: "
            f"{len(launches)} launches {sorted(launches.values())} timed "
            f"once each; picks cap {best}, the largest within "
            f"{ops.TUNE_LEVEL_MARGIN:.0%} of the fastest; ms a call by cap "
            + ", ".join(f"{c}: {t * 1e3:.4f}"
                        for c, t in sorted(timings.items()))
            + "; every cap == plain")

    # (4)-(6): the serving entry points on the four-shard mesh
    rows = rng.integers(0, 4, (SHARD_REQUESTS, n_in0)).astype(np.int32)
    x_rows = torch.from_numpy(rows).to(dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shards-") as tmp:
        paths, want = [], {}
        for seed in (41, 42):
            tables = random_tables(spec, seed, dev)
            path = save_artifact(tmp, tables, name=f"hdr-add2-s{seed}",
                                 spec=spec)
            art = load_artifact(path, device=dev)
            want[art.artifact_id] = ref.lut_network(
                x_rows, [a.plain() for a in ops._layer_args(art.tables,
                                                           art.n_in)]
            ).cpu().numpy()
            paths.append(path)
        tags = list(want)
        reg = ModelRegistry(microbatch=256, deadline_s=2e-3, mesh=four)
        reg.register("hdr-add2", paths[0])     # warm-up builds + launches
        # ---- the main path: counts zeroed just before, read just after
        K.reset_launch_counts()
        handles = replay_open_loop(reg.client("hdr-add2"), rows,
                                   rate=SHARD_RATE, seed=4, timeout_s=120.0)
        reg_counts = K.launch_counts()
        art = load_artifact(paths[0], unpack_int4=False, device=dev)
        per_call = {}
        for kw, kernel in (({"pipeline": True},
                            "lut_network_fused_pipelined"),
                           ({"fused": False}, "lut_gather")):
            fn = ops.make_network_fn(art, mesh=four, **kw)
            before = K.launch_counts()[kernel]
            for lo in range(0, SHARD_REQUESTS, 256):
                got = fn(x_rows[lo:lo + 256]).cpu().numpy()
                check(np.array_equal(got, want[tags[0]][lo:lo + 256]),
                      f"[shards] make_network_fn(mesh=, {kw}) differs "
                      f"from the plain forward")
            per_call[kernel] = ((K.launch_counts()[kernel] - before)
                                / -(-SHARD_REQUESTS // 256))
        # (5) the CLI
        d = os.path.join(tmp, "cli")
        cli = {}
        for name, extra in (("unsharded", ["--save-artifact"]),
                            ("shards=1", ["--shards", "1"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli[name] = serve.main(
                    ["--lut", "--artifact-dir", d, "--requests", "2000",
                     "--rate", "4000", "--microbatch", "256"] + extra)
            log("\n".join(f"[shards] serve {name}: {ln}"
                          for ln in out.getvalue().splitlines()
                          if "lut-serve" in ln or "accuracy" in ln))
        visible = torch.cuda.device_count()
        try:
            serve.main(["--lut", "--artifact-dir", d, "--shards",
                        str(visible + 1)])
            refused = None
        except ValueError as e:
            refused = str(e)
        # (6) the fleet on the mesh
        fleet_handles: list = []
        with LutFleet(2, microbatch=256, deadline_s=2e-3, mesh=four,
                      transport="thread",
                      store_root=os.path.join(tmp, "fleet")) as fleet:
            fleet.distribute_artifact(paths[0], "hdr-add2")
            feeder = threading.Thread(daemon=True, target=lambda: (
                fleet_handles.extend(replay_open_loop(
                    fleet.client("hdr-add2"), rows[:SHARD_FLEET_REQUESTS],
                    rate=SHARD_RATE, seed=6, timeout_s=120.0))))
            feeder.start()
            time.sleep(SHARD_FLEET_REQUESTS / SHARD_RATE / 3)
            swap = fleet.commit_swap(fleet.prepare_swap("hdr-add2",
                                                        paths[1]))
            feeder.join(timeout=120.0)
            check(not feeder.is_alive(), "[shards] the fleet's stream hung")
        counts = K.launch_counts()
        # ----
        reg_stats = reg.stats()["hdr-add2"]
        reg.close()
        try:
            LutFleet(1, mesh=four, transport="process")
            process_refused = None
        except ValueError as e:
            process_refused = str(e)

    failed = sum(1 for h in handles if h is None or h.failed)
    check(len(handles) == SHARD_REQUESTS and failed == 0,
          f"[shards] registry: {failed} of {SHARD_REQUESTS} failed or "
          f"dropped")
    for i, h in enumerate(handles):
        check(np.array_equal(h.result(timeout=1.0), want[tags[0]][i]),
              f"[shards] registry request {i} differs from the plain "
              f"forward")
    check(reg_counts["lut_network_fused"] > 0 and
          reg_counts["lut_network_fused"] % 4 == 0,
          f"[shards] the registry's kernel-1 launches {reg_counts} are not "
          f"four a microbatch")
    check(per_call == {"lut_network_fused_pipelined": 4.0,
                       "lut_gather": 4.0 * len(spec.widths)},
          f"[shards] launches a call {per_call}: want one a shard (a "
          f"layer a shard for kernel 3)")
    check(cli["unsharded"].origin == "trained+saved"
          and cli["shards=1"].origin == "artifact"
          and cli["shards=1"].accuracy == cli["unsharded"].accuracy
          and cli["shards=1"].failed == cli["shards=1"].dropped == 0,
          f"[shards] serve --shards 1 accuracy "
          f"{cli['shards=1'].accuracy} != unsharded "
          f"{cli['unsharded'].accuracy}")
    check(refused is not None and f"{visible + 1} devices requested"
          in refused, f"[shards] serve --shards {visible + 1} did not "
          f"raise ValueError")
    check(process_refused is not None and "process transport"
          in process_refused, "[shards] a process fleet took a mesh")
    n_fleet = SHARD_FLEET_REQUESTS
    fleet_failed = sum(1 for h in fleet_handles if h is None or h.failed)
    check(len(fleet_handles) == n_fleet and fleet_failed == 0,
          f"[shards] fleet: {n_fleet - len(fleet_handles)} dropped, "
          f"{fleet_failed} failed")
    by_tag = dict.fromkeys(tags, 0)
    for i, h in enumerate(fleet_handles):
        check(h.version_tag in want and np.array_equal(
            h.result(timeout=1.0), want[h.version_tag][i]),
            f"[shards] fleet request {i} differs from the plain forward "
            f"of its version")
        by_tag[h.version_tag] += 1
    check(all(by_tag.values()), f"[shards] the fleet's swap did not land "
          f"mid-stream: {by_tag}")
    for name in LUT_KERNELS:
        check(counts[name] > 0, f"[shards] kernel {name} never launched")
    p50, p99 = latency_percentiles_ms(handles, qs=(50, 99))
    fp50, fp99 = latency_percentiles_ms(fleet_handles, qs=(50, 99))
    base = results.get("_serve", {})
    base_txt = (f"[serve]'s unsharded registry p50 "
                f"{min(r['p50_ms'] for r in base['runs']):.3f}-"
                f"{max(r['p50_ms'] for r in base['runs']):.3f} ms p99 "
                f"{min(r['p99_ms'] for r in base['runs']):.3f}-"
                f"{max(r['p99_ms'] for r in base['runs']):.3f} ms"
                if base else "[serve] not run")
    log(f"[shards] registry on four shards of one card: "
        f"{SHARD_REQUESTS} requests at {SHARD_RATE:.0f}/s, 0 failed, 0 "
        f"dropped, bit for bit; p50 {p50:.3f} ms p99 {p99:.3f} ms "
        f"({base_txt}); flushes {reg_stats['flushes']}")
    log(f"[shards] make_network_fn(mesh=) launches a call {per_call}; "
        f"serve --shards 1 accuracy {cli['shards=1'].accuracy:.4f} == "
        f"unsharded {cli['unsharded'].accuracy:.4f}; --shards "
        f"{visible + 1} refused: {refused}")
    log(f"[shards] fleet x2 on four shards: {n_fleet} requests, 0 dropped,"
        f" 0 failed, answers by version "
        f"{[(k[:12], v) for k, v in by_tag.items()]}, p50 {fp50:.3f} ms "
        f"p99 {fp99:.3f} ms, swap blackout "
        f"{swap.max_blackout_s * 1e6:.1f} us; process fleet refused: "
        f"{process_refused}")
    log(f"[shards] launches (registry, plans, CLI, fleet): {counts}")
    wall = time.perf_counter() - t_phase
    log(f"[shards] phase {wall:.1f} s")
    results["_shards"] = dict(
        bit_for_bit_calls=n_calls, times_ms=times, tuned=tuned,
        registry_p50_ms=p50, registry_p99_ms=p99,
        launches_per_call=per_call,
        cli_accuracy=cli["shards=1"].accuracy, fleet_p50_ms=fp50,
        fleet_p99_ms=fp99, fleet_by_tag=by_tag, counts=counts,
        wall_s=wall)
    return {k: counts.get(k, 0) for k in LUT_KERNELS}


# The [train] phase trains HDR-Add2 from two starts: init_model on a CPU
# generator seeded 0 and 1 (checksums below), each with its own batch
# order.  A_REF is the JAX package's mean test accuracy from the same two
# starts, same data, steps, batch and lr (0.6150000 and 0.6858333), on a
# CPU, from
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python aref_hdr_add2.py --seeds 0 1
# Runs from one start agree only to a few hundredths (the pre-BN bias
# trains on rounding noise, ROADMAP Queue 3), and from different starts
# spread by more than 0.1, so the phase holds the mean of its two runs.
A_REF = 0.6504166722297668
A_SLACK = 0.05
TRAIN_SEEDS = (0, 1)
INIT_CHECKSUMS = {0: "b7363638bdfa469b", 1: "9ec5a96cf19ed817"}
TRAIN_STEPS, TRAIN_LR, TRAIN_BATCH = 250, 5e-3, 256


@functools.lru_cache(maxsize=1)
def mnist_split(n_samples: int):
    """The procedural MNIST of ``[train]`` and ``[search]``
    (``make_dataset("mnist", n_samples, seed=0)``, split 80/20)."""
    from repro_torch.data.loader import train_test_split
    from repro_torch.data.synthetic import make_dataset
    return train_test_split(make_dataset("mnist", n_samples, seed=0))


def init_checksum(model) -> str:
    """A digest of a model's parameters and connectivity (their bytes
    on the CPU, leaf by leaf): equal digests mean the same start."""
    import hashlib
    h = hashlib.sha256()
    for leaf in list(_leaves(model["layers"])) + list(model["conn"]):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _code_disagreements(model, spec, tables, x):
    """Run the QAT eval forward layer by layer on the LUT path's own
    input codes and count the sub-neuron and layer-output codes where it
    and the tables disagree.  A layer-output code is a rounding of
    z = BN(sum of the quantized sub-neuron values): the forward computes
    z from the straight-through ``quantize`` values with BN as written,
    the tables from the grid values with BN folded to (scale, offset),
    and the two float32 results can fall on either side of a rounding
    boundary of the output quantizer.  So the layer-output codes are
    recomputed with the tables' own arithmetic, and each disagreement is
    measured: how far the forward's value lies from the boundary and how
    far the two z lie apart, in quantizer steps.  -> dict of counts and
    those measures."""
    import torch
    from repro_torch.core import layers as L
    from repro_torch.core import lut_synth as LS
    from repro_torch.core.quant import bn_apply_eval, bn_fold

    fq = spec.layer_specs()[0].in_quant
    codes = fq.to_code(fq.clip(x))
    out = dict(sub_bad=0, sub_all=0, out_bad=0, out_all=0, by_layer=[],
               neurons=0, tab_bad=0, boundary_steps=0.0, z_gap_steps=0.0)
    with torch.no_grad():
        for p, c, s, t in zip(model["layers"], model["conn"],
                              spec.layer_specs(), tables):
            x_q = s.in_quant.from_code(codes)
            pre = L.subneuron_transfer(p, s, x_q[:, c.long()])
            idx = LS.pack_index(codes[:, t.conn.long()], t.in_bits)
            sub = LS._gather_tables(t.sub_table, idx)        # (B, n, A)
            lut_out = LS.lut_layer_forward(t, codes)
            bn = bn_fold(p["bn"])
            if s.adder_width > 1:
                out["sub_bad"] += int((s.sub_quant.to_code(pre) != sub).sum())
                out["sub_all"] += sub.numel()
                z = bn_apply_eval(p["bn"], s.sub_quant.quantize(pre).sum(-1))
                z_tab = (s.sub_quant.from_code(sub).sum(-1) * bn.scale
                         + bn.offset)
            else:
                z = bn_apply_eval(p["bn"], pre[..., 0])
                z_tab = pre[..., 0] * bn.scale + bn.offset
            q = LS.OUTPUT_QUANT if s.is_output else s.out_quant
            if not s.is_output:
                z, z_tab = torch.relu(z), torch.relu(z_tab)
            bad = q.to_code(z) != lut_out
            out["tab_bad"] += int((q.to_code(z_tab) != lut_out).sum())
            out["by_layer"].append(int(bad.sum()))
            out["out_bad"] += int(bad.sum())
            out["out_all"] += lut_out.numel()
            if bad.any():
                pos = (q.clip(z) - q.low) / q.step
                edge = (pos - torch.floor(pos) - 0.5).abs()
                gap = (z - z_tab).abs() / q.step
                out["neurons"] += int(bad.any(0).sum())
                out["boundary_steps"] = max(out["boundary_steps"],
                                            float(edge[bad].max()))
                out["z_gap_steps"] = max(out["z_gap_steps"],
                                         float(gap[bad].max()))
            codes = lut_out
    return out


def synth_check(tag, model, spec, test, dev):
    """``synthesise`` a QAT model on the card -> (tables, their logits
    on the test split, stats).  Checks: ``lut_forward`` of the tables
    picks the QAT eval forward's argmax on every test sample, logits
    within ``OUTPUT_QUANT.step`` (the codes where forward and tables
    disagree are counted and measured), every layer-output code equal
    to the tables' own arithmetic recomputed on the test split; kernel 1
    through ``make_network_fn``'s default plan equals the plain codes
    bit for bit at the test split's size and at B=256."""
    import torch
    from repro_torch.core import lut_synth as LS
    from repro_torch.core import lutdnn as LD
    from repro_torch.kernels.lut_gather import ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = LS.synthesise(model, spec)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    fq = spec.layer_specs()[0].in_quant
    with torch.no_grad():
        net, _ = LD.forward(model, spec, test["x"])
    lut = LS.lut_forward(tables, test["x"], fq)
    agree = int((torch.argmax(net, -1) == torch.argmax(lut, -1)).sum())
    logit_err = (net - lut).abs().max().item()
    lut_acc = float((torch.argmax(lut, -1) == test["y"].long())
                    .float().mean())
    dis = _code_disagreements(model, spec, tables, test["x"])
    n_test = test["x"].shape[0]
    log(f"{tag} synthesise on the card: {synth_s:.3f} s; lut_forward vs "
        f"QAT forward on {n_test} test samples: argmax agree {agree}, "
        f"max logit difference {logit_err:.3e} (step "
        f"{LS.OUTPUT_QUANT.step:.3e}); codes disagreeing: sub-neuron "
        f"{dis['sub_bad']} of {dis['sub_all']}, layer outputs "
        f"{dis['out_bad']} of {dis['out_all']} (by layer "
        f"{dis['by_layer']}, in {dis['neurons']} neurons; the forward's "
        f"value at most {dis['boundary_steps']:.3e} steps from a rounding "
        f"boundary, the forward's and the tables' z at most "
        f"{dis['z_gap_steps']:.3e} steps apart; recomputed with the "
        f"tables' folded-BN arithmetic: {dis['tab_bad']}); LUT accuracy "
        f"{lut_acc:.4f}")
    check(agree == n_test, f"{tag} argmax differs on {n_test - agree} "
          f"test samples")
    check(logit_err <= LS.OUTPUT_QUANT.step + 1e-6,
          f"{tag} logits differ by {logit_err}")
    check(dis["tab_bad"] == 0, f"{tag} {dis['tab_bad']} layer-output codes "
          f"of the tables differ from the tables' own arithmetic")
    codes = fq.to_code(fq.clip(test["x"]))
    plain = codes
    for t in tables:
        plain = LS.lut_layer_forward(t, plain)
    fn = ops.make_network_fn(tables, device=dev)
    plan = fn.execution_plan
    check(plan.mode == "fused" and not plan.pipeline,
          f"{tag} default plan {plan.describe()} is not kernel 1")
    for B in (n_test, 256):
        check(torch.equal(fn(codes[:B]), plain[:B]),
              f"{tag} kernel 1 differs from plain lut_forward at B={B}")
    log(f"{tag} kernel 1 ({plan.describe()}) == plain lut_forward bit "
        f"for bit at B={n_test} and B=256")
    return tables, lut, dict(
        synth_s=synth_s, lut_accuracy=lut_acc, argmax_agree=agree,
        n_test=n_test, logit_err=logit_err,
        sub_codes_disagree=dis["sub_bad"], sub_codes=dis["sub_all"],
        out_codes_disagree=dis["out_bad"], out_codes=dis["out_all"],
        out_codes_disagree_by_layer=dis["by_layer"],
        out_codes_disagree_neurons=dis["neurons"],
        out_codes_disagree_table_arith=dis["tab_bad"],
        out_codes_disagree_boundary_steps=dis["boundary_steps"],
        out_codes_disagree_z_gap_steps=dis["z_gap_steps"])


def serve_check(tag, dev, d, tables, spec, data, lut, provenance,
                search=None, n_req=2000, runs=1):
    """Save the tables as an artifact under ``d`` (int4) and serve it by
    ``serve --lut --artifact-dir d --device cuda`` in-process, ``runs``
    times: each a cold load and ``n_req`` requests through the registry
    at 4000/s under a ``FlushProbe``.  Checks in each run 0 failed, 0
    dropped, the served accuracy equal to the tables' own on the same
    requests, and kernel 1 launched, its count zeroed just before and
    read just after; then no collection over ``COLLECTION_BOUND_MS``
    while a request of any run waited.  -> (run 1's result and counts,
    the artifact path, each run's report)"""
    import contextlib
    import io

    import torch
    from repro_torch.artifact import save_artifact
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.launch import serve

    fq = spec.layer_specs()[0].in_quant
    idx, _ = serve.request_codes(fq, data, n_req)
    want_acc = float((torch.argmax(lut, -1).cpu().numpy()[idx]
                      == data["test"]["y"][idx]).mean())
    path = save_artifact(d, tables, name="hdr-add2", spec=spec,
                         provenance=provenance, search=search)
    first, reports = None, []
    pauses = log_host_pauses(tag)
    for run in range(1, runs + 1):
        rtag = f"{tag} serve run {run}:"
        out = io.StringIO()
        with FlushProbe(rtag) as probe:
            # ---- the main path: counts zeroed just before, read just after
            K.reset_launch_counts()
            with contextlib.redirect_stdout(out):
                res = serve.main(["--lut", "--artifact-dir", d, "--device",
                                  str(dev), "--requests", str(n_req),
                                  "--rate", "4000", "--microbatch", "256"])
            counts = K.launch_counts()
            # ----
        text = out.getvalue()
        if run == 1:
            log("\n".join(f"{tag} serve: {ln}" for ln in text.splitlines()))
        check("lut-serve[artifact]" in text and res.origin == "artifact",
              f"{rtag} serve --lut did not cold-load the artifact")
        check(res.failed == 0 and res.dropped == 0 and res.served == n_req,
              f"{rtag} {res.failed} failed, {res.dropped} dropped of {n_req}")
        check(res.accuracy == want_acc, f"{rtag} served accuracy "
              f"{res.accuracy} != the tables' {want_acc} on those requests")
        check(counts["lut_network_fused"] > 0,
              f"{rtag} serve --lut never launched kernel 1")
        log(f"{rtag} {os.path.basename(path)}: {n_req} requests, 0 failed, "
            f"0 dropped, accuracy {res.accuracy:.4f} (the tables' own on "
            f"those rows {want_acc:.4f}); launches {counts}")
        rep = probe.report(res.p50_ms, res.p99_ms)
        rep.update(counts=counts, host_pauses=pauses)
        reports.append(rep)
        first = first or (res, counts)
    check_collections(tag, reports)
    return first[0], first[1], path, reports


def phase_train(dev, results, steps=TRAIN_STEPS, n_samples=12000):
    """HDR-Add2 trained, synthesised and served by the port on the card.
    (1) From each of A_REF's two starts, 250 QAT steps at lr 5e-3, B=256
    on the procedural MNIST (12000 samples, seed 0); the first run's
    steps 6-15 traced (device busy / idle share), steps 16-250 timed
    with CUDA events; mean test accuracy >= A_REF - 0.05.  The first
    run's model goes on.
    (2) ``synthesise`` on the card: ``lut_forward`` of the tables picks
    the QAT eval forward's argmax on every test sample, logits within
    ``OUTPUT_QUANT.step``; kernel 1 through ``make_network_fn``'s
    default plan equals the plain codes bit for bit at the test split's
    size and at B=256.  (3) The tables saved (int4) and served by
    ``serve --lut --artifact-dir D --device cuda`` (a cold load, ~2000
    requests through the registry): 0 failed, 0 dropped, accuracy equal
    to the tables' own on the same requests; kernel 1's launches counted
    from zero over this step.  (4) ``serve --lut --save-artifact`` trains
    the reference's default tiny jsc model from scratch on the card."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import paper_models as PM
    from repro_torch.core import lutdnn as LD
    from repro_torch.data.loader import batch_iterator, to_device
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    spec = PM.hdr_add2()
    data = mnist_split(n_samples)
    test = to_device(data["test"], dev)
    init_state, step = LD.make_train_step(spec, lr=TRAIN_LR)
    eval_step = LD.make_eval_step(spec)
    accs, models, step_ms = [], [], []
    for seed in TRAIN_SEEDS:
        # the start A_REF's runs took: drawn on the CPU, placed on dev
        state = init_state(torch.Generator().manual_seed(seed), device=dev)
        digest = init_checksum(state["model"])
        check(digest == INIT_CHECKSUMS[seed], f"[train] seed {seed}: start "
              f"{digest} is not A_REF's {INIT_CHECKSUMS[seed]}")
        it = batch_iterator(data["train"], TRAIN_BATCH, seed=seed,
                            device=dev)
        batches = [next(it) for _ in range(steps)]
        # (1) 5 warm-up steps, 10 traced (the first seed), the rest timed
        for b in batches[:5]:
            state, _ = step(state, b)
        if seed == TRAIN_SEEDS[0]:
            box = {"state": state}

            def ten_steps():
                for b in batches[5:15]:
                    box["state"], _ = step(box["state"], b)
            wall, per = profile_kernels(ten_steps)
            state = box["state"]
            busy = sum(ms for ms, _ in per.values())
            n_kernels = sum(n for _, n in per.values())
        else:
            for b in batches[5:15]:
                state, _ = step(state, b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches[15:]:
            state, met = step(state, b)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end) / (steps - 15))
        acc, _ = eval_step(state["model"], test)
        accs.append(float(acc))
        models.append(state["model"])
        log(f"[train] {spec.name} from start {seed} ({digest}): {steps} "
            f"steps B={TRAIN_BATCH} lr {TRAIN_LR}, {step_ms[-1]:.3f} ms a "
            f"step (CUDA events, steps 16-{steps}), last loss "
            f"{float(met['loss']):.4f}, test accuracy {accs[-1]:.4f}")
        del batches
    acc = sum(accs) / len(accs)
    log(f"[train] 10 traced steps (start {TRAIN_SEEDS[0]}): host wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms (idle share "
        f"{1 - busy / wall:.3f}; against the untraced step, "
        f"{1 - busy / 10 / step_ms[0]:.3f}), {n_kernels} kernels; mean test "
        f"accuracy {acc:.4f} (A_ref {A_REF:.4f} from the same starts, "
        f"floor {A_REF - A_SLACK:.4f})")
    check(acc >= A_REF - A_SLACK, f"[train] mean test accuracy {acc:.4f} "
          f"is below A_ref - {A_SLACK} = {A_REF - A_SLACK:.4f}")
    for m in models:
        for i, p in enumerate(m["layers"]):
            check(bool(torch.all(p["bn"]["gamma"] == 1))
                  and bool(torch.all(p["bn"]["beta"] == 0)),
                  f"[train] layer {i}: BN gamma/beta moved, unlike the "
                  f"reference")
    model = models[0]

    # (2) synthesise on the card, then the contract and kernel 1
    tables, lut, synth = synth_check("[train]", model, spec, test, dev)

    # (3) the saved artifact served through serve --lut on the card
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        d, e = os.path.join(tmp, "hdr"), os.path.join(tmp, "jsc")
        res, counts, _, served_runs = serve_check(
            "[train]", dev, d, tables, spec, data, lut,
            provenance={"dataset": "mnist", "n_samples": n_samples,
                        "train_steps": steps}, runs=STREAM_RUNS)

        # (4) train + synthesise + save through the entry point
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res4 = serve.main(["--lut", "--save-artifact", "--artifact-dir",
                               e, "--device", str(dev)])
        cli_s = time.perf_counter() - t0
        text = out.getvalue()
        log("\n".join(f"[train] serve: {ln}" for ln in text.splitlines()))
        check("lut-serve[trained+saved]" in text
              and res4.origin == "trained+saved" and res4.failed == 0
              and res4.dropped == 0,
              "[train] serve --lut --save-artifact did not train, save "
              "and serve")
    wall_phase = time.perf_counter() - t_phase
    log(f"[train] serve --lut --save-artifact (tiny jsc, 150 steps) "
        f"{cli_s:.2f} s, accuracy {res4.accuracy:.4f}; phase wall "
        f"{wall_phase:.1f} s")
    results["_train"] = dict(
        step_ms=step_ms, trace_wall_ms=wall, trace_busy_ms=busy,
        idle_share=1 - busy / wall,
        idle_share_untraced=1 - busy / 10 / step_ms[0],
        trace_kernels=n_kernels, accuracies=accs,
        accuracy=acc, a_ref=A_REF, **synth,
        served_accuracy=res.accuracy, served_runs=served_runs,
        counts=counts, cli_train_s=cli_s,
        cli_accuracy=res4.accuracy, wall_s=wall_phase)
    return {k: counts.get(k, 0) for k in LUT_KERNELS}


# The [search] phase searches HDR-Add2's connectivity as the reference's
# paper-scale MNIST test does (tests/test_system.py:205-223): a 4-member
# population, 100 steps of batch 256 (batch order 3), phase_frac 0.6,
# eps2 2e-3, lr 0.15; member p starts from init_search_model on a CPU
# generator seeded p (digests below).  The best member's masks retrain
# from [train]'s two starts.  A_REF_SEARCH is the JAX package's searched
# mean for that protocol on the CPU (its own jax.random search, key 3;
# retrained from the same two starts), from
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python aref_hdr_add2.py --search
A_REF_SEARCH = 0.7312500178813934
# the JAX run's random arm is A_REF (0.6150000 and 0.6858333 again), and
# its searched runs 0.7341667 and 0.7283334: the reference's claim,
# searched >= random - 0.01 (tests/test_system.py:223), holds there, so
# the phase holds it too
CLAIM_SLACK = 0.01
SEARCH_SEEDS = (0, 1, 2, 3)
SEARCH_INIT_CHECKSUMS = {0: "91713880299ab999", 1: "9054163e65a76521",
                         2: "df041dcf18bd7c1c", 3: "36e32bebf5dfd24c"}
SEARCH_STEPS, SEARCH_LR, SEARCH_BATCH = 100, 0.15, 256
SEARCH_PHASE_FRAC, SEARCH_EPS2, SEARCH_BATCH_SEED = 0.6, 2e-3, 3
PARITY_STEPS, PARITY_THETA_TOL = 5, 1e-5


def theta_checksum(tlayers) -> str:
    """A digest of a search start (theta, sign, bias of every layer,
    bytes on the CPU)."""
    import hashlib
    h = hashlib.sha256()
    for tl in tlayers:
        for leaf in (tl.theta, tl.sign, tl.bias):
            h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _search_state_to(state, dev):
    """A copy of a search state's tensors on ``dev`` (its generators
    stay: the parity run passes its draws)."""
    from repro_torch.optim.adamw import OptState, tree_map
    move = lambda t: t.detach().to(dev, copy=True)   # noqa: E731
    return {"tlayers": tree_map(move, state["tlayers"]),
            "opt": OptState(step=move(state["opt"].step),
                            mu=tree_map(move, state["opt"].mu), nu=None),
            "gens": state["gens"], "step": move(state["step"])}


def phase_search(dev, results, steps=SEARCH_STEPS, train_steps=TRAIN_STEPS,
                 n_samples=12000):
    """The SparseLUT toolflow on the card at HDR-Add2's published widths:
    search, select, masks -> conn, QAT retrain, synthesise, save with the
    search provenance, serve through ``serve --lut`` and kernel 1.
    (1) The first 5 steps on the card and on the CPU from the same start
    and the same draws (made on the CPU): equal active sets in every
    layer, theta within 1e-5.  (2) The population search through
    ``search_connectivity_population``: every member's end state holds
    exactly 8 actives per neuron in every layer (its ledger, and the
    extracted masks equal to its active sets; ``final_mask`` keeps 8 by
    construction, so the count of the masks alone proves nothing); a
    second run of the same start through ``make_search_step`` (steps
    6-15 traced, 16-45 timed by CUDA events) holds ``fan_in_violation
    <= 0`` at every step from the end of the ramp on and ends on the
    entry point's masks (the search is deterministic on the card).
    (3) The best member's masks retrained from [train]'s two starts
    (250 QAT steps, lr 5e-3), the first synthesised and served
    (``synth_check``, ``serve_check``) with ``search_provenance`` in
    its manifest.  (4) Searched mean accuracy >= A_REF_SEARCH - 0.05."""
    import hashlib

    import torch
    from repro_torch.artifact import verify_artifact
    from repro_torch.configs import paper_models as PM
    from repro_torch.core import lutdnn as LD
    from repro_torch.core import sparse_train as ST
    from repro_torch.data.loader import batch_iterator, to_device

    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "[search] TF32 is enabled for float32 products")
    t_phase = time.perf_counter()
    spec = PM.hdr_add2()
    data = mnist_split(n_samples)
    test = to_device(data["test"], dev)
    n_phase = int(steps * SEARCH_PHASE_FRAC)
    cfgs = LD.search_sparsity_configs(spec, n_phase, eps2=SEARCH_EPS2)
    ramp_end = int(np.ceil(max(n_phase * (1 - cfgs[0].cooldown_frac), 1)))
    _, step = LD.make_search_step(spec, cfgs, SEARCH_LR)

    def gens():
        return [torch.Generator().manual_seed(s) for s in SEARCH_SEEDS]

    def start():
        return LD.population_search_init(gens(), spec, cfgs, device=dev)

    def batches():
        return batch_iterator(data["train"], SEARCH_BATCH,
                              seed=SEARCH_BATCH_SEED, device=dev)

    state0 = start()
    for p, seed in enumerate(SEARCH_SEEDS):
        digest = theta_checksum(LD.population_member(state0, p)["tlayers"])
        check(digest == SEARCH_INIT_CHECKSUMS[seed], f"[search] member "
              f"{p}: start {digest} is not {SEARCH_INIT_CHECKSUMS[seed]}")

    # (1) card against the CPU path: same start, same draws
    draw_gens = [torch.Generator().manual_seed(100 + s)
                 for s in SEARCH_SEEDS]
    cpu = _search_state_to(state0, torch.device("cpu"))
    card = _search_state_to(state0, dev)
    it = batches()
    for i in range(PARITY_STEPS):
        b = next(it)
        draws = LD.search_draws(draw_gens, cpu["tlayers"])
        cpu, _ = step(cpu, {k: v.cpu() for k, v in b.items()}, draws)
        card, _ = step(card, b, [(n.to(dev), u.to(dev))
                                 for n, u in draws])
    same = [bool(torch.equal(a.theta > 0, b.theta.cpu() > 0))
            for a, b in zip(cpu["tlayers"], card["tlayers"])]
    theta_err = max((a.theta - b.theta.cpu()).abs().max().item()
                    for a, b in zip(cpu["tlayers"], card["tlayers"]))
    log(f"[search] {PARITY_STEPS} steps, card vs CPU from the same start "
        f"and draws: active sets equal per layer {same}, max |theta "
        f"difference| {theta_err:.3e}")
    check(all(same), "[search] card and CPU active sets differ")
    check(theta_err <= PARITY_THETA_TOL, f"[search] card and CPU theta "
          f"differ by {theta_err}")
    del cpu, card

    # (2) the search, through its entry point, from fresh generators of
    # the same seeds: state0's start, checked above
    del state0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks, scores, hist, states = LD.search_connectivity_population(
        gens(), spec, batches(), steps, phase_frac=SEARCH_PHASE_FRAC,
        lr=SEARCH_LR, eps2=SEARCH_EPS2, device=dev)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    ledger = ST.fan_in_ledger(states["tlayers"], cfgs)
    for i, (m, tl, row) in enumerate(zip(masks, states["tlayers"], ledger)):
        check(row["fan_in_min"] == row["fan_in_max"] == row["target_fan_in"]
              and torch.equal(m, (tl.theta > 0).to(m.dtype)),
              f"[search] layer {i}: the end states hold "
              f"{row['fan_in_min']}-{row['fan_in_max']} actives a neuron, "
              f"not {row['target_fan_in']}, or the masks are not their "
              f"active sets")
    log(f"[search] {len(SEARCH_SEEDS)} members x {steps} steps "
        f"(B={SEARCH_BATCH}, lr {SEARCH_LR}, phase_frac "
        f"{SEARCH_PHASE_FRAC}, eps2 {SEARCH_EPS2}): {search_s:.2f} s; "
        f"end states exactly {spec.layer_specs()[0].total_fan_in} actives "
        f"a neuron in every layer of every member, the extracted masks "
        f"their active sets; member scores "
        f"{[round(float(x), 4) for x in scores]}; fan_in_ledger {ledger}; "
        f"last history {hist[-1]}")

    # the reference protocol's own mesh (tests/test_system.py:205-223
    # searches on serving_mesh(2)): two shards of two members, here both
    # on this card, each stepping its sub-stack from its members' own
    # generators; it must end on the unsharded run's masks
    from repro_torch.parallel.sharding import serving_mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smasks, sscores, _, sstates = LD.search_connectivity_population(
        gens(), spec, batches(), steps, phase_frac=SEARCH_PHASE_FRAC,
        lr=SEARCH_LR, eps2=SEARCH_EPS2,
        mesh=serving_mesh(2, devices=[dev] * 2))
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    sharded_masks_equal = all(torch.equal(a, b)
                              for a, b in zip(smasks, masks))
    sharded_active_equal = all(
        torch.equal(a.theta > 0, b.theta > 0)
        for a, b in zip(sstates["tlayers"], states["tlayers"]))
    sharded_theta_diff = max((a.theta - b.theta).abs().max().item()
                             for a, b in zip(sstates["tlayers"],
                                             states["tlayers"]))
    sharded_best = LD.select_best_masks(smasks, sscores)[1]
    log(f"[search] on serving_mesh(2, devices=[{dev}] * 2): "
        f"{sharded_s:.2f} s (one device: {search_s:.2f} s); masks equal "
        f"to the unsharded run's: {sharded_masks_equal}; active sets "
        f"equal: {sharded_active_equal}; max |theta difference| "
        f"{sharded_theta_diff:.3e}; scores equal: "
        f"{bool(torch.equal(sscores, scores))}; best member "
        f"{sharded_best} (unsharded "
        f"{LD.select_best_masks(masks, scores)[1]})")
    check(sharded_masks_equal and sharded_active_equal,
          "[search] the search on two shards ends on other masks")
    check(sharded_best == LD.select_best_masks(masks, scores)[1],
          "[search] the search on two shards selects another member, so "
          "its best masks would retrain to another accuracy")
    del smasks, sstates

    # the same start again, step by step: cost and the fan-in invariant
    state = start()
    it = batches()
    run = [next(it) for _ in range(steps)]
    for b in run[:5]:
        state, _ = step(state, b)
    box = {"state": state}

    def ten_steps():
        for b in run[5:15]:
            box["state"], _ = step(box["state"], b)
    wall, per = profile_kernels(ten_steps)
    state = box["state"]
    busy = sum(ms for ms, _ in per.values())
    n_kernels = sum(n for _, n in per.values())
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for b in run[15:ramp_end]:
        state, _ = step(state, b)
    ev1.record()
    ev1.synchronize()
    step_ms = ev0.elapsed_time(ev1) / (ramp_end - 15)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    log("[search] the traced steps' device time by kernel (ms, launches): "
        + "; ".join(f"{name[:60]} {ms:.2f} ({n})" for name, (ms, n) in top))
    worst = []
    for b in run[ramp_end:]:
        state, _ = step(state, b)
        worst.append(ST.fan_in_violation(state["tlayers"], cfgs))
    worst = int(torch.stack(worst).max())
    again = ST.extract_masks(state["tlayers"], cfgs)
    rerun_equal = all(torch.equal(a, b) for a, b in zip(again, masks))
    log(f"[search] step by step from the same start: {step_ms:.3f} ms a "
        f"step (CUDA events, steps 16-{ramp_end}); 10 traced steps: host "
        f"wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
        f"{1 - busy / wall:.3f}; against the untraced step "
        f"{1 - busy / 10 / step_ms:.3f}), {n_kernels} kernels "
        f"({n_kernels / 10:.0f} a step); max fan_in_violation over steps "
        f"{ramp_end + 1}-{steps}: {worst}; masks equal to the entry "
        f"point's: {rerun_equal}")
    check(worst <= 0, f"[search] fan-in exceeds its target by {worst} "
          f"after the ramp")
    check(rerun_equal, "[search] the same start searched twice on the "
          "card ends on different masks")

    # (3) the best member's masks retrained from [train]'s starts
    best_masks, best = LD.select_best_masks(masks, scores)
    conn = LD.masks_to_conn(best_masks, spec)
    init_state, tstep = LD.make_train_step(spec, lr=TRAIN_LR)
    eval_step = LD.make_eval_step(spec)
    accs, models = [], []
    for seed in TRAIN_SEEDS:
        st = init_state(torch.Generator().manual_seed(seed), device=dev)
        digest = init_checksum(st["model"])
        check(digest == INIT_CHECKSUMS[seed], f"[search] seed {seed}: "
              f"start {digest} is not A_REF's {INIT_CHECKSUMS[seed]}")
        st["model"]["conn"] = conn
        it = batch_iterator(data["train"], TRAIN_BATCH, seed=seed,
                            device=dev)
        for _ in range(train_steps):
            st, _ = tstep(st, next(it))
        acc, _ = eval_step(st["model"], test)
        accs.append(float(acc))
        models.append(st["model"])
    acc = sum(accs) / len(accs)
    # the random arm is [train]'s; a partial run without [train]
    # (--phases search) compares with A_REF_SEARCH alone
    rand = results.get("_train", {}).get("accuracies")
    rand_mean = sum(rand) / len(rand) if rand else float("nan")
    log(f"[search] best member {best} (seed {SEARCH_SEEDS[best]}); "
        f"retrained {train_steps} QAT steps from [train]'s starts "
        f"{TRAIN_SEEDS}: test accuracy {[round(a, 4) for a in accs]}, "
        f"mean {acc:.4f}; random connectivity from the same starts "
        f"([train]) mean {rand_mean:.4f}{'' if rand else ' (not run)'}; "
        f"searched - random {acc - rand_mean:+.4f}; A_ref_search "
        f"{A_REF_SEARCH:.4f} (floor {A_REF_SEARCH - A_SLACK:.4f})")
    check(acc >= A_REF_SEARCH - A_SLACK, f"[search] searched mean "
          f"accuracy {acc:.4f} is below A_ref_search - {A_SLACK}")
    check(not rand or acc >= rand_mean - CLAIM_SLACK, f"[search] "
          f"searched mean {acc:.4f} is below random {rand_mean:.4f} - "
          f"{CLAIM_SLACK}")

    tables, lut, synth = synth_check("[search]", models[0], spec, test, dev)
    prov = LD.search_provenance(
        spec, cfgs, LD.population_member(states, best), n_steps=steps,
        lr=SEARCH_LR, seeds=[SEARCH_SEEDS[best]], history=hist)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-search-") as tmp:
        d = os.path.join(tmp, "hdr-searched")
        res, counts, path, served_runs = serve_check(
            "[search]", dev, d, tables, spec, data, lut,
            provenance={"dataset": "mnist", "n_samples": n_samples,
                        "train_steps": train_steps}, search=prov)
        manifest = verify_artifact(path)
        recomputed = hashlib.sha256(json.dumps(
            {"layers": manifest["layers"], "slabs": manifest["slabs"]},
            sort_keys=True).encode()).hexdigest()
    check(recomputed == manifest["artifact_id"]
          and path.endswith(recomputed[:12]),
          "[search] the searched artifact's id does not recompute")
    check(manifest.get("search") == json.loads(json.dumps(prov)),
          "[search] the manifest does not carry the search provenance")
    wall_phase = time.perf_counter() - t_phase
    log(f"[search] manifest search provenance: ledger "
        f"{manifest['search']['fan_in_ledger']}; id {recomputed[:12]} "
        f"recomputed; phase wall {wall_phase:.1f} s")
    results["_search"] = dict(
        parity_active_equal=same, parity_theta_err=theta_err,
        search_s=search_s, scores=[float(x) for x in scores], best=best,
        ledger=ledger, hist=hist, step_ms=step_ms, trace_wall_ms=wall,
        trace_busy_ms=busy, idle_share=1 - busy / wall,
        idle_share_untraced=1 - busy / 10 / step_ms,
        trace_kernels=n_kernels, kernels_a_step=n_kernels / 10,
        trace_top=[(name, ms, n) for name, (ms, n) in top],
        max_violation_after_ramp=worst, rerun_masks_equal=rerun_equal,
        sharded_s=sharded_s, sharded_masks_equal=sharded_masks_equal,
        sharded_theta_diff=sharded_theta_diff,
        sharded_scores=[float(x) for x in sscores],
        accuracies=accs, accuracy=acc, random_mean=rand_mean,
        a_ref_search=A_REF_SEARCH, **synth, served_accuracy=res.accuracy,
        served_runs=served_runs, counts=counts,
        artifact_id=recomputed, wall_s=wall_phase)
    return {k: counts.get(k, 0) for k in LUT_KERNELS}


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


# the kernels-bench layer (784 -> 256, F 6) at a 1024-row batch, a
# 4096-row one and a 16384-row training batch, the first past what the
# card holds resident (its blocks walk several tiles through the ring)
MM_LAYER = (784, 256, 6)
MM_BATCHES = (1024, 4096, 16384)


def mm_operands(dev, seed: int = 44):
    """conn, w and bias of ``MM_LAYER``, drawn on the card from a seed."""
    import torch
    n_in, n_out, F = MM_LAYER
    g = torch.Generator(device=dev).manual_seed(seed)
    conn = torch.randint(0, n_in, (n_out, F), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.randn((n_out, F), generator=g, device=dev)
    bias = torch.randn((n_out,), generator=g, device=dev)
    return g, conn, w, bias


def time_masked_mm(dev, results, batches=MM_BATCHES):
    """Kernel 4 at ``MM_LAYER`` for each batch, through its entry point
    (``ops.masked_matmul``, whatever tree's package is imported): held
    against both plain versions first, then timed by CUDA events, the
    profiler's device clock and ``queued_ms``, against the plain gather,
    the dense ``torch.addmm`` form (the library call) and the bound
    (counting only the columns ``conn`` reads).  Inputs rotate through
    more than the 50 MB L2.  Keys ``masked_matmul_b<B>``; returns (the
    largest error, one input a batch)."""
    import torch
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.masked_matmul import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # the dense oracle
    n_in, n_out, F = MM_LAYER
    g, conn, w, bias = mm_operands(dev)
    dense = ref.dense_weights(conn, w, n_in)
    cols = int(torch.unique(conn).numel())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometry = getattr(MM, "mm_geometry", None)
    max_abs = 0.0
    xs_of = {}
    for B in batches:
        xs = [torch.randn((B, n_in), generator=g, device=dev)
              for _ in range(max(2, -(-64 * 2 ** 20 // (4 * B * n_in))))]
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

        def kernel(x):
            return ops.masked_matmul(x, conn, w, bias)

        ms = time_ms(kernel, xs)
        dms = device_ms(kernel, xs, "masked_mm_kernel")
        qms = queued_ms(kernel, xs)
        plain_ms = time_ms(lambda x: ref.masked_matmul(x, conn, w, bias),
                           xs, iters=20)
        library_ms = time_ms(lambda x: torch.addmm(bias, x, dense), xs)
        library_dms = device_ms(lambda x: torch.addmm(bias, x, dense), xs,
                                per_call=None)
        nbytes = 4 * B * cols + 2 * 4 * n_out * F + 4 * n_out + \
            4 * B * n_out
        flops = 2 * B * n_out * F + B * n_out
        bms, by = bound_ms(nbytes, flops)
        geo = None if geometry is None else geometry(B, sms, n_in, n_out, F)
        results[f"masked_matmul_b{B}"] = dict(
            ms=ms, device_ms=dms, queued_ms=qms, plain_ms=plain_ms,
            library_ms=library_ms, library_device_ms=library_dms,
            bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
            columns_read=cols, batch=B,
            geometry=None if geo is None else str(geo))
        dtxt, ltxt = ("not measured" if t is None else f"{t:.4f} ms"
                      for t in (dms, library_dms))
        share = "" if dms is None else f", {bms / dms:.3f} of the bound " \
            f"on the device clock"
        log(f"[masked_mm] time B={B}: kernel {ms:.4f} ms (device {dtxt}, "
            f"queued {qms:.4f} ms), plain gather {plain_ms:.4f} ms, dense "
            f"addmm (library) {library_ms:.4f} ms (device {ltxt}), bound "
            f"{bms:.5f} ms ({by}: {nbytes} B for "
            f"{cols} of {n_in} columns, {flops} flops){share}; geometry "
            f"{geo}")
    return max_abs, xs_of


def phase_masked_mm(dev, results, batches=MM_BATCHES):
    import torch
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.masked_matmul import ops

    max_abs, xs_of = time_masked_mm(dev, results, batches)
    main = results[f"masked_matmul_b{batches[0]}"]
    results["masked_matmul"] = dict(
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], max_abs_err=max_abs)

    # ---- its entry point (no caller in the package but the tests):
    # counts zeroed just before, read just after
    _, conn, w, bias = mm_operands(dev)
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
        x, _, _ = LM.block_apply(cfg, kind, bp, x, None, cache["blocks"][i])
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
        yk, ck, _ = LM.block_apply(cfg, kind, bp, xs[i], None, zero)
        yp, cp, _ = LM.block_apply(plain, kind, bp, xs[i], None, zero)
        blk_rel = max(blk_rel, _rel_err(yk, yp)[1], _state_rel(ck, cp))
        states.append(ck)
    x = LM._embed(cfg, params, res.tokens[:, :1])
    for i, (kind, bp) in enumerate(zip(cfg.kinds, params["blocks"])):
        yk, ck, _ = LM.block_apply(cfg, kind, bp, x, None, states[i])
        yp, cp, _ = LM.block_apply(plain, kind, bp, x, None, states[i])
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
        _, cp, _ = LM.block_apply(cfg, kind, bp, xs[i], None,
                               LM.block_cache_init(cfg, kind, B, 64, dev))
        cd = LM.block_cache_init(cfg, kind, B, 64, dev)
        for t in range(64):
            _, cd, _ = LM.block_apply(cfg, kind, bp, xs[i][:, t:t + 1], None,
                                   cd)
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


# ---------------------------------------------------------------------------
# the attention LM family: qwen2.5-3b served, the SparseLUT-FFN LM trained
# ---------------------------------------------------------------------------

# Tolerances of [lm_attn], each a max error relative to the largest
# magnitude of the logits it is held to (``_rel_err``):
# - bf16 block by block against the same weights in float32, each block
#   fed the same (bf16) input: one block's bf16 roundings (unit roundoff
#   2^-9 at some 30 rounded ops), with no depth to amplify them;
LM_ATTN_BLOCK_TOL = 5e-2
# - the whole bf16 model against float32 (prefill and every decode step):
#   each block's roundings, carried through 36 blocks of random weights
#   (2.1e-2 measured on an H100; the limit is about 4x that);
LM_ATTN_BF16_TOL = 0.08
# - float32, prefill of 64 tokens then decode steps against one forward
#   over the same tokens, position by position: the same float32
#   arithmetic in other matmul shapes (other summation orders), TF32 off;
LM_ATTN_F32_TOL = 1e-3
# - decode with the int8 KV cache against the bf16 cache, same tokens:
#   K and V rounded to 1/254 of each token-head's largest magnitude
#   (2.8e-2 measured on an H100; the limit is about 3x that).
LM_ATTN_INT8_TOL = 0.08


def _example(name):
    """An example script of ``examples/`` as a module."""
    import importlib
    path = os.path.join(ROOT, "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _argmax_agree(got, want, bound):
    """Share of rows whose argmax agrees, over rows whose top-2 margin in
    ``want`` exceeds twice ``bound`` (absolute), and that row count."""
    import torch
    w = want.float()
    top2 = torch.topk(w, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * bound
    same = got.float().argmax(-1) == w.argmax(-1)
    n = int(clear.sum())
    # counted on the host: a float32 mean on the card multiplies the sum
    # by a rounded 1/n, and 110 agreeing rows came out as 0.99999994
    return (int(same[clear].sum()) / n if n else 1.0), n


def phase_lm_attn(dev, results, smoke=False, B=4, P=512, GEN=32):
    """qwen2.5-3b at full width by default (``smoke`` rehearses it)."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm as LM
    from repro_torch.models import registry as R

    torch.backends.cuda.matmul.allow_tf32 = False    # float32 checks
    arch = "qwen2.5-3b"
    t_phase = t0 = time.perf_counter()
    cfg, params = serve.init_lm(arch, smoke=smoke, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype)
          == (36, 2048, 16, 2, 128, 11008, 151936, torch.bfloat16),
          f"[lm_attn] not the full-width config: {cfg}")
    n_params = sum(t.numel() for t in _leaves(params))
    red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    log(f"[lm_attn] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}) x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{str(cfg.dtype)[6:]}; {n_params} weights ({n_params * 2 / 1e9:.2f}"
        f" GB) drawn on the card in {init_s:.2f} s; scores and values as "
        f"float32 products of upcast bf16 operands; cuBLAS bf16 "
        f"reduced-precision reduction allowed: {red}; TF32: "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    prompt = serve.make_prompt(cfg, B, P, seed=0, device=dev)
    serve.serve_lm(params, cfg, prompt[:, :64], gen=2)      # warm-up

    # ---- the main path: the serve module's loop at B x P, GEN steps
    res = serve.serve_lm(params, cfg, prompt, gen=GEN, keep_logits=True)
    # ----
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          "[lm_attn] non-finite logits")
    decode_ms = res.decode_s / GEN * 1e3
    log(f"[lm_attn] served B={B} x {P}-token prefill + {GEN} greedy decode "
        f"steps: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{decode_ms:.3f} ms/token step, {res.tokens_per_s:.1f} tokens/s; "
        f"first tokens {res.tokens[0, :8].tolist()}")
    out = dict(batch=B, prompt_len=P, gen=GEN, init_s=init_s,
               params=n_params, prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_step=decode_ms, tokens_per_s=res.tokens_per_s,
               bf16_reduced_precision_reduction=red)

    def whole_model(c, p, feed=res.tokens):
        """Prefill logits, then each decode step's, fed ``feed``."""
        logits, cache = R.make_prefill_step(c, P + GEN)(p, prompt)
        seq = [logits]
        step = R.make_serve_step(c)
        for i in range(GEN):
            logits, cache = step(p, cache, feed[:, i:i + 1], P + i)
            seq.append(logits)
        return seq

    # (1) bf16 against the same weights in float32, block by block on
    # the same inputs (prefill), then over the whole model
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    x = LM._embed(cfg, params, prompt)
    pos = torch.arange(P, device=dev)
    blk = 0.0
    for kind, bp, bp32 in zip(cfg.kinds, params["blocks"], p32["blocks"]):
        y16, _, _ = LM.block_apply(cfg, kind, bp, x, pos, None)
        y32, _, _ = LM.block_apply(c32, kind, bp32, x.float(), pos, None)
        blk = max(blk, _rel_err(y16, y32)[1])
        x = y16
    del x, y16, y32
    seq32 = whole_model(c32, p32)
    rels = [_rel_err(a, b)[1] for a, b in zip(res.logits, seq32)]
    agree, n_clear = _argmax_agree(
        torch.stack(res.logits), torch.stack(seq32),
        max(rels) * max(float(s.abs().max()) for s in seq32))
    log(f"[lm_attn] bf16 vs the same weights in float32: each block on the "
        f"same inputs (prefill) max error relative to scale {blk:.3e} "
        f"(tolerance {LM_ATTN_BLOCK_TOL}); whole model, logits: prefill "
        f"{rels[0]:.3e}, decode max {max(rels[1:]):.3e} (tolerance "
        f"{LM_ATTN_BF16_TOL}); argmax agrees on {agree:.4f} of the "
        f"{n_clear} rows whose margin clears twice the error")
    check(blk <= LM_ATTN_BLOCK_TOL,
          "[lm_attn] a bf16 block parts from its float32 self")
    check(max(rels) <= LM_ATTN_BF16_TOL,
          "[lm_attn] the bf16 model parts from its float32 self")
    check(agree == 1.0, "[lm_attn] bf16 argmax differs on a clear row")
    out.update(block_bf16_vs_f32_rel=blk, bf16_vs_f32_rel=rels,
               bf16_vs_f32_argmax_agree=agree, clear_rows=n_clear)
    del seq32

    # (2) float32: a 64-token prefill, then decode steps, against one
    # forward over the same tokens, position by position
    toks = serve.make_prompt(cfg, B, 64 + 16, seed=2, device=dev)
    with torch.no_grad():
        full, _ = LM.forward(p32, c32, toks)
    lp, cache = LM.prefill(p32, c32, toks[:, :64], 64 + 16)
    f32 = [_rel_err(lp, full[:, 63])[1]]
    for t in range(64, 64 + 16):
        ld, cache = LM.decode_step(p32, c32, cache, toks[:, t:t + 1], t)
        f32.append(_rel_err(ld, full[:, t])[1])
    del full, cache, p32
    torch.cuda.empty_cache()
    log(f"[lm_attn] float32, 64-token prefill + 16 decode steps vs one "
        f"forward over the 80 tokens: logits max error relative to scale "
        f"{max(f32):.3e} (tolerance {LM_ATTN_F32_TOL})")
    check(max(f32) <= LM_ATTN_F32_TOL,
          "[lm_attn] prefill + decode parts from the full forward")

    # (3) decode with the int8 KV cache, fed the same tokens
    c8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    seq8 = whole_model(c8, params)
    r8 = [_rel_err(a, b)[1] for a, b in zip(seq8, res.logits)]
    check(all(bool(torch.isfinite(lg).all()) for lg in seq8),
          "[lm_attn] non-finite int8-cache logits")
    agree8, n_clear8 = _argmax_agree(
        torch.stack(seq8), torch.stack(res.logits),
        max(r8) * max(float(s.abs().max()) for s in res.logits))
    log(f"[lm_attn] int8 KV cache vs bf16 cache, same tokens: logits max "
        f"error relative to scale: prefill {r8[0]:.3e}, decode max "
        f"{max(r8[1:]):.3e} (tolerance {LM_ATTN_INT8_TOL}); argmax agrees "
        f"on {agree8:.4f} of the {n_clear8} rows whose margin clears twice "
        f"the error")
    check(max(r8) <= LM_ATTN_INT8_TOL,
          "[lm_attn] the int8 KV cache parts from the bf16 cache")
    check(agree8 == 1.0, "[lm_attn] int8-cache argmax differs on a clear row")
    del seq8
    out.update(f32_prefill_decode_vs_forward_rel=f32, int8_vs_bf16_rel=r8,
               int8_vs_bf16_argmax_agree=agree8, int8_clear_rows=n_clear8)

    # (4) the CLI as a user calls it (the reference's flags, its default
    # batch 4, prompt 32 and 16 tokens), with the int8 cache
    buf = io.StringIO()
    argv = ["--arch", arch, "--kv-int8"]
    argv += ["--full"] if not smoke else ["--device", str(dev)]
    with contextlib.redirect_stdout(buf):
        cli = serve.main(argv)
    log(f"[lm_attn] serve {' '.join(argv)}: {buf.getvalue().strip()}")
    check("kv=int8" in buf.getvalue() and cli.tokens.shape == (4, 16)
          and bool(torch.isfinite(cli.tokens.float()).all()),
          "[lm_attn] serve --kv-int8 did not serve")
    out["cli_int8"] = dict(prefill_ms=cli.prefill_s * 1e3,
                           decode_ms_per_step=cli.decode_s / 16 * 1e3,
                           tokens_per_s=cli.tokens_per_s)
    del cli
    torch.cuda.empty_cache()

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
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[lm_attn] trace, {what}: host wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}), "
            f"{launches} kernels; top: "
            + "; ".join(f"{name[:48]} {ms:.2f} ms x{n}"
                        for name, (ms, n) in top))
        out[f"trace_{what.replace(' ', '_')}"] = dict(
            wall_ms=wall, device_busy_ms=busy, kernels=launches,
            top=[(name, ms, n) for name, (ms, n) in top])
    del params, cache
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm_attn] phase {out['phase_s']:.1f} s")
    results["_lm_attn"] = out


# [lm_train]: the example's model trained 100 steps on the card.  L_REF:
# the JAX package's mean loss over the last 10 of the same 100 steps
# (aref_lm.py, seeds 0 and 1, their mean), and the spread between them.
LM_TRAIN_STEPS, LM_TRAIN_B, LM_TRAIN_S = 100, 8, 128
LM_CKPT_EVERY, LM_FAIL_AT, LM_PARITY_STEPS = 25, 40, 5
# card vs CPU: boundary swaps allowed a step (2 seen at step 5 of 5 on an
# H100, 0 at steps 1-4)
LM_SWAP_MAX = 16
L_REF = 7.9919714450836175
L_REF_SPREAD = 0.0015013694763181817
L_SLACK = 0.05


def _tree_to(tree, dev):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _fan_stats(LM, cfg, params, step):
    """(max over leaves of (largest fan-in - f(step)), smallest fan-in)
    as device tensors."""
    import torch
    from repro_torch.core.sparse_train import scheduled_target
    scfg = LM.sparsity_config(cfg)
    excess, low = [], []
    for i, name in LM.theta_leaves(params):
        fan = (params["blocks"][i]["ffn"][name] > 0).sum(0)
        f = scheduled_target(scfg, step, cfg.d_model)
        excess.append(fan.max() - f)
        low.append(fan.min())
    return torch.stack(excess).max(), torch.stack(low).min()


def phase_lm_train(dev, results, smoke=False, steps=LM_TRAIN_STEPS,
                   B=LM_TRAIN_B, S=LM_TRAIN_S):
    """``examples/torch_lm_sparse_train.py``'s model at its published
    widths (``smoke`` rehearses it at 2 layers x 64 d), then the train
    CLI."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm as LM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "[lm_train] TF32 is enabled for float32 products")
    ex = _example("torch_lm_sparse_train")
    cfg = ex.lm_100m(sparse=True, steps=steps)
    if smoke:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                                  n_kv_heads=2, head_dim=16, d_ff=128,
                                  vocab=512, sparse_fan_in=8)
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.d_ff, cfg.vocab, cfg.dtype, cfg.sparse_fan_in)
          == (12, 512, 8, 4, 2048, 8192, torch.float32, 64),
          f"[lm_train] not the example's config: {cfg}")
    F = min(cfg.sparse_fan_in, cfg.d_model)
    init_state, step = LM.make_train_step(cfg, ex.optimizer(steps),
                                          remat=False)
    t_phase = t0 = time.perf_counter()
    start = init_state(torch.Generator().manual_seed(0), "cpu")
    n_params = sum(t.numel() for t in tree_leaves(start["params"]))
    log(f"[lm_train] {cfg.name}: {cfg.n_layers} layers x {cfg.d_model} d, "
        f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, float32, F_o {F}; {n_params} parameters drawn on the "
        f"CPU in {time.perf_counter() - t0:.2f} s; B={B} x {S}, {steps} "
        f"steps, sparse_phase_T {cfg.sparse_phase_T}")

    # (1) + (2): the trainer runs 100 steps on the card from the start
    # (checkpoints every 25, one failure injected at step 40) while a
    # thread runs the first 5 steps on the CPU from the same start,
    # batches and draws (made on the CPU); the card's first 5 steps take
    # those draws.  AdamW moves an element whose gradient is float noise
    # by a noise-set fraction of lr, so the two devices may part at the
    # controller's pruning boundary.  At every one of those steps an
    # element active on one side only must be, on that side, within
    # 2 x (the summed lr) of its column's smallest active theta, with
    # equal counts a column (a swap of near-tied thetas, no more), and
    # there are at most LM_SWAP_MAX such swaps.
    from repro_torch.optim.schedules import warmup_cosine
    t0 = time.perf_counter()
    draws = {k: LM.control_draws(cfg, start["params"], k)
             for k in range(1, LM_PARITY_STEPS + 1)}
    draws_s = time.perf_counter() - t0
    cpu = {}

    def thetas(params):
        return {(i, n): params["blocks"][i]["ffn"][n].cpu()
                for i, n in LM.theta_leaves(params)}

    def cpu_steps():
        s_cpu, b = start, ex.batches(cfg, B, S, "cpu")
        for k in range(1, LM_PARITY_STEPS + 1):
            s_cpu, m = step(s_cpu, next(b), draws=draws[k])
            cpu[k] = (float(m["loss"]), thetas(s_cpu["params"]))
        cpu["params"] = s_cpu["params"]

    card, at = {}, {"step": 0}

    def train_step(state, batch):
        k = at["step"] + 1
        d = _tree_to(draws[k], dev) if k in draws else None
        new, m = step(state, batch, draws=d)
        if k in draws:
            card[k] = (float(m["loss"]), thetas(new["params"]))
            if k == LM_PARITY_STEPS:
                card["params"] = new["params"]
        m = dict(m)
        m["fan_excess"], m["fan_min"] = _fan_stats(LM, cfg, new["params"],
                                                   new["opt"].step)
        return new, m

    failed = {"done": False}

    def hook(s):
        at["step"] = s
        if s == LM_FAIL_AT and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("injected failure")

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    worker = threading.Thread(target=cpu_steps)
    worker.start()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as tmp:
        tr = Trainer(TrainerConfig(ckpt_dir=tmp, ckpt_every=LM_CKPT_EVERY,
                                   keep=2),
                     train_step, _tree_to(start, dev), failure_hook=hook,
                     layout=LM.checkpoint_layout(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(ex.batches(cfg, B, S, dev), steps, log_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        worker.join()
        both_s = time.perf_counter() - t0
        torch.set_num_threads(threads)

        # card vs CPU, the first steps
        sched = warmup_cosine(3e-4, 20, steps)
        worst_loss, swaps, lr_sum = 0.0, [], 0.0
        n_theta = sum(t.numel() for t in cpu[1][1].values())
        worst_gap = 0.0
        for k in range(1, LM_PARITY_STEPS + 1):
            (lc, tc), (ld, td) = cpu[k], card[k]
            worst_loss = max(worst_loss, abs(lc - ld) / abs(lc))
            lr_sum += float(sched(torch.tensor(k)))
            n_swap = 0
            for key, t_cpu in tc.items():
                a, b = t_cpu > 0, td[key] > 0
                diff = a ^ b
                if not bool(diff.any()):
                    continue
                check(torch.equal(a.sum(0), b.sum(0)), f"[lm_train] step "
                      f"{k}: {key}: fan-ins differ between card and CPU")
                for t, m in ((t_cpu, a), (td[key], b)):
                    low = torch.where(m, t, float("inf")).min(0).values
                    gap = (t - low)[diff & m]
                    worst_gap = max(worst_gap, float(gap.max()))
                    check(bool((gap <= 2 * lr_sum).all()),
                          f"[lm_train] step {k}: {key}: active sets "
                          f"differ away from the pruning boundary "
                          f"({float(gap.max()):.3e} > {2 * lr_sum:.3e})")
                n_swap += int(diff.sum()) // 2
            swaps.append(n_swap)
        worst_param = max(float((a - b.cpu()).abs().max()) for a, b in zip(
            tree_leaves(cpu["params"]), tree_leaves(card["params"])))
        log(f"[lm_train] first {LM_PARITY_STEPS} steps, card vs CPU from "
            f"one start, batches and draws (drawn in {draws_s:.1f} s): loss "
            f"max relative difference {worst_loss:.3e} (tolerance 1e-5); "
            f"connections swapped at the pruning boundary by step {swaps} of "
            f"{n_theta} (each within 2 x summed lr of its column's smallest "
            f"active theta: largest gap {worst_gap:.3e}, bound at step "
            f"{LM_PARITY_STEPS} {2 * lr_sum:.3e}; allowed {LM_SWAP_MAX} a "
            f"step); parameters after step "
            f"{LM_PARITY_STEPS} max |difference| {worst_param:.3e}")
        check(worst_loss <= 1e-5, "[lm_train] card and CPU losses differ")
        check(max(swaps) <= LM_SWAP_MAX,
              "[lm_train] too many active-set swaps between card and CPU")
        del cpu, card

        hist = tr.history
        ramp_end = int(np.ceil(cfg.sparse_phase_T * 0.75))
        excess = max(h["fan_excess"] for h in hist)
        landed = hist[-(steps - ramp_end):]
        last10 = float(np.mean([h["loss"] for h in hist[-10:]]))
        log(f"[lm_train] Trainer: {tr.step} steps in {run_s:.2f} s with the "
            f"CPU's steps running beside it ({both_s:.2f} s until both were "
            f"done; {len(hist)} completed steps, checkpoints included), "
            f"recoveries {tr.recoveries}, straggler events "
            f"{tr.straggler_events}, checkpoints kept {tr.manager.steps()}; "
            f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, last 10 "
            f"steps {last10:.4f}; fan-in minus f(step), worst over every "
            f"step {excess:.0f}; fan-in from step {ramp_end} on "
            f"{min(h['fan_min'] for h in landed):.0f} to "
            f"{max(h['fan_excess'] for h in landed) + F:.0f}")
        check(tr.step == steps and tr.recoveries == 1 and failed["done"],
              "[lm_train] the injected failure was not recovered")
        check(excess <= 0, "[lm_train] a fan-in exceeded f(step)")
        check(all(h["fan_min"] == F and h["fan_excess"] <= 0
                  for h in landed),
              f"[lm_train] fan-in is not exactly {F} after the ramp")
        # (3) a new trainer resumes from the directory, bit for bit
        fresh = init_state(torch.Generator(device=dev).manual_seed(1), dev)
        tr2 = Trainer(TrainerConfig(ckpt_dir=tmp, ckpt_every=LM_CKPT_EVERY),
                      step, fresh, layout=LM.checkpoint_layout(cfg))
        check(tr2.try_resume() and tr2.step == steps,
              "[lm_train] no resume to the saved step")
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tr2.state), tree_leaves(tr.state)))
        log(f"[lm_train] a new Trainer resumed at step {tr2.step}: state "
            f"equal bit for bit: {same}")
        check(same, "[lm_train] the resumed state differs")
        state = tr.state
        del tr2, fresh
    out = dict(params=n_params, parity_loss_rel=worst_loss,
               parity_swaps=swaps, parity_param_abs=worst_param)
    if not smoke:
        tol = max(L_SLACK, 3 * L_REF_SPREAD)
        log(f"[lm_train] last-10-step loss {last10:.4f} vs L_REF {L_REF:.4f}"
            f" (JAX package, aref_lm.py): difference {last10 - L_REF:+.4f}, "
            f"tolerance {tol:.4f} = max({L_SLACK}, 3 x seed spread "
            f"{L_REF_SPREAD:.4f})")
        check(abs(last10 - L_REF) <= tol,
              "[lm_train] the loss parts from the JAX package's")
    # ms a step alone: 10 steps on the host clock
    b = next(ex.batches(cfg, B, S, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step(state, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    # where the time goes: two steps traced
    wall, per = profile_kernels(lambda: [step(state, b) for _ in range(2)])
    busy = sum(ms for ms, _ in per.values())
    launches = sum(n for _, n in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"[lm_train] {step_ms:.1f} ms a step alone (10 steps, host clock); "
        f"trace, 2 steps: host wall {wall / 2:.2f} ms a step, "
        f"device busy {busy / 2:.2f} ms (idle share {1 - busy / wall:.3f}), "
        f"{launches // 2} kernels a step; top: "
        + "; ".join(f"{name[:48]} {ms / 2:.2f} ms x{n // 2}"
                    for name, (ms, n) in top))
    out.update(steps=tr.step, recoveries=tr.recoveries, run_s=run_s,
               ms_per_step=step_ms, last10_loss=last10,
               losses=[h["loss"] for h in hist], fan_excess_max=excess,
               trace=dict(wall_ms_per_step=wall / 2,
                          device_busy_ms_per_step=busy / 2,
                          kernels_per_step=launches // 2,
                          top=[(name, ms / 2, n // 2)
                               for name, (ms, n) in top]))
    # the train CLI as a user calls it (the reference's flags and its
    # defaults: qwen2.5-3b smoke, 100 steps of B=8 x 64)
    buf = io.StringIO()
    n_cli = 100 if dev.type == "cuda" else 4
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp, \
            contextlib.redirect_stdout(buf):
        argv = ["--sparse-ffn", "--ckpt-dir", tmp, "--steps", str(n_cli)]
        cli = train.main(argv + ([] if dev.type == "cuda" else
                                 ["--device", str(dev), "--log-every", "2"]))
    log(f"[lm_train] python -m repro_torch.launch.train "
        f"{' '.join(argv[:1] + ['--ckpt-dir', 'D'] + argv[3:])}: "
        f"{buf.getvalue().strip()}")
    check(cli.step == n_cli and np.isfinite(cli.history[-1]["loss"]),
          "[lm_train] launch.train did not train")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm_train] phase {out['phase_s']:.1f} s")
    results["_lm_train"] = out


def phase_examples(dev, results, mnist_steps=30, serve_steps=40,
                   requests=512):
    """``torch_quickstart.py``, ``torch_mnist_sparselut.py`` and
    ``torch_lut_serve.py`` on the card; kernel 1's launches counted from
    zero over the phase."""
    import contextlib
    import io

    from repro_torch.kernels.lut_gather import lut_gather

    out = {}
    lut_gather.reset_launch_counts()
    t_phase = t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lut_acc, agree = _example("torch_quickstart").main(dev)
    text = buf.getvalue()
    log("[examples] torch_quickstart.py: " + text.strip().splitlines()[-1]
        + f" ({time.perf_counter() - t0:.1f} s)")
    check("argmax agreement with QAT model: 100.0%" in text,
          "[examples] quickstart: LUT mode parts from the QAT model")
    out["quickstart"] = dict(lut_acc=lut_acc, agree=agree)

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = _example("torch_mnist_sparselut").main(
            ["--steps", str(mnist_steps), "--device", str(dev)])
    log(f"[examples] torch_mnist_sparselut.py --steps {mnist_steps}: random "
        f"{np.mean(res['random']):.4f}, DeepR* {res['deepr']:.4f}, "
        f"SparseLUT {res['sparselut']:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(all(0.0 <= a <= 1.0 for a in res["random"] + [res["deepr"],
                                                        res["sparselut"]]),
          "[examples] mnist_sparselut: accuracies out of range")
    out["mnist_sparselut"] = res

    t0 = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ex-") as tmp, \
            contextlib.redirect_stdout(buf):
        res = _example("torch_lut_serve").main(
            ["--train-steps", str(serve_steps), "--requests", str(requests),
             "--artifact-dir", tmp, "--device", str(dev)])
    counts = lut_gather.launch_counts()
    for line in buf.getvalue().strip().splitlines()[-4:]:
        log(f"[examples] torch_lut_serve.py: {line.strip()}")
    for mid, r in res.items():
        check(r["served"] == requests and r["failed"] == 0
              and r["dropped"] == 0,
              f"[examples] lut_serve {mid}: not every request served")
    log(f"[examples] {time.perf_counter() - t0:.1f} s; kernel launches over "
        f"the phase: {counts}")
    check(counts.get("lut_network_fused", 0) > 0,
          "[examples] kernel 1 never launched")
    out.update(lut_serve=res, counts=counts,
               phase_s=time.perf_counter() - t_phase)
    log(f"[examples] phase {out['phase_s']:.1f} s")
    results["_examples"] = out
    return {k: counts.get(k, 0) for k in LUT_KERNELS}


# ---------------------------------------------------------------------------
# the last model families: MoE, the RG-LRU hybrid, the encoder-decoder
# ---------------------------------------------------------------------------

# Tolerances of [lm_moe], [lm_rglru] and [encdec], each a max error
# relative to the largest magnitude of what it is held to (``_rel_err``):
# - one MoE block in bf16 against an independent float32 loop over the
#   experts (each expert on exactly its tokens, at its capacity rank),
#   same bf16 input: the block's bf16 roundings (unit roundoff 2^-9 at
#   the expert products, the gate multiply and k sequential adds);
LM_MOE_EXPERT_TOL = 2e-2
# - bf16 block by block against the same weights in float32, each block
#   fed the same (bf16) input, as [lm_attn]; for an MoE block over the
#   tokens whose routes (top-k set and kept slots) agree in both dtypes,
#   at most LM_MOE_FLIP_SHARE of a block's tokens routed otherwise (a
#   near tie between the k-th and k+1-th expert that rounding decides);
LM_FAMILY_BLOCK_TOL = 5e-2
LM_MOE_FLIP_SHARE = 0.15
# - the whole bf16 model against float32 (prefill and every decode
#   step): granite's routes part at near ties in every layer, each a
#   swapped expert of a token (its gate about 1/8), so the logits part
#   more than a dense model's (H100 runs read 2.971e-02 and 5.608e-02;
#   the limit was 0.3 before those readings); recurrentgemma and whisper
#   as [lm_attn];
LM_MOE_BF16_TOL = 0.15
LM_RGLRU_BF16_TOL = 0.1
ENCDEC_BF16_TOL = 0.08
# - float32, prefill then decode steps against one forward (and, for
#   the RG-LRU, 64 decode steps' state against a 64-token prefill's):
#   the same float32 arithmetic in other shapes, TF32 off; for an MoE
#   model over the batch rows whose routes agree at every position and
#   layer (a route decided by a float32 near tie parts a row); H100 runs
#   read 1.2e-06 to 3.9e-06 (the limit was 1e-3 before those readings);
LM_FAMILY_F32_TOL = 1e-4


def _phase_start(tag):
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 checks
    return time.perf_counter()


def _phase_end(tag, out, results, t_phase):
    import torch
    torch.cuda.empty_cache()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase {out['phase_s']:.1f} s, max memory allocated "
        f"{out['max_memory_allocated_gb']:.2f} GB")
    results[f"_{tag}"] = out


def _log_config(tag, cfg, params, init_s):
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg}; {n} weights ({nbytes / 1e9:.2f} GB) "
        f"drawn on the card in {init_s:.2f} s")
    return n


def _serve_and_check(tag, serve, params, cfg, prompt, gen):
    """``serve_lm`` (the main path) -> its result; all logits finite."""
    import torch
    res = serve.serve_lm(params, cfg, prompt, gen=gen, keep_logits=True)
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          f"[{tag}] non-finite logits")
    B, P = prompt.shape
    log(f"[{tag}] served B={B} x {P}-token prefill + {gen} greedy decode "
        f"steps: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{res.decode_s / gen * 1e3:.3f} ms/token step, "
        f"{res.tokens_per_s:.1f} tokens/s; first tokens "
        f"{res.tokens[0, :8].tolist()}")
    return res


def _whole_model(R, c, p, prompt, feed):
    """Prefill logits, then each decode step's, fed ``feed``."""
    P, gen = prompt.shape[1], feed.shape[1]
    logits, cache = R.make_prefill_step(c, P + gen)(p, prompt)
    seq = [logits]
    step = R.make_serve_step(c)
    for i in range(gen):
        logits, cache = step(p, cache, feed[:, i:i + 1], P + i)
        seq.append(logits)
    return seq


def _bf16_vs_f32(tag, R, cfg, params, c32, p32, prompt, res):
    """The whole bf16 model against float32 over the served tokens ->
    (relative errors, argmax agreement, clear rows)."""
    import torch
    seq32 = _whole_model(R, c32, p32, prompt, res.tokens)
    rels = [_rel_err(a, b)[1] for a, b in zip(res.logits, seq32)]
    agree, n_clear = _argmax_agree(
        torch.stack(res.logits), torch.stack(seq32),
        max(rels) * max(float(s.abs().max()) for s in seq32))
    check(agree == 1.0, f"[{tag}] bf16 argmax differs on a clear row")
    return rels, agree, n_clear


class _Routes:
    """Records what every ``moe_apply`` routes while it is entered:
    each call's top-k sets (sorted expert ids, (T, k)) and which
    assignments kept a slot (in the same order)."""

    def __init__(self, NN):
        self.NN, self.calls = NN, []

    def __enter__(self):
        import torch
        NN = self.NN
        self._route, self._dispatch = NN.moe_route, NN.moe_dispatch

        def route(p, s, xt):
            out = self._route(p, s, xt)
            self.calls.append([out[1]])
            return out

        def dispatch(s, eids, cap):
            out = self._dispatch(s, eids, cap)
            order = torch.argsort(eids, dim=-1)
            self.calls[-1] = [eids.gather(1, order),
                              out[3].gather(1, order)]
            return out

        NN.moe_route, NN.moe_dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.NN.moe_route, self.NN.moe_dispatch = self._route, self._dispatch

    def keys(self, i):
        """(T,) a token's route as one comparable row: expert ids, then
        kept flags."""
        import torch
        e, k = self.calls[i]
        return torch.cat([e, k.long()], dim=-1)


def moe_loop_f32(p, s, x, no_drop=False, route=None):
    """The MoE block as a plain float32 loop over experts, independent of
    ``moe_apply``: route by ``torch.topk`` of the float32 router (or take
    ``route``, (gates, eids) each (T, k)), then for each expert its
    tokens in token order, the first ``cap`` of them kept
    (``moe_capacity`` of x's tokens), through the expert's SwiGLU with
    its weights upcast (only the experts some token chose).  -> (y
    float32 (B, S, D), kept (T, k) in top-k order, eids (T, k))."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as NN
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D).float()
    if route is None:
        probs = torch.softmax(xt @ p["router"]["w"], dim=-1)
        gates, eids = torch.topk(probs, s.top_k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True)
    else:
        gates, eids = (t.reshape(T, s.top_k) for t in route)
        gates = gates.float()
    cap = NN.moe_capacity(s, T, no_drop)
    kept = torch.zeros_like(eids, dtype=torch.bool)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in torch.unique(eids).tolist():
        tok, j = torch.nonzero(eids == e, as_tuple=True)   # token order
        tok, j = tok[:cap], j[:cap]
        kept[tok, j] = True
        w = {n: p["experts"][n][e].float() for n in ("w_in", "w_gate",
                                                     "w_out")}
        rows = xt[tok]
        h = F.silu(rows @ w["w_gate"]) * (rows @ w["w_in"])
        y[tok] += gates[tok, j, None] * (h @ w["w_out"])
    if "shared" in p:
        sh = {n: t.float() for n, t in p["shared"].items()}
        y += NN.ffn_apply(sh, "swiglu", xt)
    return y.reshape(B, S, D), kept, eids


def _moe_block_check(tag, NN, cfg, bp, x):
    """One MoE block's channel on the card against ``moe_loop_f32`` at the
    prefill's capacity -> (relative error, dropped assignments)."""
    import torch
    s = cfg.moe_spec()
    with _Routes(NN) as routes:
        y, _ = NN.moe_apply(bp["moe"], s, x)
    y32, kept, eids = moe_loop_f32(bp["moe"], s, x)
    e_sorted, keep_sorted = routes.calls[0]
    order = torch.argsort(eids, dim=-1)
    same = (torch.equal(e_sorted, eids.gather(1, order))
            and torch.equal(keep_sorted, kept.gather(1, order)))
    rel = _rel_err(y, y32)[1]
    dropped = int((~kept).sum())
    log(f"[{tag}] MoE block ({s.n_experts} experts, top {s.top_k}"
        f"{', shared expert' if s.shared_expert else ''}) on "
        f"{x.shape[0]} x {x.shape[1]} tokens against a float32 loop over "
        f"its experts: max error relative to scale {rel:.3e} (tolerance "
        f"{LM_MOE_EXPERT_TOL}); capacity "
        f"{NN.moe_capacity(s, x.shape[0] * x.shape[1])}, {dropped} of "
        f"{kept.numel()} assignments dropped; same routes and drops: "
        f"{same}")
    check(same, f"[{tag}] the MoE block routes or drops otherwise than "
          f"the float32 loop")
    check(rel <= LM_MOE_EXPERT_TOL,
          f"[{tag}] the MoE block parts from the float32 loop")
    return rel, dropped


def _blocks_bf16_vs_f32(tag, LM, NN, cfg, params, c32, p32, prompt):
    """Each block in bf16 against float32 on the same bf16 input (the
    prefill's residual stream) -> (max relative error over the tokens
    routed alike, worst share of tokens routed otherwise)."""
    import torch
    x = LM._embed(cfg, params, prompt)
    pos = torch.arange(prompt.shape[1], device=prompt.device)
    worst, flip = 0.0, 0.0
    for kind, bp, bp32 in zip(cfg.kinds, params["blocks"], p32["blocks"]):
        with _Routes(NN) as routes:
            y16, _, _ = LM.block_apply(cfg, kind, bp, x, pos, None)
            y32, _, _ = LM.block_apply(c32, kind, bp32, x.float(), pos, None)
        if routes.calls:
            alike = (routes.keys(0) == routes.keys(1)).all(-1)
            flip = max(flip, 1.0 - float(alike.float().mean()))
            alike = alike.reshape(x.shape[:2])
            worst = max(worst, _rel_err(y16[alike], y32[alike])[1])
        else:
            worst = max(worst, _rel_err(y16, y32)[1])
        x = y16
    log(f"[{tag}] bf16 vs the same weights in float32, each block on the "
        f"same inputs (prefill): max error relative to scale {worst:.3e} "
        f"(tolerance {LM_FAMILY_BLOCK_TOL})"
        + (f" over the tokens routed alike; worst block routes "
           f"{flip:.4f} of its tokens otherwise (limit "
           f"{LM_MOE_FLIP_SHARE})" if cfg.n_experts else ""))
    check(worst <= LM_FAMILY_BLOCK_TOL,
          f"[{tag}] a bf16 block parts from its float32 self")
    check(flip <= LM_MOE_FLIP_SHARE,
          f"[{tag}] too many tokens routed otherwise in bf16")
    return worst, flip


def _lm_runs(R, cfg, params, prompt, feed):
    """(what, fn) of one prefill of ``prompt`` and of two decode steps
    after it, fed ``feed``, through the registry's steps."""
    prefill = R.make_prefill_step(cfg, prompt.shape[1] + 2)
    step = R.make_serve_step(cfg)
    P = prompt.shape[1]
    _, cache = prefill(params, prompt)
    return (("prefill", lambda: prefill(params, prompt)),
            ("2 decode steps", lambda: [step(params, cache, feed[
                :, i:i + 1], P + i) for i in range(2)]))


def _trace(tag, runs, out, categories=()):
    """Each (what, fn) of ``runs`` once under the profiler: host wall,
    device busy, idle share, kernels, top kernels, and the device time of
    the kernels whose names hold each of ``categories``' words."""
    for what, fn in runs:
        wall, per = profile_kernels(fn)
        busy = sum(ms for ms, _ in per.values())
        launches = sum(n for _, n in per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
        cats = {c: sum(ms for name, (ms, _) in per.items()
                       if any(w in name.lower() for w in words))
                for c, words in categories}
        log(f"[{tag}] trace, {what}: host wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}), "
            f"{launches} kernels; top: "
            + "; ".join(f"{name[:48]} {ms:.2f} ms x{n}"
                        for name, (ms, n) in top)
            + "".join(f"; {c} {ms:.2f} ms ({ms / busy:.3f} of busy)"
                      for c, ms in cats.items()))
        out[f"trace_{what.replace(' ', '_')}"] = dict(
            wall_ms=wall, device_busy_ms=busy, kernels=launches,
            top=[(name, ms, n) for name, (ms, n) in top], categories=cats)


# kernel-name words of the MoE dispatch's own work (the router's sort,
# the slot bookkeeping's sorts and scans, the gathers and copies)
MOE_DISPATCH_WORDS = (
    ("sorts", ("sort",)),
    ("gathers, scatters, index", ("gather", "scatter", "index")),
    ("copies, cat, where", ("copy", "cat", "where")),
)


def phase_lm_moe(dev, results, smoke=False, B=4, P=512, GEN=32,
                 KB=2, KP=128, KGEN=8):
    """granite-moe-1b-a400m at full width, then kimi-k2 at its published
    widths cut to 2 layers (``smoke`` rehearses both at their smoke
    configs)."""
    import dataclasses

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import layers as NN
    from repro_torch.models import lm as LM
    from repro_torch.models import registry as R

    tag = "lm_moe"
    t_phase = t0 = _phase_start(tag)
    cfg, params = serve.init_lm("granite-moe-1b-a400m", smoke=smoke,
                                device=dev, seed=0)
    torch.cuda.synchronize()
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, cfg.n_experts, cfg.top_k, cfg.moe_d_ff,
                    cfg.vocab, cfg.dtype)
          == (24, 1024, 16, 8, 64, 32, 8, 512, 49155, torch.bfloat16),
          f"[{tag}] not the full-width config: {cfg}")
    n_params = _log_config(tag, cfg, params, time.perf_counter() - t0)
    prompt = serve.make_prompt(cfg, B, P, seed=0, device=dev)
    serve.serve_lm(params, cfg, prompt[:, :64], gen=2)      # warm-up

    # ---- the main path: the serve module's loop at B x P, GEN steps
    res = _serve_and_check(tag, serve, params, cfg, prompt, GEN)
    # ----
    out = dict(params=n_params, batch=B, prompt_len=P, gen=GEN,
               prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_step=res.decode_s / GEN * 1e3,
               tokens_per_s=res.tokens_per_s)

    # (1) the MoE block against the float32 loop over its experts, on
    # the first block's channel input at the prefill's shape
    bp = params["blocks"][0]
    x = LM._embed(cfg, params, prompt)
    a, _ = NN.attn_apply(bp["attn"], cfg.attn_spec("attn"),
                         LM._norm_apply(cfg, bp["norm1"], x),
                         torch.arange(P, device=dev))
    h2 = LM._norm_apply(cfg, bp["norm2"], x + a)
    out["moe_block_rel"], _ = _moe_block_check(tag, NN, cfg, bp, h2)

    # (2) two prefills of the same tokens: the same bits (no float
    # atomics); the prefill's dropped assignments, layer by layer
    prefill = R.make_prefill_step(cfg, P + GEN)
    with _Routes(NN) as routes:
        l1, c1 = prefill(params, prompt)
    l2, c2 = prefill(params, prompt)
    same = torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(_leaves(c1), _leaves(c2)))
    drops = [int((~k).sum()) for _, k in routes.calls]
    log(f"[{tag}] two prefills of the same tokens: logits and caches "
        f"equal bit for bit: {same}; dropped assignments at capacity "
        f"{cfg.moe_capacity_factor} ({NN.moe_capacity(cfg.moe_spec(), B * P)}"
        f" slots an expert): {sum(drops)} of "
        f"{B * P * cfg.top_k * cfg.n_layers} over {cfg.n_layers} layers "
        f"(most in one layer {max(drops)})")
    check(same, f"[{tag}] two prefills of the same tokens differ")
    out.update(prefill_bits_equal=same, prefill_dropped=drops)
    del l1, l2, c1, c2

    # (3) bf16 against the same weights in float32: block by block on the
    # same inputs, then over the whole model
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    blk, flip = _blocks_bf16_vs_f32(tag, LM, NN, cfg, params, c32, p32,
                                    prompt)
    rels, agree, n_clear = _bf16_vs_f32(tag, R, cfg, params, c32, p32,
                                        prompt, res)
    log(f"[{tag}] bf16 vs float32, whole model, logits: prefill "
        f"{rels[0]:.3e}, decode max {max(rels[1:]):.3e} (tolerance "
        f"{LM_MOE_BF16_TOL}); argmax agrees on {agree:.4f} of the "
        f"{n_clear} rows whose margin clears twice the error")
    check(max(rels) <= LM_MOE_BF16_TOL,
          f"[{tag}] the bf16 model parts from its float32 self")
    out.update(block_bf16_vs_f32_rel=blk, block_route_flip_share=flip,
               bf16_vs_f32_rel=rels, bf16_vs_f32_argmax_agree=agree,
               clear_rows=n_clear)

    # (4) float32 at capacity factor 16 (the reference's own test
    # setting: nothing drops): a 64-token prefill, then decode steps,
    # against one forward over the same tokens, on the rows routed alike
    c16 = dataclasses.replace(c32, moe_capacity_factor=16.0)
    toks = serve.make_prompt(cfg, B, 64 + 16, seed=2, device=dev)
    with torch.no_grad(), _Routes(NN) as fwd_routes:
        full, _ = LM.forward(p32, c16, toks)
    with _Routes(NN) as inc_routes:
        lp, cache = LM.prefill(p32, c16, toks[:, :64], 64 + 16)
        steps = []
        for t in range(64, 64 + 16):
            ld, cache = LM.decode_step(p32, c16, cache, toks[:, t:t + 1], t)
            steps.append(ld)
    L = cfg.n_layers
    alike = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(L):
        inc = torch.cat([inc_routes.keys(i).reshape(B, 64, -1)]
                        + [inc_routes.keys(L * (1 + s) + i).reshape(B, 1, -1)
                           for s in range(16)], dim=1)
        alike &= (fwd_routes.keys(i).reshape(B, 80, -1) == inc).all(-1).all(-1)
    rows = alike.nonzero().flatten()
    f32 = [_rel_err(lp[rows], full[rows, 63])[1]] + [
        _rel_err(ld[rows], full[rows, 64 + s])[1]
        for s, ld in enumerate(steps)]
    log(f"[{tag}] float32 at capacity factor 16, 64-token prefill + 16 "
        f"decode steps vs one forward over the 80 tokens: {len(rows)} of "
        f"{B} rows routed alike at every position and layer; their logits' "
        f"max error relative to scale {max(f32):.3e} (tolerance "
        f"{LM_FAMILY_F32_TOL})")
    check(len(rows) >= B // 2, f"[{tag}] float32 routes part on most rows")
    check(max(f32) <= LM_FAMILY_F32_TOL,
          f"[{tag}] prefill + decode parts from the full forward")
    out.update(f32_rows_alike=len(rows), f32_prefill_decode_vs_forward_rel=f32)
    del full, cache, p32, lp, steps
    torch.cuda.empty_cache()

    # where the time goes
    _trace(tag, _lm_runs(R, cfg, params, prompt, res.tokens), out,
           MOE_DISPATCH_WORDS)
    del params, res
    torch.cuda.empty_cache()

    # kimi-k2 at its published widths, depth cut to 2 layers: the dense
    # layer 0, then one MoE layer of 384 experts and the shared expert
    t0 = time.perf_counter()
    kcfg = R.get_config("kimi-k2-1t-a32b", smoke=smoke)
    kcfg = dataclasses.replace(kcfg, n_layers=2)
    kparams = LM.init_params(kcfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    torch.cuda.synchronize()
    check(smoke or (kcfg.d_model, kcfg.n_heads, kcfg.n_kv_heads,
                    kcfg.head_dim, kcfg.n_experts, kcfg.top_k, kcfg.moe_d_ff,
                    kcfg.d_ff, kcfg.vocab, kcfg.shared_expert)
          == (7168, 64, 8, 112, 384, 8, 2048, 18432, 163840, True),
          f"[{tag}] not kimi-k2's published widths: {kcfg}")
    check(kcfg.kinds == [("attn", "dense"), ("attn", "moe")],
          f"[{tag}] kimi-k2 cut: {kcfg.kinds}")
    kn = _log_config(tag, kcfg, kparams, time.perf_counter() - t0)
    kprompt = serve.make_prompt(kcfg, KB, KP, seed=3, device=dev)
    kres = _serve_and_check(tag, serve, kparams, kcfg, kprompt, KGEN)
    kb = kparams["blocks"][1]
    h2 = LM._norm_apply(kcfg, kb["norm2"], LM._embed(kcfg, kparams, kprompt))
    krel, kdrop = _moe_block_check(tag, NN, kcfg, kb, h2)
    out["kimi"] = dict(params=kn, layers=2, batch=KB, prompt_len=KP,
                       gen=KGEN, prefill_ms=kres.prefill_s * 1e3,
                       decode_ms_per_step=kres.decode_s / KGEN * 1e3,
                       moe_block_rel=krel, dropped=kdrop)
    del kparams, kres, h2
    _phase_end(tag, out, results, t_phase)


def phase_lm_rglru(dev, results, smoke=False, B=4, P=512, GEN=32,
                   LONG=2304):
    """recurrentgemma-9b at full width (``smoke`` rehearses it)."""
    import dataclasses

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import layers as NN
    from repro_torch.models import lm as LM
    from repro_torch.models import recurrent as RC
    from repro_torch.models import registry as R

    tag = "lm_rglru"
    t_phase = t0 = _phase_start(tag)
    cfg, params = serve.init_lm("recurrentgemma-9b", smoke=smoke,
                                device=dev, seed=0)
    torch.cuda.synchronize()
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, cfg.d_ff, cfg.d_rnn, cfg.window, cfg.vocab,
                    cfg.dtype)
          == (38, 4096, 16, 1, 256, 12288, 4096, 2048, 256000,
              torch.bfloat16), f"[{tag}] not the full-width config: {cfg}")
    kinds = [m for m, _ in cfg.kinds]
    n_params = _log_config(tag, cfg, params, time.perf_counter() - t0)
    log(f"[{tag}] {kinds.count('rglru')} RG-LRU and {kinds.count('local')} "
        f"local-attention layers")
    prompt = serve.make_prompt(cfg, B, P, seed=0, device=dev)
    serve.serve_lm(params, cfg, prompt[:, :64], gen=2)      # warm-up

    # ---- the main path: B x P, GEN steps; then one long prompt whose
    # local layers' ring of ``window`` slots wraps
    res = _serve_and_check(tag, serve, params, cfg, prompt, GEN)
    long_len = LONG if not smoke else 2 * cfg.window + 3
    check(long_len > cfg.window, f"[{tag}] the long prompt does not wrap")
    lres = _serve_and_check(tag, serve, params, cfg,
                            serve.make_prompt(cfg, 1, long_len, seed=1,
                                              device=dev), GEN)
    # ----
    out = dict(params=n_params, batch=B, prompt_len=P, gen=GEN,
               prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_step=res.decode_s / GEN * 1e3,
               tokens_per_s=res.tokens_per_s,
               long=dict(prompt_len=long_len,
                         prefill_ms=lres.prefill_s * 1e3,
                         decode_ms_per_step=lres.decode_s / GEN * 1e3))
    del lres

    # (1) every decay at its floor: Lambda = 6 and r = 1 (positive inputs
    # through positive weights, a large positive r-gate) at full width
    rp = dict(params["blocks"][0]["rglru"])
    rp.update(w_x=rp["w_x"].abs(), conv_w=rp["conv_w"].abs(),
              w_rgate=torch.full_like(rp["w_rgate"], 100.0),
              lam=torch.full_like(rp["lam"], 6.0))
    xf = torch.randn((1, P, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(4)
                     ).abs().to(cfg.dtype)
    y, st = RC.rglru_apply(rp, xf)
    u, _ = RC._causal_conv(xf @ rp["w_x"], rp["conv_w"], None)
    r = torch.sigmoid(u.float() @ rp["w_rgate"].float())
    a_floor = float(torch.exp(-8.0 * torch.nn.functional.softplus(
        torch.tensor(6.0))))
    finite = bool(torch.isfinite(y).all()) and bool(
        torch.isfinite(st["h"]).all())
    log(f"[{tag}] every decay at its floor (Lambda 6, r == 1 on "
        f"{float((r == 1).float().mean()):.4f} of the gates, a = "
        f"{a_floor:.3e} a token) over {P} tokens at width "
        f"{rp['lam'].numel()}: output and state finite: {finite}")
    check(finite and bool((r == 1).all()),
          f"[{tag}] the floor decays are not finite")
    del rp, xf, y, st, u, r

    # (2) bf16 against float32, block by block and over the whole model
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    blk, _ = _blocks_bf16_vs_f32(tag, LM, NN, cfg, params, c32, p32, prompt)
    rels, agree, n_clear = _bf16_vs_f32(tag, R, cfg, params, c32, p32,
                                        prompt, res)
    log(f"[{tag}] bf16 vs float32, whole model, logits: prefill "
        f"{rels[0]:.3e}, decode max {max(rels[1:]):.3e} (tolerance "
        f"{LM_RGLRU_BF16_TOL}); argmax agrees on {agree:.4f} of the "
        f"{n_clear} rows whose margin clears twice the error")
    check(max(rels) <= LM_RGLRU_BF16_TOL,
          f"[{tag}] the bf16 model parts from its float32 self")
    out.update(block_bf16_vs_f32_rel=blk, bf16_vs_f32_rel=rels,
               bf16_vs_f32_argmax_agree=agree, clear_rows=n_clear)

    # (3) float32: a 64-token prefill, then decode steps, against one
    # forward; and the state 64 decode steps leave against the 64-token
    # prefill's (h, conv and the ring)
    toks = serve.make_prompt(cfg, B, 64 + 16, seed=2, device=dev)
    with torch.no_grad():
        full, _ = LM.forward(p32, c32, toks)
    lp, cache = LM.prefill(p32, c32, toks[:, :64], 64 + 16)
    f32 = [_rel_err(lp, full[:, 63])[1]]
    for t in range(64, 64 + 16):
        ld, cache = LM.decode_step(p32, c32, cache, toks[:, t:t + 1], t)
        f32.append(_rel_err(ld, full[:, t])[1])
    del full, cache
    _, pre = LM.prefill(p32, c32, toks[:, :64], 64)
    dec = LM.init_cache(c32, B, 64, dev)
    for t in range(64):
        _, dec = LM.decode_step(p32, c32, dec, toks[:, t:t + 1], t)
    state = max(_rel_err(b[k], a[k])[1] for a, b in
                zip(pre["blocks"], dec["blocks"]) for k in a)
    log(f"[{tag}] float32, 64-token prefill + 16 decode steps vs one "
        f"forward over the 80 tokens: logits max error relative to scale "
        f"{max(f32):.3e}; 64 decode steps' state (h, conv, ring K/V) vs the "
        f"64-token prefill's {state:.3e} (tolerance {LM_FAMILY_F32_TOL})")
    check(max(f32) <= LM_FAMILY_F32_TOL,
          f"[{tag}] prefill + decode parts from the full forward")
    check(state <= LM_FAMILY_F32_TOL,
          f"[{tag}] decode steps leave another state than the prefill")
    out.update(f32_prefill_decode_vs_forward_rel=f32,
               f32_decode_state_vs_prefill_rel=state)
    del p32, pre, dec
    torch.cuda.empty_cache()

    # where the time goes; the float32 gate products alone (two (B P, R)
    # x (R, R) float32 GEMMs a layer, CUDA events) beside the prefill
    _trace(tag, _lm_runs(R, cfg, params, prompt, res.tokens), out)
    R_ = cfg.d_rnn or cfg.d_model
    g = torch.Generator(device=dev).manual_seed(5)
    uf = torch.randn((B * P, R_), device=dev, generator=g)
    wg = [torch.randn((R_, R_), device=dev, generator=g) for _ in range(2)]
    n_rg = kinds.count("rglru")
    gate_ms = time_ms(lambda w: uf @ w, wg, iters=20) * 2 * n_rg
    busy = out["trace_prefill"]["device_busy_ms"]
    log(f"[{tag}] the float32 gate products of one prefill ({n_rg} layers x "
        f"2 of ({B * P}, {R_}) x ({R_}, {R_})): {gate_ms:.2f} ms by CUDA "
        f"events, {gate_ms / busy:.3f} of the prefill's device busy time")
    out["f32_gate_products_ms"] = gate_ms
    del params, res, uf, wg
    _phase_end(tag, out, results, t_phase)


ENCDEC_MESSAGE = "use the encdec example for whisper serving"


def phase_encdec(dev, results, smoke=False, B=4, GEN=32, train_steps=20):
    """whisper-tiny at full width (``smoke`` rehearses it), then
    ``launch.train`` for the three new families at the reference's smoke
    configs on the card."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.launch import serve, train
    from repro_torch.models import encdec as ED
    from repro_torch.models import registry as R

    tag = "encdec"
    t_phase = t0 = _phase_start(tag)
    cfg = R.get_config("whisper-tiny", smoke=smoke)
    params = ED.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    check(smoke or (cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model,
                    cfg.n_heads, cfg.d_ff, cfg.vocab, cfg.max_source,
                    cfg.max_target) == (4, 4, 384, 6, 1536, 51865, 1500, 448),
          f"[{tag}] not the full-width config: {cfg}")
    n_params = _log_config(tag, cfg, params, time.perf_counter() - t0)
    S = cfg.max_source
    frames = torch.randn((B, S, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1)
                         ).to(cfg.dtype)

    def serve_whisper(p, c, fr, feed=None):
        """Encoder + cache, then GEN greedy decode steps from token 0 (or
        fed ``feed``) through the registry's steps for config ``c`` ->
        (logits of each step, tokens fed, prefill ms, decode ms)."""
        prefill, step = R.make_prefill_step(c, 0), R.make_serve_step(c)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache = prefill(p, fr)
        torch.cuda.synchronize()
        pre = (time.perf_counter() - t) * 1e3
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        seq, fed = [], []
        t = time.perf_counter()
        for i in range(GEN):
            if feed is not None:
                tok = feed[:, i:i + 1]
            fed.append(tok)
            logits, cache = step(p, cache, tok, i)
            seq.append(logits)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        torch.cuda.synchronize()
        return seq, torch.cat(fed, 1), pre, (time.perf_counter() - t) * 1e3

    serve_whisper(params, cfg, frames[:, :64])               # warm-up
    # ---- the main path: the registry's prefill and serve steps
    seq, fed, pre_ms, dec_ms = serve_whisper(params, cfg, frames)
    # ----
    check(all(bool(torch.isfinite(lg).all()) for lg in seq),
          f"[{tag}] non-finite logits")
    log(f"[{tag}] served B={B} x {S} frames (encoder + cross K/V) + {GEN} "
        f"greedy decode steps: prefill {pre_ms:.2f} ms, decode "
        f"{dec_ms / GEN:.3f} ms/token step; first tokens "
        f"{fed[0, :8].tolist()}")
    out = dict(params=n_params, batch=B, frames=S, gen=GEN,
               prefill_ms=pre_ms, decode_ms_per_step=dec_ms / GEN)
    prefill, step = R.make_prefill_step(cfg, 0), R.make_serve_step(cfg)
    cache = prefill(params, frames)
    _trace(tag, (("prefill", lambda: prefill(params, frames)),
                 ("2 decode steps", lambda: [step(params, cache, fed[
                     :, i:i + 1], i) for i in range(2)])), out)
    del cache

    # float32: decode steps against the teacher-forced decoder over the
    # same tokens; and bf16 against float32
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    seq32, _, _, _ = serve_whisper(p32, c32, frames.float(), feed=fed)
    with torch.no_grad():
        full = ED.decode_train(p32, c32, ED.encode(p32, c32, frames.float()),
                               fed)
    f32 = max(_rel_err(lg, full[:, i])[1] for i, lg in enumerate(seq32))
    rels = [_rel_err(a, b)[1] for a, b in zip(seq, seq32)]
    agree, n_clear = _argmax_agree(
        torch.stack(seq), torch.stack(seq32),
        max(rels) * max(float(s.abs().max()) for s in seq32))
    log(f"[{tag}] float32 decode steps vs decode_train over the same "
        f"{GEN} tokens: max error relative to scale {f32:.3e} (tolerance "
        f"{LM_FAMILY_F32_TOL}); bf16 vs float32 decode logits max "
        f"{max(rels):.3e} (tolerance {ENCDEC_BF16_TOL}); argmax agrees on "
        f"{agree:.4f} of the {n_clear} clear rows")
    check(f32 <= LM_FAMILY_F32_TOL, f"[{tag}] decode parts from decode_train")
    check(max(rels) <= ENCDEC_BF16_TOL,
          f"[{tag}] the bf16 model parts from its float32 self")
    check(agree == 1.0, f"[{tag}] bf16 argmax differs on a clear row")
    out.update(f32_decode_vs_decode_train_rel=f32, bf16_vs_f32_rel=rels,
               bf16_vs_f32_argmax_agree=agree, clear_rows=n_clear)
    del p32, seq32, full

    # serve --arch whisper-tiny exits with the reference's message
    argv = ["--arch", "whisper-tiny"] + (["--full"] if not smoke else
                                         ["--device", str(dev)])
    try:
        serve.main(argv)
        msg = None
    except SystemExit as e:
        msg = str(e.code)
    log(f"[{tag}] serve {' '.join(argv)}: exits with {msg!r}")
    check(msg == ENCDEC_MESSAGE, f"[{tag}] serve --arch whisper-tiny served")
    del params, frames, seq
    torch.cuda.empty_cache()

    # launch.train on the card at the reference's smoke configs
    out["train"] = {}
    for arch, extra in (("granite-moe-1b-a400m", []),
                        ("recurrentgemma-9b", []),
                        ("whisper-tiny", ["--seq", "32"])):
        with tempfile.TemporaryDirectory() as d:
            buf = io.StringIO()
            argv = ["--arch", arch, "--steps", str(train_steps),
                    "--ckpt-dir", d, "--ckpt-every", "10",
                    "--log-every", "10"] + extra
            if smoke:
                argv += ["--device", str(dev)]
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                tr = train.main(argv)
            secs = time.perf_counter() - t
            line = buf.getvalue().strip().splitlines()[-1]
            log(f"[{tag}] train {' '.join(argv[:4])} {' '.join(extra)}: "
                f"{line} ({secs:.1f} s; checkpoints at {tr.manager.steps()})")
            last = tr.history[-1]
            ok = (tr.step == train_steps and np.isfinite(last["loss"])
                  and tr.manager.steps()[-1] == train_steps
                  and (" aux=" in line) == arch.startswith("granite"))
            check(ok, f"[{tag}] launch.train --arch {arch} did not train")
            out["train"][arch] = dict(loss=last["loss"], aux=last.get("aux"),
                                      seconds=secs)
    _phase_end(tag, out, results, t_phase)


# [mesh_lm] tolerances, each relative to the largest magnitude of what it
# is held to (``_rel_err``):
# - float32, the expert-parallel dispatch against ``moe_apply`` on the
#   same weights (no drops on either side): the same products, each
#   token's expert outputs summed by column partials rather than in one
#   run, so the sums differ in order only (as LM_FAMILY_F32_TOL), block
#   by block and over the whole model on the rows routed alike;
MESH_LM_F32_TOL = 1e-4
# - bf16 at the prefill's capacity factor, each block's EP channel
#   against ``moe_loop_f32`` on each data slice's tokens with the same
#   routes and that slice's capacity: the bf16 roundings of one MoE
#   channel, as LM_MOE_EXPERT_TOL (the drops must agree exactly);
MESH_LM_EP_BF16_TOL = LM_MOE_EXPERT_TOL
# - float32 train losses, 5 steps of the EP model against the plain one
#   from one start and batches (no drops): AdamW's first steps move an
#   element whose gradient is float noise by a noise-set share of lr, so
#   the losses part by more than one step's rounding.
MESH_LM_TRAIN_TOL = 1e-4


class _RouteSets:
    """Records each ``moe_route`` call's top-k expert sets while entered
    (sorted ids, (T, k)): the dispatch-independent route of a token."""

    def __init__(self, NN):
        self.NN, self.calls = NN, []

    def __enter__(self):
        import torch
        self._route = self.NN.moe_route

        def route(p, s, xt):
            out = self._route(p, s, xt)
            self.calls.append(torch.sort(out[1], dim=-1).values)
            return out

        self.NN.moe_route = route
        return self

    def __exit__(self, *exc):
        self.NN.moe_route = self._route


class _EPCalls:
    """Records each ``moe_apply_ep`` call while entered: its weights,
    spec, input, output, route (``moe_route``'s gates and eids on the
    whole batch) and, for each (data slice, column) entry in order, the
    kept flags (``keep & mine``, (T_loc, k) in top-k order) it hands
    the combine."""

    def __init__(self, NN):
        self.NN, self.calls = NN, []

    def __enter__(self):
        NN = self.NN
        self._ep, self._route, self._experts = (NN.moe_apply_ep,
                                                NN.moe_route, NN._experts)

        def ep(p, s, x, mesh, **kw):
            call = dict(p=p, s=s, x=x, keeps=[], mesh=mesh)
            self.calls.append(call)
            call["y"], aux = self._ep(p, s, x, mesh, **kw)
            return call["y"], aux

        def route(p, s, xt):
            out = self._route(p, s, xt)
            if self.calls and "route" not in self.calls[-1]:
                self.calls[-1]["route"] = out[:2]
            return out

        def experts(*args):
            if self.calls:
                self.calls[-1]["keeps"].append(args[-1])
            return self._experts(*args)

        NN.moe_apply_ep, NN.moe_route, NN._experts = ep, route, experts
        return self

    def __exit__(self, *exc):
        NN = self.NN
        NN.moe_apply_ep, NN.moe_route, NN._experts = (self._ep, self._route,
                                                      self._experts)


def _ep_vs_slice_loops(call):
    """One recorded ``moe_apply_ep`` call against ``moe_loop_f32`` run on
    each data slice's tokens separately, with the call's route: ->
    (relative error, kept flags equal, dropped, assignments)."""
    import torch
    mesh, x, s = call["mesh"], call["x"], call["s"]
    n_dp, ep = mesh.shape["data"], mesh.shape["model"]
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    T_loc = T // n_dp
    gates, eids = call["route"]
    ys, kept_ref, kept_ep = [], [], []
    for i in range(n_dp):
        rows = slice(i * T_loc, (i + 1) * T_loc)
        y32, kept, _ = moe_loop_f32(call["p"], s,
                                    x.reshape(T, D)[rows][None],
                                    route=(gates[rows], eids[rows]))
        ys.append(y32.reshape(T_loc, D))
        kept_ref.append(kept)
        keep = call["keeps"][i * ep]
        for c in range(1, ep):
            keep = keep | call["keeps"][i * ep + c]
        kept_ep.append(keep)
    kept_ref, kept_ep = torch.cat(kept_ref), torch.cat(kept_ep)
    rel = _rel_err(call["y"].reshape(T, D), torch.cat(ys))[1]
    return (rel, torch.equal(kept_ep, kept_ref), int((~kept_ref).sum()),
            kept_ref.numel())


def _mesh_of(devices, shape):
    from repro_torch.parallel.sharding import Mesh
    return Mesh(np.array(devices, dtype=object).reshape(shape),
                ("data", "model"))


def _paired(a, b):
    """(leaf of a, leaf of b) over a tree of dicts, lists and named
    tuples, ``b`` shaped as ``a`` (its leaves may be ``ShardedTensor``s,
    which are dataclasses)."""
    if isinstance(a, dict):
        for k in a:
            yield from _paired(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            yield from _paired(x, y)
    else:
        yield a, b


def _kernel_counts():
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.wkv6 import wkv6 as W
    return {**K.launch_counts(), **MM.launch_counts(), **W.launch_counts()}


def _reset_kernel_counts():
    from repro_torch.kernels.lut_gather import lut_gather as K
    from repro_torch.kernels.masked_matmul import masked_matmul as MM
    from repro_torch.kernels.wkv6 import wkv6 as W
    for lib in (K, MM, W):
        lib.reset_launch_counts()


def phase_mesh_lm(dev, results, smoke=False, B=4, P=512, GEN=32, FP=64,
                  FGEN=16, train_B=4, train_S=128, steps=5):
    """granite-moe-1b-a400m at full width with the expert-parallel
    dispatch (``moe_ep``) on a 2x2 mesh of four entries of the card
    (``smoke`` rehearses it at the smoke config).  Serving runs in
    bf16; the comparisons with ``moe_apply`` over the whole model and
    the training run in float32 with nothing dropped, so that the EP
    dispatch, which only reorders sums, can be held to float32's
    rounding (MESH_LM_F32_TOL, MESH_LM_TRAIN_TOL): all 24 layers, whose
    float32 state (parameters and two AdamW moments, 16 GB) fits the
    card twice over beside a resumed copy."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import layers as NN
    from repro_torch.models import lm as LM
    from repro_torch.models import registry as R
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tag = "mesh_lm"
    t_phase = t0 = _phase_start(tag)
    cfg, params = serve.init_lm("granite-moe-1b-a400m", smoke=smoke,
                                device=dev, seed=0)
    torch.cuda.synchronize()
    check(smoke or (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k,
                    cfg.dtype) == (24, 1024, 32, 8, torch.bfloat16),
          f"[{tag}] not the full-width config: {cfg}")
    n_params = _log_config(tag, cfg, params, time.perf_counter() - t0)
    mesh = _mesh_of([dev] * 4, (2, 2))
    ep = dataclasses.replace(cfg, moe_ep=True)
    log(f"[{tag}] mesh {mesh}: tokens split over data (2), experts over "
        f"model (2): {cfg.n_experts // 2} an entry")
    prompt = serve.make_prompt(cfg, B, P, seed=0, device=dev)
    serve.serve_lm(params, cfg, prompt[:, :64], gen=2)      # warm-up
    with mesh:
        serve.serve_lm(params, ep, prompt[:, :64], gen=2)
    out = dict(params=n_params, batch=B, prompt_len=P, gen=GEN)

    # ---- the main path: the serve loop with moe_ep on the mesh, beside
    # the unsharded run; counts zeroed just before, read just after
    runs = {}
    _reset_kernel_counts()
    for name, c, ctx in (("unsharded", cfg, contextlib.nullcontext()),
                         ("EP on the 2x2 mesh", ep, mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            res = _serve_and_check(tag, serve, params, c, prompt, GEN)
        torch.cuda.synchronize()
        runs[name] = dict(prefill_ms=res.prefill_s * 1e3,
                          decode_ms_per_step=res.decode_s / GEN * 1e3,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    counts = _kernel_counts()
    # ----
    log(f"[{tag}] " + "; ".join(
        f"{k}: prefill {v['prefill_ms']:.2f} ms, decode "
        f"{v['decode_ms_per_step']:.3f} ms a step, peak memory "
        f"{v['peak_gb']:.2f} GB" for k, v in runs.items())
        + f"; kernel launches over both runs {counts} (this path runs "
        f"none of the five)")
    out.update(runs=runs, kernel_launches=counts)

    # (1) the same bits: two EP prefills, EP with its weights gathered
    # over data (moe_ep_fsdp), and seq_parallel against the plain model
    def prefill(c, ctx):
        with ctx:
            return R.make_prefill_step(c, P + GEN)(params, prompt)
    l1, c1 = prefill(ep, mesh)
    l2, c2 = prefill(ep, mesh)
    same = torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(_leaves(c1), _leaves(c2)))
    lf, _ = prefill(dataclasses.replace(ep, moe_ep_fsdp=True), mesh)
    lsp, _ = prefill(dataclasses.replace(cfg, seq_parallel=True), mesh)
    lplain, _ = prefill(cfg, contextlib.nullcontext())
    log(f"[{tag}] bit for bit: two EP prefills (logits and caches) "
        f"{same}; moe_ep_fsdp == moe_ep {torch.equal(lf, l1)}; "
        f"seq_parallel == plain {torch.equal(lsp, lplain)}; EP vs "
        f"moe_apply at capacity {cfg.moe_capacity_factor} (each data "
        f"slice's capacity): {torch.equal(l1, lplain)}")
    check(same, f"[{tag}] two EP prefills differ")
    check(torch.equal(lf, l1), f"[{tag}] moe_ep_fsdp differs from moe_ep")
    check(torch.equal(lsp, lplain), f"[{tag}] seq_parallel changes values")
    del l1, l2, c1, c2, lf, lsp, lplain

    # (1b) the served setting itself, bf16 at capacity factor
    # cfg.moe_capacity_factor (each data slice its own capacity, so each
    # drops): every block's EP channel in the prefill against
    # moe_loop_f32 run on each data slice's tokens separately with the
    # same routes -- the same drops, and the outputs within the tolerance
    with _EPCalls(NN) as rec:
        prefill(ep, mesh)
    check(len(rec.calls) == cfg.n_layers and all(
        "route" in c and len(c["keeps"]) == mesh.size for c in rec.calls),
        f"[{tag}] the EP prefill did not run moe_apply_ep in every block")
    ep_rel, ep_same, ep_drop, ep_assign = 0.0, True, 0, 0
    for call in rec.calls:
        rel, same_keep, dropped, n_assign = _ep_vs_slice_loops(call)
        ep_rel, ep_same = max(ep_rel, rel), ep_same and same_keep
        ep_drop, ep_assign = ep_drop + dropped, ep_assign + n_assign
    del rec
    log(f"[{tag}] bf16 EP prefill at capacity factor "
        f"{cfg.moe_capacity_factor} (capacity "
        f"{NN.moe_capacity(cfg.moe_spec(), B * P // 2)} a slice of "
        f"{B * P // 2} tokens), {cfg.n_layers} blocks against a float32 "
        f"loop on each data slice with the same routes: {ep_drop} of "
        f"{ep_assign} assignments dropped, the same drops: {ep_same}; max "
        f"error relative to scale {ep_rel:.3e} (tolerance "
        f"{MESH_LM_EP_BF16_TOL})")
    check(ep_same, f"[{tag}] EP drops otherwise than each slice's loop")
    check(ep_drop > 0, f"[{tag}] the capacity check dropped nothing")
    check(ep_rel <= MESH_LM_EP_BF16_TOL,
          f"[{tag}] the bf16 EP channel parts from each slice's loop")
    out.update(ep_bf16_rel=ep_rel, ep_bf16_dropped=ep_drop,
               ep_bf16_assignments=ep_assign)

    # (2) float32, nothing dropped (capacity factor 16): decode through
    # moe_apply_ep against moe_apply, block by block on the same inputs,
    # then over the whole model (a prefill and decode steps)
    p32 = _cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32,
                              moe_capacity_factor=16.0)
    e32 = dataclasses.replace(c32, moe_ep=True)
    toks = serve.make_prompt(cfg, B, FP + FGEN, seed=2, device=dev)
    _, cache = LM.prefill(p32, c32, toks[:, :FP], FP + FGEN)
    x = LM._embed(c32, p32, toks[:, FP:FP + 1])
    pos = torch.full((1,), FP, dtype=torch.long, device=dev)
    worst = 0.0
    for kind, bp, bc in zip(c32.kinds, p32["blocks"], cache["blocks"]):
        y, _, _ = LM.block_apply(c32, kind, bp, x, pos,
                                 {k: v.clone() for k, v in bc.items()})
        with mesh:
            y_ep, _, _ = LM.block_apply(e32, kind, bp, x, pos,
                                        {k: v.clone() for k, v in bc.items()})
        worst = max(worst, _rel_err(y_ep, y)[1])
        x = y
    log(f"[{tag}] float32 decode step, EP vs moe_apply block by block on "
        f"the same inputs: max error relative to scale {worst:.3e} "
        f"(tolerance {MESH_LM_F32_TOL})")
    check(worst <= MESH_LM_F32_TOL, f"[{tag}] an EP block parts from "
          f"moe_apply in float32")
    with _RouteSets(NN) as r_plain:
        seq = _whole_model(R, c32, p32, toks[:, :FP], toks[:, FP:])
    with mesh, _RouteSets(NN) as r_ep:
        seq_ep = _whole_model(R, e32, p32, toks[:, :FP], toks[:, FP:])
    alike = torch.ones(B, dtype=torch.bool, device=dev)
    for a, b in zip(r_plain.calls, r_ep.calls):
        alike &= (a == b).all(-1).reshape(B, -1).all(-1)
    rows = alike.nonzero().flatten()
    whole = max(_rel_err(a[rows], b[rows])[1] for a, b in zip(seq_ep, seq))
    log(f"[{tag}] float32 {FP}-token prefill + {FGEN} decode steps, EP vs "
        f"moe_apply over the whole model: {len(rows)} of {B} rows routed "
        f"alike in every layer; their logits' max error relative to scale "
        f"{whole:.3e} (tolerance {MESH_LM_F32_TOL})")
    check(len(rows) >= B // 2, f"[{tag}] float32 routes part on most rows")
    check(whole <= MESH_LM_F32_TOL, f"[{tag}] the EP model parts from "
          f"moe_apply in float32")
    out.update(f32_block_rel=worst, f32_whole_rel=whole,
               f32_rows_alike=len(rows))
    del p32, cache, seq, seq_ep
    torch.cuda.empty_cache()

    # (3) training: granite at full width (every layer), float32,
    # nothing dropped; 5 steps of the EP model through the Trainer on
    # the mesh against 5 plain steps from the same start and batches;
    # the checkpoint, resumed with lm_rules (FSDP) shardings
    init_state, plain_step = LM.make_train_step(c32, R._optimizer(c32),
                                                remat=False)
    _, ep_step = LM.make_train_step(e32, R._optimizer(e32), remat=False)
    start = init_state(torch.Generator(device=dev).manual_seed(3), dev)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(steps):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (
            train_B, train_S + 1))).to(dev)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    s, plain = start, []
    t0 = time.perf_counter()
    for b in batches:
        s, m = plain_step(s, b)
        plain.append(float(m["loss"]))
    plain_s = time.perf_counter() - t0
    del s
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-lm-") as d:
        tr = Trainer(TrainerConfig(d, ckpt_every=steps, keep=1), ep_step,
                     start, layout=LM.checkpoint_layout(e32))
        t0 = time.perf_counter()
        with mesh:
            tr.run(iter(batches), steps, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        del start
        losses = [h["loss"] for h in tr.history]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        log(f"[{tag}] train, {cfg.n_layers} layers at full width, float32, "
            f"B={train_B} x {train_S}: {steps} EP steps through the Trainer "
            f"on the mesh ({train_s / steps * 1e3:.1f} ms a step, the "
            f"checkpoint included; plain {plain_s / steps * 1e3:.1f} ms) "
            f"losses {[f'{v:.6f}' for v in losses]} vs plain "
            f"{[f'{v:.6f}' for v in plain]}: max relative difference "
            f"{rel:.3e} (tolerance {MESH_LM_TRAIN_TOL})")
        check(len(losses) == steps and rel <= MESH_LM_TRAIN_TOL,
              f"[{tag}] EP training parts from plain training")
        shardings = SH.make_shardings(
            {"state": tr.state, "step": torch.zeros(())}, mesh,
            SH.lm_rules(fsdp=True, tied_embed=c32.tie_embeddings))
        tr2 = Trainer(TrainerConfig(d), ep_step, tr.state,
                      layout=LM.checkpoint_layout(e32))
        t0 = time.perf_counter()
        ok = tr2.try_resume(shardings=shardings) and tr2.step == steps
        resume_s = time.perf_counter() - t0
        ok &= all(torch.equal(a, b) for a, b in _paired(tr.state, tr2.state))
        n_leaves = n_shards = n_split = 0
        for want, got in _paired(tr.state, tr2.sharded_state):
            n_leaves += 1
            n_split += any(e is not None for e in got.sharding.spec)
            for shard in got.addressable_shards:
                n_shards += 1
                ok &= (shard.data.device == dev
                       and torch.equal(shard.data, want[shard.index]))
        log(f"[{tag}] checkpoint at step {steps}, try_resume(shardings=) "
            f"with lm_rules(fsdp=True) on the mesh ({resume_s:.1f} s): the "
            f"whole state and {n_leaves} laid-out leaves ({n_split} "
            f"split), {n_shards} shards, each equal to its slice of the "
            f"saved leaf: {ok}")
        check(ok, f"[{tag}] a resumed shard differs from the saved leaf")
    out.update(train_layers=cfg.n_layers, train_losses=losses,
               plain_losses=plain, train_rel=rel,
               train_ms_per_step=train_s / steps * 1e3,
               plain_ms_per_step=plain_s / steps * 1e3, resume_s=resume_s,
               resumed_leaves=n_leaves, resumed_shards=n_shards)
    del tr, tr2
    torch.cuda.empty_cache()

    # (4) every card, when there are two or more
    n = torch.cuda.device_count()
    if n >= 2 and cfg.n_experts % n == 0:
        cards = _mesh_of([torch.device("cuda", i) for i in range(n)],
                         (1, n))
        with cards:
            res = _serve_and_check(tag, serve, params, ep, prompt, GEN)
        out["cards"] = dict(prefill_ms=res.prefill_s * 1e3,
                            decode_ms_per_step=res.decode_s / GEN * 1e3)
    else:
        log(f"[{tag}] {n} card: no mesh over several cards")
    del params
    _phase_end(tag, out, results, t_phase)


# [dryrun]: the most a chip's share of a cell's counted work on the
# 512-chip mesh may be of its share on 256 chips, where the batch splits
# over the data axes (which then double):
# - FLOPs: every matrix product has an operand split with the batch, so
#   they halve (0.5000 in every full-size cell counted on a CPU);
DRYRUN_FLOPS_SPLIT_MAX = 0.505
# - a train step's bytes: its activations and their gradients halve, the
#   weights' own work (replicated over the data axes) does not and is a
#   few percent (0.5003-0.5161 counted on a CPU).  Prefill and decode
#   bytes are printed, not bounded: their work without a batch dim
#   (attention masks, recurrentgemma's weight upcasts each step) is
#   replicated over the data axes and weighs up to a third of a step.
DRYRUN_TRAIN_BYTES_SPLIT_MAX = 0.55


def phase_dryrun(dev, results, smoke=False, jobs=None):
    """The dry-run cost pass over every (arch x shape) cell on the
    256-chip and 512-chip placeholder meshes, through ``dryrun.driver``
    (a process a cell, ``jobs`` at a time) into a temporary directory."""
    import contextlib
    import io
    import math

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.models import registry as R

    tag = "dryrun"
    t_phase = time.perf_counter()
    jobs = jobs or os.cpu_count() or 1
    meshes = {"single": 256, "multi": 512}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fails = D.driver(tmp, list(meshes), smoke, force=True,
                             timeout_s=900, jobs=jobs)
        recs = []
        for f in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, f)) as fh:
                recs.append(json.load(fh))
    wall = time.perf_counter() - t_phase
    n_cells = len(R.ARCHS) * len(R.SHAPES) * len(meshes)
    check(fails == 0 and len(recs) == n_cells,
          f"[{tag}] {fails} cells failed, {len(recs)} of {n_cells} "
          f"records:\n{buf.getvalue()[-3000:]}")
    out, dominant = {}, {}
    for rec in recs:
        name = f"{rec['arch']} x {rec['shape']} [{rec['mesh']}]"
        reason = R.cell_is_skipped(rec["arch"], rec["shape"])
        if rec["status"] == "skipped":
            check(rec["reason"] == reason, f"[{tag}] {name}: skip reason "
                  f"{rec['reason']!r}, the registry's {reason!r}")
            continue
        rf, mem = rec["roofline"], rec["memory"]
        ok = (rec["status"] == "ok" and reason is None
              and rec["chips"] == meshes[rec["mesh"]]
              and min(rf["compute_s"], rf["memory_s"],
                      rf["collective_s"]) >= 0
              and rf["dominant"] in ("compute", "memory", "collective")
              and mem["peak_bytes_per_device"] > 0
              and 0 < rf["useful_ratio"] and math.isfinite(
                  rf["useful_ratio"]))
        log(f"[{tag}] {RL.summarize_cell(rec)} peak "
            f"{mem['peak_bytes_per_device'] / 1e9:.2f} GB "
            f"({rec['timing']['total_s']:.1f} s)")
        check(ok, f"[{tag}] {name}: record out of contract")
        dominant[rf["dominant"]] = dominant.get(rf["dominant"], 0) + 1
        out[name] = dict(dominant=rf["dominant"], compute_s=rf["compute_s"],
                         memory_s=rf["memory_s"],
                         collective_s=rf["collective_s"],
                         useful_ratio=rf["useful_ratio"],
                         peak_gb=mem["peak_bytes_per_device"] / 1e9,
                         fits_hbm_80g=mem["fits_hbm_80g"],
                         seconds=rec["timing"]["total_s"])
    # 512 chips split the data axes twice as wide as 256 ("pod" x
    # "data"): where the batch splits over them, each chip's share of
    # the batch's work halves
    by_cell = {}
    for rec in recs:
        if rec["status"] == "ok":
            by_cell.setdefault((rec["arch"], rec["shape"]), {})[
                rec["mesh"]] = rec["cost"]
    worst = {}
    n_split = 0
    for (arch, shape), cost in sorted(by_cell.items()):
        spec = R.SHAPES[shape]
        batch = min(spec.global_batch, 4) if smoke else spec.global_batch
        if batch % (2 * 16):                                # pod x data
            continue
        n_split += 1
        for key, kind, most in (
                ("flops_per_chip", None, DRYRUN_FLOPS_SPLIT_MAX),
                ("bytes_per_chip", "train", DRYRUN_TRAIN_BYTES_SPLIT_MAX),
                ("bytes_per_chip", "prefill", None),
                ("bytes_per_chip", "decode", None)):
            if kind not in (None, spec.kind):
                continue
            ratio = cost["multi"][key] / cost["single"][key]
            name = f"{key} ({kind or 'all'})"
            worst[name] = max(worst.get(name, 0.0), ratio)
            check(most is None or ratio <= most, f"[{tag}] {arch} x "
                  f"{shape}: {key} on 512 chips is {ratio:.4f} of 256's")
    log(f"[{tag}] each chip's share on 512 chips against 256, over the "
        f"{n_split} cells whose batch splits over pod x data, at most: "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (limits: FLOPs {DRYRUN_FLOPS_SPLIT_MAX}, train bytes "
        f"{DRYRUN_TRAIN_BYTES_SPLIT_MAX})")
    log(f"[{tag}] {len(out)} cells ok on {list(meshes)} meshes, "
        f"{n_cells - len(out)} skipped; dominant terms "
        f"{dominant}; {jobs} processes; phase {wall:.1f} s")
    results[f"_{tag}"] = dict(cells=out, split_worst=worst, phase_s=wall,
                              jobs=jobs,
                              device=RL.DEVICE)


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
    if sys.argv[1:2] == ["--phases"]:
        # a partial run (the named phases only) prints no result line
        log(f"[device] {phase_device()}")
        results = {}
        try:
            for name in sys.argv[2].split(","):
                globals()[f"phase_{name}"](dev, results)
        finally:
            # what the phases recorded, also where a check failed
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, "chip_smoke_partial.json"),
                      "w") as f:
                json.dump({"phases": sys.argv[2], "results": results}, f,
                          indent=1, default=str)
        log(f"chip_smoke: partial run, phases {sys.argv[2]}")
        return 0

    smi = phase_device()
    build = phase_build()
    phase_golden(dev)
    results = {}
    phase_width(dev, results)
    counts = dict(phase_serve(dev, results))
    for name, n in phase_fleet(dev, results).items():
        counts[name] += n
    for name, n in phase_shards(dev, results).items():
        counts[name] += n
    for name, n in phase_train(dev, results).items():
        counts[name] += n
    for name, n in phase_search(dev, results).items():
        counts[name] += n
    phase_wkv(dev, results)
    counts.update(phase_masked_mm(dev, results))
    counts.update(phase_lm(dev, results))
    phase_lm_attn(dev, results)
    phase_lm_train(dev, results)
    phase_lm_moe(dev, results)
    phase_lm_rglru(dev, results)
    phase_encdec(dev, results)
    for name, n in phase_examples(dev, results).items():
        counts[name] += n
    phase_mesh_lm(dev, results)
    phase_dryrun(dev, results)

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
