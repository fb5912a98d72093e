"""Batched serving launcher: LM prefill + decode loop, or LUT mode
(port of ``repro.launch.serve``).

LM mode: one prefill builds the decode cache (KV caches for attention,
the recurrent state for RWKV) for the whole batch, then ``serve_step``
decodes token by token, greedily or by sampling at ``--temperature``.
Every decoder-only architecture serves (``--arch``,
``models/registry.ARCHS``; ``qwen2.5-3b`` by default, as in the
reference): attention, MoE, RG-LRU and RWKV.  The encoder-decoder
(whisper) exits with the reference's message; its prefill and decode
are the registry's ``make_prefill_step`` and ``make_serve_step``.
``--kv-int8`` stores the attention caches as int8 codes with per-token
scales.  Weights are
drawn from a fixed seed (no published weights are in the repository);
inference does the same work whatever their values.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --full --batch 4 --prompt-len 512 --gen 32 --kv-int8  # on the card

``--lut`` serves a LUT-DNN instead: a tiny jsc model is trained and
synthesised to truth tables on the device (``build_lut_model``), or
cold-loaded from ``--artifact-dir`` when an artifact is there (no
training, no synthesis), and a Poisson request stream flows through
``launch.registry.ModelRegistry`` (its deadline-flush micro-batcher and
the fused LUT kernel).  ``--save-artifact`` writes the synthesised
network to ``--artifact-dir``; a later run with that directory
cold-loads it and serves identically bit for bit.  ``--swap-demo``
hot-swaps a second artifact version under load; ``--replicas N`` serves
through an N-replica ``LutFleet``; ``--fleet-swap-demo`` swaps across
the fleet in two phases; ``--slo-tiers`` serves a mixed interactive /
batch stream through the scoreboard scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --lut --device cpu \\
        --artifact-dir /tmp/lut-artifacts --save-artifact   # compile
    PYTHONPATH=src python -m repro_torch.launch.serve --lut --device cpu \\
        --artifact-dir /tmp/lut-artifacts                   # cold-load

Without ``--device`` both modes run on the CUDA card.  ``--shards N``
splits every LUT microbatch over a mesh of N devices
(``parallel.sharding.serving_mesh``: the first N cards, or with
``--device cpu`` the CPU as N entries, which
``device.ensure_host_devices(N)`` must allow first), tables replicated
on each, in every ``--lut`` mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm as LM
from repro_torch.models import registry as R


# ---------------------------------------------------------------------------
# LUT-mode serving assembly
# ---------------------------------------------------------------------------

def lut_dataset(seed: int = 0, name: str = "jsc", n_samples: int = 4000):
    """The deterministic dataset the LUT serving stack trains and
    evaluates on (numpy), separate from training so an artifact
    cold-load can still score accuracy without touching the trainer.
    The reference always serves jsc (4000 samples); a cold load here
    takes the dataset an artifact's provenance names (see
    ``load_or_build_lut_model``)."""
    from repro_torch.data.loader import train_test_split
    from repro_torch.data.synthetic import make_dataset

    return train_test_split(make_dataset(name, n_samples=n_samples,
                                         seed=seed))


def build_lut_model(train_steps: int = 150, fan_in: int = 3,
                    adder_width: int = 2, seed: int = 0,
                    device: DeviceLike = None):
    """Train + synthesise a tiny LUT-DNN on ``device`` (the CUDA card
    unless one is named).  Returns (spec, tables, data)."""
    from repro_torch.configs import paper_models as PM
    from repro_torch.core import lut_synth as LS
    from repro_torch.core import lutdnn as LD
    from repro_torch.data.loader import batch_iterator

    dev = resolve_device(device)
    data = lut_dataset(seed)
    spec = PM.tiny("jsc", degree=1, fan_in=fan_in, adder_width=adder_width)
    init_state, step = LD.make_train_step(spec, lr=5e-3)
    state = init_state(torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
    it = batch_iterator(data["train"], 256, seed=seed, device=dev)
    for _ in range(train_steps):
        state, _ = step(state, next(it))
    tables = LS.synthesise(state["model"], spec)
    return spec, tables, data


def artifact_dataset(art, seed: int = 0):
    """The dataset an artifact is scored on: the one its provenance
    names (``dataset``, ``n_samples``; jsc and 4000 samples when it
    names none, as the reference's artifacts are), split as
    ``lut_dataset`` splits it.  Its input width must be the network's."""
    from repro_torch.data.synthetic import dataset_dims

    prov = art.manifest.get("provenance") or {}
    name = prov.get("dataset", "jsc")
    n_samples = int(prov.get("n_samples", 4000))
    if dataset_dims(name)[0] != art.n_in:
        raise SystemExit(
            f"artifact {art.artifact_id[:12]} takes {art.n_in} inputs; its "
            f"dataset {name!r} has {dataset_dims(name)[0]} features")
    return lut_dataset(seed, name, n_samples)


def load_or_build_lut_model(train_steps: int = 150,
                            artifact_dir: Optional[str] = None,
                            save: bool = False, seed: int = 0,
                            device: DeviceLike = None):
    """The compile-once entry: cold-load the newest artifact under
    ``artifact_dir`` when one exists (no training), otherwise train +
    synthesise and optionally persist the result.  Returns
    (spec, source, data, origin) where ``source`` is an Artifact or a
    table list and ``origin`` is "artifact" | "trained" |
    "trained+saved".  The port saves no execution plan: the plan lies
    outside the hashed content and the port plans for itself."""
    from repro_torch.artifact import find_artifacts, load_artifact

    dev = resolve_device(device)
    if artifact_dir and find_artifacts(artifact_dir):
        t0 = time.monotonic()
        # int4 slabs stay two codes per byte all the way into the
        # kernel (in-kernel nibble unpack)
        art = load_artifact(artifact_dir, unpack_int4=False, device=dev)
        dt = time.monotonic() - t0
        spec = art.spec
        if spec is None:
            raise SystemExit(
                f"artifact {art.artifact_id[:12]} carries no ModelSpec — "
                f"re-save it with spec= to serve through this launcher")
        print(f"cold-loaded artifact {art.artifact_id[:12]} "
              f"({art.path}) in {dt * 1e3:.1f} ms — no retraining")
        return spec, art, artifact_dataset(art, seed), "artifact"

    spec, tables, data = build_lut_model(train_steps, seed=seed, device=dev)
    if save and artifact_dir:
        from repro_torch.artifact import save_artifact
        path = save_artifact(
            artifact_dir, tables, name=spec.name.replace(" ", ""),
            spec=spec, provenance={"train_steps": train_steps,
                                   "seed": seed, "dataset": "jsc"})
        print(f"saved artifact {path}")
        return spec, tables, data, "trained+saved"
    return spec, tables, data, "trained"


def request_codes(fq, data, n_requests: int, seed: int = 0):
    """(idx, codes): ``n_requests`` test rows drawn from a numpy seed
    and their input codes (int32 numpy) on ``fq``'s grid."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data["test"]["x"].shape[0], n_requests)
    x = torch.from_numpy(np.asarray(data["test"]["x"])[idx])
    return idx, fq.to_code(fq.clip(x)).numpy()


def run_lut_load(serve_fn, fq, data, n_requests: int, microbatch: int,
                 deadline_s: float, rate: float, seed: int = 0):
    """Drive a Poisson open-loop request stream through a deadline-flush
    batcher into ``serve_fn`` (codes tensor -> codes tensor, on
    ``serve_fn.device``).  Returns (handles, batcher, idx)."""
    from repro_torch.launch.batching import MicroBatcher, replay_open_loop

    idx, codes_all = request_codes(fq, data, n_requests, seed)
    dev = serve_fn.device

    def engine(batch_np):
        x = torch.from_numpy(np.ascontiguousarray(batch_np, np.int32))
        return serve_fn(x.to(dev)).cpu().numpy()

    with MicroBatcher(engine, microbatch, deadline_s,
                      n_features=codes_all.shape[1]) as mb:
        handles = replay_open_loop(mb, codes_all, rate, seed=seed)
    return handles, mb, idx


def lut_accuracy(handles, data, idx) -> float:
    """Classification accuracy of served results — one batched decode
    (stack every output row, dequantize, argmax).  Handles that failed
    or were shed are excluded; nan when nothing succeeded."""
    from repro_torch.core import lut_synth as LS

    ok = [(h, i) for h, i in zip(handles, np.asarray(idx))
          if h is not None and h.done and not h.failed]
    if not ok:
        return float("nan")
    out = torch.from_numpy(np.stack([h.result() for h, _ in ok]))
    pred = torch.argmax(LS.OUTPUT_QUANT.from_code(out), -1).numpy()
    y = np.asarray(data["test"]["y"])[[i for _, i in ok]]
    return float((pred == y).mean())


def report_lut_serving(header: str, handles, mb, acc: float,
                       span: float) -> None:
    """Shared latency/throughput/flush-telemetry report."""
    from repro_torch.launch.batching import latency_percentiles_ms

    p50, p95, p99 = latency_percentiles_ms(handles)
    fills = [f.fill for f in mb.flushes]
    print(header)
    print(f"  latency p50 {p50:.2f} ms / p95 {p95:.2f} ms / "
          f"p99 {p99:.2f} ms")
    print(f"  throughput {len(handles) / span:,.0f} req/s over "
          f"{len(mb.flushes)} flushes (mean fill {np.mean(fills):.1f}, "
          f"{sum(f.deadline_hit for f in mb.flushes)} "
          f"deadline-triggered, engine "
          f"{np.mean([f.kernel_s for f in mb.flushes]) * 1e3:.3f} ms a "
          f"flush), accuracy {acc:.4f}")


@dataclasses.dataclass
class LutServeResult:
    """What one LUT serving run did: where the model came from, how
    many requests were answered, failed or never completed, the served
    accuracy, latency percentiles (ms) and the batcher's flushes."""
    origin: str
    requests: int
    served: int
    failed: int
    dropped: int
    accuracy: float
    p50_ms: float
    p99_ms: float
    artifact_id: Optional[str]
    # each flush's engine wall time (buffer fill, copies, forward), ms
    flush_ms: List[float]

    @property
    def engine_ms(self) -> float:
        return float(np.mean(self.flush_ms))


def drive_lut_serving(source, spec, data, *, requests: int,
                      microbatch: int, deadline_ms: float, rate: float,
                      header: str, device: DeviceLike = None,
                      origin: str = "", mesh=None) -> LutServeResult:
    """Register ``source`` (an Artifact or a table list) in a
    ``ModelRegistry`` on ``device`` (which warms its engine), its
    microbatches split over ``mesh`` when one is given, run the
    open-loop load through it, print the shared report."""
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.registry import ModelRegistry

    fq = spec.layer_specs()[0].in_quant
    idx, codes = request_codes(fq, data, requests)
    with ModelRegistry(microbatch, deadline_ms / 1e3,
                       device=device, mesh=mesh) as reg:
        entry = reg.register("lut", source)
        print(f"  {entry.plan.describe()}")
        t0 = time.monotonic()
        handles = replay_open_loop(reg.client("lut"), codes, rate)
        span = time.monotonic() - t0
    acc = lut_accuracy(handles, data, idx)
    report_lut_serving(header, handles, entry.batcher, acc, span)
    failed = sum(1 for h in handles if h.done and h.failed)
    served = sum(1 for h in handles if h.done and not h.failed)
    p50, p99 = latency_percentiles_ms(handles, qs=(50, 99))
    return LutServeResult(
        origin=origin, requests=requests, served=served, failed=failed,
        dropped=requests - served - failed, accuracy=acc, p50_ms=p50,
        p99_ms=p99, artifact_id=entry.artifact_id,
        flush_ms=[f.kernel_s * 1e3 for f in entry.batcher.flushes])


def _save_versions(args, dev):
    """Train two seeds of the tiny jsc model and save both artifacts;
    returns (spec, data, paths)."""
    import tempfile

    from repro_torch.artifact import save_artifact

    art_dir = args.artifact_dir or tempfile.mkdtemp(prefix="lut-artifacts-")
    spec, tables_v1, data = build_lut_model(args.lut_train_steps, seed=0,
                                            device=dev)
    _, tables_v2, _ = build_lut_model(args.lut_train_steps, seed=1,
                                      device=dev)
    paths = [save_artifact(art_dir, t, name=f"tiny-jsc-v{i + 1}",
                           spec=spec, provenance={"seed": i})
             for i, t in enumerate((tables_v1, tables_v2))]
    print(f"compiled artifacts:\n  v1 {paths[0]}\n  v2 {paths[1]}")
    return spec, data, paths


def run_swap_demo(args, dev, mesh=None) -> None:
    """Compile two artifact versions, serve v1 through the multi-model
    registry under live Poisson load, hot-swap to v2 mid-stream; prints
    the dropped count, the swap blackout and the accuracy."""
    import threading

    from repro_torch.launch.batching import replay_open_loop
    from repro_torch.launch.registry import ModelRegistry

    spec, data, paths = _save_versions(args, dev)
    idx, codes = request_codes(spec.layer_specs()[0].in_quant, data,
                               args.requests)
    with ModelRegistry(args.microbatch, args.deadline_ms / 1e3,
                       device=dev, mesh=mesh) as reg:
        reg.register("tiny-jsc", paths[0])
        handles: list = []
        t0 = time.monotonic()
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(reg.client("tiny-jsc"), codes, args.rate)))
        feeder.start()
        # land the swap mid-stream: after ~40% of the offered window
        time.sleep(0.4 * args.requests / args.rate)
        rep = reg.swap("tiny-jsc", paths[1])
        feeder.join()
        span = time.monotonic() - t0

    failed = sum(1 for h in handles if h.failed)
    acc = lut_accuracy(handles, data, idx)
    print(f"hot-swap demo (shards={args.shards or 1}): "
          f"{len(handles)}/{args.requests} served, "
          f"{failed} failed, {args.requests - len(handles)} dropped")
    print(f"  swap v{rep.old_version}->v{rep.new_version}: warm "
          f"{rep.warm_s * 1e3:.1f} ms off-path, blackout "
          f"{rep.blackout_s * 1e6:.1f} us, drained "
          f"{rep.drained_requests} in-flight on old engine")
    print(f"  throughput {len(handles) / span:,.0f} req/s, "
          f"post-swap accuracy (mixed stream) {acc:.4f}")


def _fleet_artifact_path(args, spec, source, origin) -> str:
    """Fleet distribution ships bytes (copy + hash-verify at every
    replica), so the model must exist as an on-disk artifact; persist
    an in-memory synthesis result to a tempdir when needed."""
    import tempfile

    if hasattr(source, "path"):            # a loaded Artifact
        return source.path
    from repro_torch.artifact import save_artifact
    out = args.artifact_dir or tempfile.mkdtemp(prefix="lut-fleet-src-")
    path = save_artifact(out, source, name=spec.name.replace(" ", ""),
                         spec=spec, provenance={"origin": origin})
    print(f"persisted artifact for fleet distribution: {path}")
    return path


def run_fleet_serving(args, dev, mesh=None) -> None:
    """Serve the Poisson load through an N-replica fleet: the artifact
    distributed + hash-verified on every replica, requests routed
    least-outstanding, every response tagged with the serving artifact
    id."""
    from repro_torch.launch.batching import (latency_percentiles_ms,
                                             replay_open_loop)
    from repro_torch.launch.fleet import LutFleet

    spec, source, data, origin = load_or_build_lut_model(
        args.lut_train_steps, artifact_dir=args.artifact_dir,
        save=args.save_artifact, device=dev)
    path = _fleet_artifact_path(args, spec, source, origin)
    idx, codes = request_codes(spec.layer_specs()[0].in_quant, data,
                               args.requests)
    with LutFleet(args.replicas, args.microbatch, args.deadline_ms / 1e3,
                  device=dev, mesh=mesh) as fleet:
        dist = fleet.distribute_artifact(path, "m")
        print(f"distributed to {sorted(dist)}: "
              f"{ {k: d.admitted for k, d in dist.items()} }")
        t0 = time.monotonic()
        handles = replay_open_loop(fleet.client("m"), codes, args.rate)
        span = time.monotonic() - t0
        stats = fleet.stats()

    p50, p95, p99 = latency_percentiles_ms(handles)
    acc = lut_accuracy(handles, data, idx)
    print(f"lut-serve[fleet x{args.replicas}, {origin}] "
          f"shards={args.shards or 1} "
          f"microbatch={args.microbatch} deadline={args.deadline_ms}ms "
          f"rate={args.rate:,.0f}/s:")
    print(f"  latency p50 {p50:.2f} ms / p95 {p95:.2f} ms / "
          f"p99 {p99:.2f} ms")
    print(f"  throughput {len(handles) / span:,.0f} req/s, "
          f"accuracy {acc:.4f}, per-replica served "
          f"{ {k: v['served'] for k, v in stats.items()} }")


def run_fleet_swap_demo(args, dev, mesh=None) -> None:
    """Two artifact versions, an N-replica fleet under live Poisson
    load, and a two-phase coordinated swap mid-stream: prepare warms
    the new engine off-path on every replica, commit cuts them all
    over."""
    import threading

    from repro_torch.launch.batching import replay_open_loop
    from repro_torch.launch.fleet import LutFleet

    replicas = args.replicas or 2
    spec, data, paths = _save_versions(args, dev)
    idx, codes = request_codes(spec.layer_specs()[0].in_quant, data,
                               args.requests)
    with LutFleet(replicas, args.microbatch, args.deadline_ms / 1e3,
                  device=dev, mesh=mesh) as fleet:
        fleet.distribute_artifact(paths[0], "m")
        handles: list = []
        t0 = time.monotonic()
        feeder = threading.Thread(target=lambda: handles.extend(
            replay_open_loop(fleet.client("m"), codes, args.rate)))
        feeder.start()
        time.sleep(0.1 * args.requests / args.rate)
        prepared = fleet.prepare_swap("m", paths[1])
        rep = fleet.commit_swap(prepared)
        feeder.join()
        span = time.monotonic() - t0
        tags = fleet.admitted_tags("m")

    dropped = args.requests - sum(1 for h in handles if h.done)
    by_tag: dict = {}
    for h in handles:
        by_tag[h.version_tag[:12]] = by_tag.get(h.version_tag[:12], 0) + 1
    acc = lut_accuracy(handles, data, idx)
    print(f"fleet swap demo (x{replicas} replicas, "
          f"shards={args.shards or 1}): "
          f"{len(handles)}/{args.requests} served, {dropped} dropped")
    print(f"  prepare {rep.prepare_s * 1e3:.1f} ms off-path (all "
          f"replicas), commit window {rep.commit_window_s * 1e3:.2f} ms, "
          f"max blackout {rep.max_blackout_s * 1e6:.1f} us, "
          f"{rep.total_drained} drained on old engines")
    print(f"  responses by version tag: {by_tag}")
    print(f"  post-commit fleet consistent: "
          f"{len(set(tags.values())) == 1} "
          f"(all on {rep.new_tag[:12]})")
    print(f"  throughput {len(handles) / span:,.0f} req/s, "
          f"accuracy (mixed stream) {acc:.4f}")


def run_slo_serving(args, dev, mesh=None) -> None:
    """Two-tier SLO serving: a mixed interactive/batch Poisson stream
    through the scoreboard scheduler (EDF dispatch order with batch
    backfill, admission control shedding provably-late interactive
    requests with the typed DeadlineUnmeetable, work-stealing across
    sibling batchers).  One registry by default; ``--replicas N`` runs
    the same stream through a tiered fleet."""
    from repro_torch.launch.fleet import LutFleet
    from repro_torch.launch.registry import ModelRegistry
    from repro_torch.launch.scheduler import (BATCH, interactive_tier,
                                              replay_tiered_open_loop,
                                              tier_report)

    spec, source, data, origin = load_or_build_lut_model(
        args.lut_train_steps, artifact_dir=args.artifact_dir,
        save=args.save_artifact, device=dev)
    _, codes = request_codes(spec.layer_specs()[0].in_quant, data,
                             args.requests)

    it = interactive_tier(args.interactive_deadline_ms / 1e3)
    tiers = [it, BATCH]
    # Bresenham interleave: ~interactive_frac of the stream is
    # deadline-class, evenly mixed with best-effort traffic
    k = max(0, min(10, round(args.interactive_frac * 10)))
    pattern = [it if (i * k) // 10 != ((i + 1) * k) // 10 else BATCH
               for i in range(10)]
    if not any(t is it for t in pattern):
        pattern = [BATCH]

    if args.replicas:
        path = _fleet_artifact_path(args, spec, source, origin)
        with LutFleet(args.replicas, args.microbatch,
                      args.deadline_ms / 1e3, device=dev, mesh=mesh,
                      slo_tiers=tiers, work_stealing=True) as fleet:
            fleet.distribute_artifact(path, "m")
            replay = replay_tiered_open_loop(
                fleet.client("m"), codes, args.rate, pattern)
        where = f"fleet x{args.replicas}"
    else:
        with ModelRegistry(args.microbatch, args.deadline_ms / 1e3,
                           device=dev, mesh=mesh, slo_tiers=tiers,
                           work_stealing=True) as reg:
            reg.register("m", source)
            replay = replay_tiered_open_loop(
                reg.client("m"), codes, args.rate, pattern)
        where = "1 host"

    report = tier_report(replay)
    print(f"lut-serve[slo-tiers, {where}, {origin}] "
          f"shards={args.shards or 1} "
          f"microbatch={args.microbatch} flush-deadline="
          f"{args.deadline_ms}ms rate={args.rate:,.0f}/s "
          f"interactive-slo={args.interactive_deadline_ms}ms:")
    for name, ent in sorted(report.items()):
        line = (f"  {name:<12} offered {ent['offered']:>6} shed "
                f"{ent['shed']:>5} ({ent['shed_rate'] * 100:.1f}%) "
                f"p50 {ent['p50_ms']:.2f} ms p99 {ent['p99_ms']:.2f} ms "
                f"{ent['throughput_req_s']:,.0f} req/s")
        if "attainment" in ent:
            line += f" attainment {ent['attainment'] * 100:.1f}%"
        print(line)
    hung = sum(1 for h in replay.handles if h is not None and not h.done)
    print(f"  sheds all typed, silent drops 0, hung handles {hung}")


def lut_mesh(shards: int, dev: torch.device):
    """``--shards``: None for 0, else ``serving_mesh(shards)`` over the
    visible cards, or over ``host_devices()`` when ``dev`` is the CPU
    (raises ValueError beyond what is visible)."""
    if not shards:
        return None
    from repro_torch.device import host_devices
    from repro_torch.parallel.sharding import serving_mesh
    return serving_mesh(shards, devices=host_devices()
                        if dev.type == "cpu" else None)


def serve_lut(args) -> Optional[LutServeResult]:
    """The ``--lut`` mode.  Returns the main path's ``LutServeResult``
    (None for the demo and fleet modes, which only print)."""
    dev = resolve_device(args.device)
    mesh = lut_mesh(args.shards, dev)
    if mesh is not None:
        dev = mesh.device_list[0]
    if args.slo_tiers:
        run_slo_serving(args, dev, mesh)
        return None
    if args.fleet_swap_demo:
        run_fleet_swap_demo(args, dev, mesh)
        return None
    if args.swap_demo:
        run_swap_demo(args, dev, mesh)
        return None
    if args.replicas:
        run_fleet_serving(args, dev, mesh)
        return None

    spec, source, data, origin = load_or_build_lut_model(
        args.lut_train_steps, artifact_dir=args.artifact_dir,
        save=args.save_artifact, device=dev)
    return drive_lut_serving(
        source, spec, data, requests=args.requests,
        microbatch=args.microbatch, deadline_ms=args.deadline_ms,
        rate=args.rate, device=dev, origin=origin, mesh=mesh,
        header=f"lut-serve[{origin}] device={dev} "
               f"shards={args.shards or 1} "
               f"microbatch={args.microbatch} deadline={args.deadline_ms}ms "
               f"rate={args.rate:,.0f}/s:")


def init_lm(arch: str, smoke: bool = True, device: DeviceLike = None,
            seed: int = 0):
    """-> (cfg, params): the arch's config and weights drawn on
    ``device`` from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = R.get_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, LM.init_params(cfg, gen, dev)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int = 0,
                device: DeviceLike = None) -> torch.Tensor:
    """Random token ids (batch, prompt_len) from a numpy seed."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.from_numpy(ids).to(resolve_device(device))


@dataclasses.dataclass
class LMServeResult:
    tokens: torch.Tensor          # (B, gen): the tokens fed to decode
    prefill_s: float              # host clock, prefill to its logits
    decode_s: float               # host clock, all decode steps
    # the prefill's logits then each decode step's, (B, V) float32
    # (kept only when asked for)
    logits: List[torch.Tensor]

    @property
    def tokens_per_s(self) -> float:
        B, gen = self.tokens.shape
        return B * gen / max(self.decode_s, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(params: dict, cfg, prompt: torch.Tensor, gen: int,
             temperature: float = 0.0, seed: int = 1,
             keep_logits: bool = False) -> LMServeResult:
    """Prefill ``prompt`` (B, P), then ``gen`` decode steps, each fed the
    token chosen from the previous logits (argmax, or a sample at
    ``temperature`` from a generator seeded with ``seed``)."""
    dev = prompt.device
    P = prompt.shape[1]
    prefill = R.make_prefill_step(cfg, max_len=P + gen)
    serve = R.make_serve_step(cfg)
    sampler = torch.Generator(device=dev).manual_seed(seed)

    def choose(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return torch.argmax(logits, dim=-1, keepdim=True)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    kept = [logits] if keep_logits else []

    tokens = []
    tok = choose(logits)
    t0 = time.perf_counter()
    for i in range(gen):
        tokens.append(tok)
        logits, cache = serve(params, cache, tok, P + i)
        if keep_logits:
            kept.append(logits)
        tok = choose(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    out = (torch.cat(tokens, dim=1) if tokens
           else torch.zeros((prompt.shape[0], 0), dtype=torch.long,
                            device=dev))
    return LMServeResult(tokens=out, prefill_s=prefill_s,
                         decode_s=decode_s, logits=kept)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help=f"architecture id (ported: {sorted(R.ARCHS)})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--lut", action="store_true",
                    help="serve a synthesised LUT-DNN through the "
                         "registry's deadline-flush batcher")
    ap.add_argument("--lut-train-steps", type=int, default=150)
    ap.add_argument("--artifact-dir", default=None,
                    help="compile-once artifact store: cold-load the "
                         "newest artifact here instead of retraining")
    ap.add_argument("--save-artifact", action="store_true",
                    help="persist the synthesised network to "
                         "--artifact-dir after training")
    ap.add_argument("--swap-demo", action="store_true",
                    help="multi-model registry demo: hot-swap a second "
                         "artifact version under live load")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through an N-replica fleet (router + "
                         "verified artifact distribution; 0 = one host)")
    ap.add_argument("--fleet-swap-demo", action="store_true",
                    help="fleet demo: two-phase coordinated hot-swap "
                         "across all replicas under live load")
    ap.add_argument("--slo-tiers", action="store_true",
                    help="two-tier SLO serving through the scoreboard "
                         "scheduler, with work-stealing")
    ap.add_argument("--interactive-deadline-ms", type=float, default=25.0,
                    help="hard per-request SLO for the interactive tier")
    ap.add_argument("--interactive-frac", type=float, default=0.5,
                    help="fraction of the stream submitted as "
                         "interactive-tier requests")
    ap.add_argument("--microbatch", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=2.0)
    ap.add_argument("--shards", type=int, default=0,
                    help="devices to split each LUT microbatch over "
                         "(0 = unsharded); with --device cpu, CPU entries "
                         "(repro_torch.device.ensure_host_devices)")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--rate", type=float, default=50_000.0)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-int8", action="store_true",
                    help="serve with the int8 KV cache")
    args = ap.parse_args(argv)

    if args.lut:
        return serve_lut(args)

    if R.is_encdec(R.get_config(args.arch, smoke=args.smoke)):
        raise SystemExit("use the encdec example for whisper serving")
    cfg, params = init_lm(args.arch, smoke=args.smoke, device=args.device)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    dev = resolve_device(args.device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, device=dev)
    res = serve_lm(params, cfg, prompt, args.gen,
                   temperature=args.temperature)
    print(f"arch={cfg.name} kv={cfg.kv_cache_dtype} batch={args.batch} "
          f"prefill={res.prefill_s * 1e3:.1f}ms "
          f"decode={res.decode_s * 1e3:.1f}ms "
          f"({res.tokens_per_s:.1f} tok/s) "
          f"first tokens={res.tokens[0, :8].tolist()}")
    return res


if __name__ == "__main__":
    main()
