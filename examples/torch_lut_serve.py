"""Multi-model LUT serving with the PyTorch + CUDA port: compile-once
artifacts and a hot-swap registry (port of ``examples/lut_serve.py``).

  1. **compile once**: each model variant is trained and synthesised to
     truth tables once on the card and saved as a content-addressed
     artifact (``repro_torch/artifact``);
  2. **serve many**: a later run cold-loads the artifacts (no training)
     and registers them in a ``launch/registry.ModelRegistry``, one fused
     LUT kernel (``kernels/lut_gather``) and one deadline-flush
     micro-batcher per model id, all serving from one process;
  3. **swap live**: a new artifact version warms off the serving path
     and replaces its model id atomically; no request drops.

    PYTHONPATH=src python examples/torch_lut_serve.py \\
        --artifact-dir /tmp/lut-artifacts --train-steps 150
    # later (cold start, no retraining):
    PYTHONPATH=src python examples/torch_lut_serve.py \\
        --artifact-dir /tmp/lut-artifacts

It runs on the CUDA card unless ``--device`` names another device.
``--shards N`` splits each microbatch over N devices, tables
replicated on each (the first N cards; with ``--device cpu`` the CPU as
N entries, after ``repro_torch.device.ensure_host_devices(N)``).  The
fleet, two-phase swaps and SLO tiers are in ``python -m
repro_torch.launch.serve --lut --help``.
"""
import argparse
import os
import tempfile
import threading
import time

from repro_torch.artifact import find_artifacts, load_artifact, save_artifact
from repro_torch.core.cost_model import model_cost
from repro_torch.device import resolve_device
from repro_torch.launch.batching import (latency_percentiles_ms,
                                         replay_open_loop)
from repro_torch.launch.registry import ModelRegistry
from repro_torch.launch.serve import (build_lut_model, lut_accuracy,
                                      lut_dataset, lut_mesh, request_codes)

# one registry, several architectures + a v2 of the first (the hot-swap
# payload).  kw feeds launch/serve.build_lut_model.
MODEL_DEFS = {
    "jsc-base":    dict(fan_in=3, adder_width=2, seed=0),
    "jsc-lite":    dict(fan_in=2, adder_width=1, seed=0),
    "jsc-base-v2": dict(fan_in=3, adder_width=2, seed=99),
}


def compile_or_load(art_dir: str, train_steps: int, dev):
    """Stages 1 and 2: per model id, cold-load its artifact when present,
    otherwise train, synthesise and save, then load through the artifact
    (so every serving path below runs off the deployable format)."""
    arts = {}
    for mid, kw in MODEL_DEFS.items():
        subdir = os.path.join(art_dir, mid)
        t0 = time.monotonic()
        if find_artifacts(subdir):
            # int4 slabs stay two codes a byte into the fused kernel
            art = load_artifact(subdir, unpack_int4=False, device=dev)
            print(f"  {mid}: cold-loaded {art.artifact_id[:12]} in "
                  f"{(time.monotonic() - t0) * 1e3:.1f} ms (no training)")
        else:
            spec, tables, _ = build_lut_model(train_steps, device=dev, **kw)
            path = save_artifact(subdir, tables, name=mid, spec=spec,
                                 provenance=dict(kw,
                                                 train_steps=train_steps))
            art = load_artifact(path, unpack_int4=False, device=dev)
            print(f"  {mid}: trained+compiled in "
                  f"{time.monotonic() - t0:.1f} s -> "
                  f"{art.artifact_id[:12]} "
                  f"(modeled FPGA: {model_cost(spec)})")
        arts[mid] = art
    return arts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact-dir", default=None,
                    help="artifact store (default: a fresh temporary "
                         "directory, i.e. compile on every run)")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--microbatch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=2048,
                    help="stream length per served model")
    ap.add_argument("--rate", type=float, default=20_000.0,
                    help="offered Poisson load per model (req/s)")
    ap.add_argument("--deadline-ms", type=float, default=2.0)
    ap.add_argument("--shards", type=int, default=0,
                    help="devices to split each microbatch over (0 = "
                         "unsharded)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = lut_mesh(args.shards, dev)
    if mesh is not None:
        dev = mesh.device_list[0]

    art_dir = args.artifact_dir or tempfile.mkdtemp(prefix="lut-artifacts-")
    print(f"artifact store: {art_dir}  device: {dev}")
    arts = compile_or_load(art_dir, args.train_steps, dev)

    data = lut_dataset(seed=0)
    served_ids = ["jsc-base", "jsc-lite"]
    streams = {mid: request_codes(arts[mid].spec.layer_specs()[0].in_quant,
                                  data, args.requests, seed=i)
               for i, mid in enumerate(served_ids)}

    results = {}
    with ModelRegistry(args.microbatch, args.deadline_ms / 1e3,
                       device=dev, mesh=mesh) as reg:
        for mid in served_ids:
            reg.register(mid, arts[mid])
        print(f"registry serving {reg.model_ids()} "
              f"(shards={args.shards or 1})")
        for mid in served_ids:
            print(f"  {mid}: {reg.get(mid).plan.describe()}")

        handles = {mid: [] for mid in served_ids}
        t0 = time.monotonic()
        feeders = [threading.Thread(
            target=lambda m=mid: handles[m].extend(replay_open_loop(
                reg.client(m), streams[m][1], args.rate)))
            for mid in served_ids]
        for f in feeders:
            f.start()
        # stage 3: hot-swap jsc-base to v2 mid-stream, under load on
        # both models
        time.sleep(0.4 * args.requests / args.rate)
        rep = reg.swap("jsc-base", arts["jsc-base-v2"])
        for f in feeders:
            f.join()
        span = time.monotonic() - t0

        print(f"hot-swap jsc-base v{rep.old_version}->v{rep.new_version}: "
              f"warm {rep.warm_s * 1e3:.1f} ms off-path, blackout "
              f"{rep.blackout_s * 1e6:.1f} us, "
              f"{rep.drained_requests} drained on old engine")
        for mid in served_ids:
            hs = handles[mid]
            failed = sum(1 for h in hs if h.failed)
            dropped = args.requests - len(hs)
            p50, p95, p99 = latency_percentiles_ms(hs)
            acc = lut_accuracy(hs, data, streams[mid][0])
            print(f"  {mid}: {len(hs)}/{args.requests} served, "
                  f"{failed} failed, {dropped} dropped | p50 {p50:.2f} / "
                  f"p95 {p95:.2f} / p99 {p99:.2f} ms | acc {acc:.4f}")
            results[mid] = dict(served=len(hs) - failed, failed=failed,
                                dropped=dropped, p50_ms=p50, p99_ms=p99,
                                accuracy=acc)
        print(f"aggregate throughput "
              f"{sum(len(h) for h in handles.values()) / span:,.0f} req/s "
              f"across {len(served_ids)} concurrent models on {dev}")
    return results


if __name__ == "__main__":
    main()
