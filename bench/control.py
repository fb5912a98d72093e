"""Readings of the comparison that decides ``correct``, for its control
and for the program, at a cell's own size, on the card.

    python3 bench/control.py --workload <name> --seeds 1 2 3 [--program]

For each seed it makes the cell's network and input pool as a run does,
draws as many batches as a run compares, and reads the comparison's
numbers (``harness/check.py``) for the control: the reference with its
tables one storage step narrower (``reference/control.py``) put in the
program's place.  ``--program`` reads them for the program's serving
callable on the same batches too.  One JSON line a seed and side.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "bench")]


def readings(bench, workload: str, seed: int, device,
             program: bool = False) -> dict:
    """{"control": numbers compared[, "program": ...]} of one seed."""
    from functools import partial

    from harness import check, data
    from reference.control import control_layers
    from reference.lut import network_forward

    wl = bench.workload(workload)
    cfg, traffic = bench.config(wl["config"]), bench.traffic(wl["traffic"])
    g = data.generator(seed, device)
    raw = data.make_network(cfg, g, device)
    pool = data.make_pool(cfg, traffic, g, device)
    rng = random.Random(seed)
    keep = traffic["check_batches"]
    picks = [rng.randrange(pool.shape[0]) for _ in range(keep)]
    control = partial(network_forward, layers=control_layers(raw))
    kept = [(i, p, control(pool[p])) for i, p in enumerate(picks)]
    out = {"control": check.compare(kept, pool, raw, want_kept=keep)}
    if program:
        from repro_torch.kernels.lut_gather import ops
        fn = ops.make_network_fn(data.port_tables(raw), n_in0=cfg["n_in"],
                                 device=device)
        kept = [(i, p, fn(pool[p]).cpu()) for i, p in enumerate(picks)]
        out["program"] = check.compare(kept, pool, raw, want_kept=keep)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from harness.spec import Benchmark
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Benchmark(ROOT)
    for seed in args.seeds:
        for side, r in readings(bench, args.workload, seed, device,
                                args.program).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
