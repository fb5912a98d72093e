#!/usr/bin/env python3
"""Compare the LUT serving path of several source trees on one CUDA
card, in turns, with one set of probes.

    python3 serve_ab.py LABEL=DIR [LABEL=DIR ...] --order L1,L2,...
                        [--phases width,serve+fleet,train] [--burn N]

For each label of ``--order`` in turn, copies this checkout's
``chip_smoke.py`` into that label's tree ``DIR`` (so that every tree is
driven, checked and timed by the same code) and runs there ``python3
chip_smoke.py --phases P`` once for each ``+``-separated group ``P`` of
``--phases``, each in a process of its own (a check that fails in one
group leaves the next to run): by default ``[serve]``'s stream five
times after ``[width]``, then ``[fleet]``'s two worker processes once
and ``[train]``'s ``serve --lut`` five times, each stream under
``FlushProbe``.  Each process's log goes to
``chiprun_out/serve_ab_<turn>_<label>_<group>.log``;
``chiprun_out/serve_ab.json`` holds every turn's p50 / p99 and largest
flush a run, also of a group whose check failed; one line a turn is
printed.  Exits non-zero if a process fails.  ``--burn N`` loads the
host as a noisy neighbour would: N other processes spin on the CPU for
as long as each group runs.

To hold a change against its parent, and against the change with one
part taken out, unpack them into the gitignored ``_chipcheck/`` first:

    mkdir -p _chipcheck/parent && git archive <parent> | tar -x -C _chipcheck/parent
    python3 serve_ab.py parent=_chipcheck/parent change=. \\
        --order parent,change,change,parent
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def summary(results: dict) -> dict:
    """p50 / p99 / largest flush (ms) of each served run of a turn."""
    def runs(rs):
        return [[r["p50_ms"], r["p99_ms"], r["max_ms"], r["median_ms"]]
                for r in rs]
    out = {}
    if "_serve" in results:
        out["serve"] = runs(results["_serve"]["runs"])
    if "_fleet" in results:
        f = results["_fleet"]
        out["fleet"] = [f["p50_ms"], f["p99_ms"]]
    if "_train" in results:
        out["train"] = runs(results["_train"]["served_runs"])
    return out


def line(label: str, s: dict) -> str:
    def fmt(rs):
        return " ".join(f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c, _ in rs)
    parts = [label]
    if "serve" in s:
        parts.append(f"[serve] p50/p99/max {fmt(s['serve'])}")
    if "fleet" in s:
        parts.append(f"[fleet] {s['fleet'][0]:.3f}/{s['fleet'][1]:.3f}")
    if "train" in s:
        parts.append(f"[train] {fmt(s['train'])}")
    return "; ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="LABEL=DIR")
    ap.add_argument("--order", required=True)
    ap.add_argument("--phases", default="width,serve+fleet,train")
    ap.add_argument("--burn", type=int, default=0,
                    help="processes spinning beside each group")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.trees)
    order = args.order.split(",")
    unknown = [lab for lab in order if lab not in trees]
    if unknown:
        ap.error(f"no tree for {unknown}")
    if shutil.which("nvidia-smi") is None:
        print("serve_ab: no nvidia-smi — this runs on a CUDA card",
              file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    turns, rc = [], 0
    for i, label in enumerate(order, 1):
        tree = os.path.abspath(trees[label])
        if os.path.realpath(tree) != os.path.realpath(ROOT):
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
        partial = os.path.join(tree, "chiprun_out",
                               "chip_smoke_partial.json")
        turn = dict(turn=i, label=label, rcs=[], wall_s=[])
        for g, phases in enumerate(args.phases.split("+"), 1):
            if os.path.exists(partial):
                os.remove(partial)
            log = os.path.join(OUT_DIR, f"serve_ab_{i}_{label}_{g}.log")
            burners = [subprocess.Popen([sys.executable, "-c",
                                         "while True: pass"])
                       for _ in range(args.burn)]
            t0 = time.monotonic()
            try:
                with open(log, "w") as f:
                    p = subprocess.run([sys.executable, "chip_smoke.py",
                                        "--phases", phases], cwd=tree,
                                       stdout=f, stderr=subprocess.STDOUT)
            finally:
                for b in burners:
                    b.kill()
                    b.wait()
            turn["wall_s"].append(time.monotonic() - t0)
            turn["rcs"].append(p.returncode)
            if p.returncode != 0:
                print(f"turn {i} {label} {phases}: rc {p.returncode}, see "
                      f"{os.path.relpath(log, ROOT)}", flush=True)
                rc = rc or p.returncode
            if os.path.exists(partial):
                with open(partial) as f:
                    turn.update(summary(json.load(f)["results"]))
        turns.append(turn)
        print(f"turn {i} " + line(label, turn) + f"; rcs {turn['rcs']}, "
              f"{sum(turn['wall_s']):.1f} s", flush=True)
    with open(os.path.join(OUT_DIR, "serve_ab.json"), "w") as f:
        json.dump(dict(card=card, phases=args.phases, burn=args.burn,
                       trees=trees, turns=turns), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
