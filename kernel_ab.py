#!/usr/bin/env python3
"""Time the LUT and WKV6 kernels of one source tree on a CUDA card, with
the timers of ``chip_smoke.py``, so that two commits compare on one card.

    python3 kernel_ab.py LABEL [--src DIR]

builds the kernel libraries of the ``repro_torch`` package under ``DIR``
(default: this checkout's ``src/``), times its kernels as the ``[width]``
and ``[wkv]`` phases of ``chip_smoke.py`` do (HDR-Add2 and JSC-XL-Add2 at
B=4096 and 256 with uint8 and int4 slabs; WKV6 at rwkv6-3b's prefill call
in bf16 and float32 and at a decode step), writes
``chiprun_out/times_LABEL.json`` and prints one JSON summary line.  Every
time is from this file's timers whatever tree it runs, which an older
commit's own ``chip_smoke.py`` cannot promise.

To compare a parent commit with a change, unpack the parent into the
gitignored ``_chipcheck/`` and run, in one session on one card, in turns:

    git archive <parent> | tar -x -C _chipcheck/parent
    for t in parentA changeA changeB parentB; do
      case $t in parent*) s=_chipcheck/parent/src;; *) s=src;; esac
      python3 kernel_ab.py $t --src $s
    done
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label", help="names chiprun_out/times_LABEL.json")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch is timed "
                    "(default: this checkout's src/)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"kernel_ab: {src}/repro_torch not found", file=sys.stderr)
        return 2
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
    results = {}
    CS.time_lut(dev, results, np.random.default_rng(2024))
    CS.time_wkv(dev, results)
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


if __name__ == "__main__":
    sys.exit(main())
