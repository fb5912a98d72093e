"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (the same window, then a
stretch under ``torch.profiler``).  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checked``: each
number compared beside its limit, which also close standard error).
``setup_s`` runs from this file's first statement to the first timed
batch.

Without a CUDA card the run exits 2 and prints no result; if JAX or the
JAX package ``repro`` is loaded when the window has closed it exits 3.
Build caches stay inside the checkout: the port builds its kernel
library into its package's ``kernels/*/_build/``, and the toolchains'
caches go to ``.bench_cache/``.
"""
import time

_T_NOW = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "bench")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    # set-up runs from this file's first statement: the interpreter's
    # own start-up before it is left out (the kernel's record of the
    # process's start does not agree with the clocks on every host)
    marks = [("start", _T_NOW)]
    from harness.cell import run_cell
    marks.append(("torch import", time.perf_counter()))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"

    import torch
    from harness.spec import Benchmark

    bench = Benchmark(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"cuda available={torch.cuda.is_available()}, cards="
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    marks.append(("cuda init", time.perf_counter()))
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, marks)
    bad = forbidden_modules()
    if bad:
        print(f"no result: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    print(f"[bench] {args.workload} seed {args.seed} trace {args.trace} "
          f"on {power_limit()}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    for name, v in out["checked"].items():
        print(f"checked {name} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
