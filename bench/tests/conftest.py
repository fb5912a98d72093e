"""Paths and a tiny cell for the harness's CPU tests.

Run them with ``python -m pytest bench/tests -q`` from the root of the
checkout; the ``gpu`` cases skip without a CUDA card (on the card:
``python -m pytest bench/tests -q -m gpu``).
"""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# a network with every storage the generator lays out: int4 (codes of
# at most 4 bits), uint8 (5 to 8) and int32 (16-bit output codes), and a
# layer without an adder
TINY_CONFIG = {
    "name": "tiny", "n_in": 12, "input_bits": 2,
    "layers": [
        {"n_in": 12, "n_out": 8, "A": 2, "F": 2, "in_bits": 2,
         "sub_bits": 3, "out_bits": 5},
        {"n_in": 8, "n_out": 6, "A": 1, "F": 1, "in_bits": 5,
         "sub_bits": 3, "out_bits": 3},
        {"n_in": 6, "n_out": 4, "A": 2, "F": 2, "in_bits": 3,
         "sub_bits": 6, "out_bits": 16},
    ],
    "reduced": [],
}
TINY_TRAFFIC = {"kind": "batches", "batch_rows": 64, "in_flight": 2,
                "pool_batches": 3, "codes": "uniform", "check_batches": 4,
                "warm_batches": 2, "trace_batches": 4}


def config_file(name):
    """``bench/configs/<name>.json``, also one that no cell names yet."""
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def skip_without_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny cell added as a later change
    would add one: new files and new entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(root / "bench" / "configs" / "tiny.json", "w") as f:
        json.dump(TINY_CONFIG, f)
    with open(root / "bench" / "traffic" / "tiny-mix.json", "w") as f:
        json.dump(TINY_TRAFFIC, f)
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "bench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.mix", "config": "tiny",
                              "traffic": "tiny-mix", "chips": 1,
                              "why": "test"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    return root
