"""BENCHMARK.json keeps to the form the benchmark's runner reads, every
name it gives has its file, and a run without a card prints nothing."""
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_files():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        with open(os.path.join(BENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(BENCH, "drivers", kind + ".py"))
        used.add(w["config"])
    assert used == set(configs)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [x["name"] for x in spec["configs"] + spec["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    # shares of a roofline or a peak are percentages
    assert all(m["unit"] == "%" for m in metrics
               if m["name"].endswith("_roofline") or "mfu" in m["name"])
    assert len(json.dumps(spec)) < 64 * 1024


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "hdr-add2.eval-60k",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no result" in proc.stderr
