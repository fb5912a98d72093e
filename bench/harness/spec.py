"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), configurations and metrics.  A configuration's file is
the path its entry gives; a traffic mix is ``bench/traffic/<mix>.json``,
whose ``kind`` names the driver that runs it, ``bench/drivers/<kind>.py``
(a module with one function ``run``, see ``harness.cell``); a per-layer
metric is ``bench/metrics/<metric>.py``, a module with one function
``read(ctx)`` that returns the metric's value or None when it finds
nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "bench")
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench_dir, "traffic",
                                       f"{name}.json"))

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics a cell reports (``--trace 0``)."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics a cell reports (``--trace 1``)."""
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])]

    def _module(self, folder: str, name: str) -> ModuleType:
        """The module ``bench/<folder>/<name>.py``."""
        path = os.path.join(self.bench_dir, folder, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no bench/{folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod    # for dataclasses defined there
        spec.loader.exec_module(mod)
        return mod

    def driver(self, kind: str) -> ModuleType:
        """The module ``bench/drivers/<kind>.py``, which runs traffic of
        that kind."""
        return self._module("drivers", kind)

    def reader(self, metric: str) -> ModuleType:
        """The module ``bench/metrics/<metric>.py``."""
        return self._module("metrics", metric)

    def readers(self, workload: str) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"])
                for m in self.per_layer(workload)}
