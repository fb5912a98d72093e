"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_under_bench_imports_jax_or_repro():
    found = {(os.path.relpath(p, BENCH), m) for p in _sources(BENCH)
             for m in _imports(p) if m.split(".")[0] in FORBIDDEN}
    assert not found
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port_or_harness():
    ref = os.path.join(BENCH, "reference")
    found = {(os.path.relpath(p, BENCH), m) for p in _sources(ref)
             for m in _imports(p)
             if m.split(".")[0] in ("repro_torch", "harness")}
    assert not found


PROBE = """
import sys
sys.argv = ["run.py"]
sys.path.insert(0, {bench!r})
import run
import control
import harness.cell, harness.check, harness.data, harness.roofline
import harness.schedule, harness.spec, harness.trace, harness.window
import reference.control, reference.lut
from repro_torch.kernels.lut_gather import ops
bench = harness.spec.Benchmark({root!r})
for w in bench.spec["workloads"]:
    bench.readers(w["name"])
    bench.driver(bench.traffic(w["traffic"])["kind"])
print(run.forbidden_modules())
"""


def test_loading_the_harness_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=BENCH, root=ROOT)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
