"""The port's compile-once LUT serving CLI (``python -m
repro_torch.launch.serve --lut``) on the CPU, held to
``tests/test_serve_smoke.py``'s contract: train -> synthesise -> save an
artifact -> serve a Poisson stream through the registry, then a second
run that cold-loads the artifact, skips training and serves the same
accuracy.  Then the reference's ``--lut`` machinery
(``load_or_build_lut_model`` + ``make_network_fn`` + ``run_lut_load``)
and the port's answer every request of one stream identically on that
artifact."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.lut_gather import ops as tops
from repro_torch.launch import serve as TS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGS = ["--lut", "--device", "cpu", "--lut-train-steps", "3",
        "--requests", "48", "--rate", "20000", "--microbatch", "16",
        "--deadline-ms", "5"]


def _run(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + ARGS + extra,
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _accuracy(stdout: str) -> str:
    (line,) = [ln for ln in stdout.splitlines() if "accuracy" in ln]
    return line.rsplit("accuracy", 1)[1].strip()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(artifact dir, stdout) of one training run that saved."""
    d = tmp_path_factory.mktemp("lut-artifacts")
    return str(d), _run(["--artifact-dir", str(d), "--save-artifact"])


def test_serve_lut_save_artifact_then_cold_load(saved):
    d, first = saved
    assert "saved artifact" in first
    assert "lut-serve[trained+saved]" in first
    second = _run(["--artifact-dir", d])
    assert "cold-loaded artifact" in second
    assert "no retraining" in second
    assert "lut-serve[artifact]" in second
    # same artifact, same request stream -> identical classifications
    assert _accuracy(first) == _accuracy(second)


def test_reference_and_port_serve_one_artifact_identically(saved):
    from repro.kernels.lut_gather import ops as jops
    from repro.launch import serve as JS

    d, first = saved
    jspec, jart, jdata, _ = JS.load_or_build_lut_model(artifact_dir=d)
    tspec, tart, tdata, origin = TS.load_or_build_lut_model(
        artifact_dir=d, device="cpu")
    assert origin == "artifact" and tart.artifact_id == jart.artifact_id
    for k in ("x", "y"):
        np.testing.assert_array_equal(tdata["test"][k], jdata["test"][k])
    load = dict(n_requests=48, microbatch=16, deadline_s=5e-3, rate=20000)
    jh, _, jidx = JS.run_lut_load(
        jops.make_network_fn(jart, block_b=16),
        jspec.layer_specs()[0].in_quant, jdata, **load)
    th, _, tidx = TS.run_lut_load(
        tops.make_network_fn(tart, device="cpu"),
        tspec.layer_specs()[0].in_quant, tdata, **load)
    np.testing.assert_array_equal(tidx, jidx)
    assert len(th) == len(jh) == 48
    assert not any(h.failed for h in th + jh)
    for i, (a, b) in enumerate(zip(th, jh)):
        np.testing.assert_array_equal(a.result(), np.asarray(b.result()),
                                      err_msg=f"request {i}")
    acc = TS.lut_accuracy(th, tdata, tidx)
    assert acc == JS.lut_accuracy(jh, jdata, jidx)
    assert f"{acc:.4f}" == _accuracy(first)


def test_serve_lut_refuses_what_is_not_ported(monkeypatch):
    # --shards beyond the entries the CPU may stand as raises, naming
    # the count (tests/test_torch_sharded.py serves --shards)
    from repro_torch.device import host_devices
    n = len(host_devices()) + 1
    with pytest.raises(ValueError, match=f"{n} devices requested"):
        TS.main(ARGS + ["--shards", str(n)])
    # without --device the entry point asks for the card, and raises
    # on a machine without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--lut"])
