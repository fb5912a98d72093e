"""A whole run of a cell on the CPU, past the harness's look for a card:
sound, it is correct; with the timed path broken underneath, once for
each fault a batched forward can have, it is not."""
import time

import pytest
import torch

from harness.cell import run_cell
from harness.spec import Benchmark


def _run(root, seed=11):
    out = run_cell(Benchmark(str(root)), "tiny.mix", seed, 0.2, False,
                   torch.device("cpu"), [("start", time.perf_counter())])
    assert list(out)[-1] == "checked"
    assert set(out["metrics"]) == {"samples_per_s", "batch_p95_ms",
                                   "setup_s"}
    return out


def test_sound_run_is_correct(tiny_root):
    out = _run(tiny_root)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] > 4
    assert out["checked"]["mismatched_codes"] == {"value": 0, "limit": 0}
    assert out["device"]["platform"] == "cpu"
    assert all(m["value"] > 0 for m in out["metrics"].values())


def _altered(fn):
    def run(codes):
        out = fn(codes).clone()
        out[0, 0] ^= 1
        return out
    return run


def _half_left_out(fn):
    def run(codes):
        half = codes.shape[0] // 2
        out = torch.zeros((codes.shape[0], 4), dtype=torch.int32)
        out[:half] = fn(codes[:half])
        return out
    return run


def _state_unchanged(fn):
    first = []

    def run(codes):
        if not first:
            first.append(fn(codes))
        return first[0]
    return run


@pytest.mark.parametrize("fault", [_altered, _half_left_out,
                                   _state_unchanged])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    from repro_torch.kernels.lut_gather import ops
    make = ops.make_network_fn
    monkeypatch.setattr(ops, "make_network_fn",
                        lambda *a, **k: fault(make(*a, **k)))
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checked"]["mismatched_codes"]["value"] > 0
    assert out["failed"] > 0
