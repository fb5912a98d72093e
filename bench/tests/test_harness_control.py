"""The control of the comparison (the reference with its tables one
storage step narrower) comes out not correct: at a small size here, at
the cells' own sizes on the card."""
import pytest
import torch

from conftest import TINY_CONFIG, TINY_TRAFFIC, skip_without_card
from harness import check, data
from reference.control import control_layers, narrowed
from reference.lut import network_forward


def test_narrowing_steps():
    codes = torch.tensor([0xABCD, 0x00FF], dtype=torch.int32)
    assert narrowed(codes, 16).tolist() == [0xAB00, 0x0000]
    six = torch.tensor([0b101101, 0b000011], dtype=torch.int32)
    assert narrowed(six, 6).tolist() == [0b101100, 0b000000]
    three = torch.tensor([5, 7], dtype=torch.int32)
    assert narrowed(three, 3).tolist() == [5, 7]   # int4: no step below


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_at_a_small_size(seed):
    dev = torch.device("cpu")
    g = data.generator(seed, dev)
    raw = data.make_network(TINY_CONFIG, g, dev)
    pool = data.make_pool(TINY_CONFIG, TINY_TRAFFIC, g, dev)
    ctrl = control_layers(raw)
    kept = [(p, p, network_forward(pool[p], ctrl))
            for p in range(pool.shape[0])]
    r = check.compare(kept, pool, raw, want_kept=len(kept))
    assert r["mismatched_codes"] > 0 and not check.verdict(r)
    sound = [(p, p, network_forward(pool[p], raw))
             for p in range(pool.shape[0])]
    assert check.verdict(check.compare(sound, pool, raw,
                                       want_kept=len(sound)))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["hdr-add2.eval-60k"])
def test_control_fails_at_the_cells_size_on_the_card(workload):
    skip_without_card()
    import control
    from harness.spec import Benchmark
    bench = Benchmark()
    for seed in (101, 2 ** 31 + 5, 77777):
        r = control.readings(bench, workload, seed,
                             torch.device("cuda", 0), program=True)
        assert r["control"]["mismatched_codes"] > 0
        assert not check.verdict(r["control"])
        assert check.verdict(r["program"]), r["program"]
