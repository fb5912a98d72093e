"""The plain reference against a network worked by hand, and against
the port's CPU path (the test may import the port; the reference may
not)."""
import dataclasses

import pytest
import torch

from conftest import TINY_CONFIG, TINY_TRAFFIC
from harness import data
from reference.lut import network_forward


@dataclasses.dataclass
class Layer:
    conn: torch.Tensor
    sub: torch.Tensor
    add: torch.Tensor
    in_bits: int
    sub_bits: int


def t(x):
    return torch.tensor(x, dtype=torch.int32)


def test_two_layer_network_by_hand():
    # layer 1: 3 one-bit inputs -> 2 neurons of A=2 sub-neurons, F=1;
    # adder address = s0 | s1 << 1 into 2-bit codes
    l1 = Layer(conn=t([[[0], [1]], [[2], [0]]]),
               sub=t([[[0, 1], [1, 0]], [[1, 1], [0, 1]]]),
               add=t([[3, 2, 1, 0], [0, 1, 2, 3]]), in_bits=1, sub_bits=1)
    # layer 2: no adder; F=2 over 2-bit codes, address = h1 | h0 << 2
    l2 = Layer(conn=t([[[1, 0]]]), sub=t([[list(range(15, -1, -1))]]),
               add=torch.zeros((1, 0), dtype=torch.int32), in_bits=2,
               sub_bits=4)
    x = t([[1, 0, 1], [0, 1, 0], [1, 1, 0]])
    # row 0: n0 s=(1,1) -> add[0][3]=0; n1 s=(1,1) -> 3; 15-(3|0<<2)=12
    # row 1: n0 s=(0,0) -> 3; n1 s=(1,0) -> add[1][1]=1; 15-(1|3<<2)=2
    # row 2: n0 s=(1,0) -> 2; n1 s=(1,1) -> 3; 15-(3|2<<2)=4
    assert network_forward(x, [l1, l2]).tolist() == [[12], [2], [4]]
    assert network_forward(x, [l1, l2], block_rows=2).tolist() == \
        [[12], [2], [4]]


def test_out_of_range_code_raises():
    l1 = Layer(conn=t([[[0]]]), sub=t([[[0, 1]]]),
               add=torch.zeros((1, 0), dtype=torch.int32), in_bits=1,
               sub_bits=1)
    with pytest.raises(IndexError):
        network_forward(t([[2]]), [l1])


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_reference_equals_port_cpu_path(seed):
    from repro_torch.kernels.lut_gather import ops
    dev = torch.device("cpu")
    g = data.generator(seed, dev)
    raw = data.make_network(TINY_CONFIG, g, dev)
    pool = data.make_pool(TINY_CONFIG, TINY_TRAFFIC, g, dev)
    tables = data.port_tables(raw)
    assert [(x.sub_packed, x.sub_table.dtype, x.add_packed,
             x.add_table.dtype) for x in tables] == [
        (True, torch.uint8, False, torch.uint8),
        (True, torch.uint8, False, torch.uint8),
        (False, torch.uint8, False, torch.int32)]
    fn = ops.make_network_fn(tables, n_in0=TINY_CONFIG["n_in"], device=dev)
    for p in range(pool.shape[0]):
        want = network_forward(pool[p], raw, block_rows=17)
        assert want.shape == (TINY_TRAFFIC["batch_rows"], 4)
        assert torch.equal(fn(pool[p]), want)


def test_same_seed_same_data_and_sizes_for_every_seed():
    dev = torch.device("cpu")
    a = data.make_pool(TINY_CONFIG, TINY_TRAFFIC, data.generator(5, dev), dev)
    b = data.make_pool(TINY_CONFIG, TINY_TRAFFIC, data.generator(5, dev), dev)
    c = data.make_pool(TINY_CONFIG, TINY_TRAFFIC, data.generator(6, dev), dev)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == c.shape and a.dtype == torch.int32
    assert int(a.max()) < 2 ** TINY_CONFIG["input_bits"]
