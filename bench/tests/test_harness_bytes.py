"""The forward's bytes against counts made by hand."""
import pytest

from conftest import config_file
from harness import roofline


def test_hdr_add2_bytes_by_hand():
    cfg = config_file("hdr-add2")
    # bits of conn (n_out*A*F*ceil(log2 n_in)), sub tables
    # (n_out*A*2**(2*4)*3) and adder tables (n_out*2**(2*3)*out_bits)
    l0 = 256 * 2 * 4 * 10 + 256 * 2 * 256 * 3 + 256 * 64 * 2
    l1 = 100 * 2 * 4 * 8 + 100 * 2 * 256 * 3 + 100 * 64 * 2
    l234 = 3 * (100 * 2 * 4 * 7 + 100 * 2 * 256 * 3 + 100 * 64 * 2)
    l5 = 10 * 2 * 4 * 7 + 10 * 2 * 256 * 3 + 10 * 64 * 16
    assert l0 + l1 + l234 + l5 == 1_161_424
    rows = 60_000
    want = rows * 784 * 4 + rows * 10 * 2 + 1_161_424 / 8
    assert roofline.forward_bytes(cfg, rows) == want == 189_505_178
    t = roofline.least_seconds(cfg, rows, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(56.569e-6, rel=1e-4)


def test_jsc_xl_add2_bytes_by_hand():
    cfg = config_file("jsc-xl-add2")
    # layer 0: F_i=1 over 7-bit inputs (K=128), 6-bit sub codes, adder
    # of 2**12 entries of 5 bits; hidden: F=2 over 5-bit codes (K=1024)
    l0 = 128 * 2 * 1 * 4 + 128 * 2 * 128 * 6 + 128 * 4096 * 5
    l1 = 64 * 2 * 2 * 7 + 64 * 2 * 1024 * 6 + 64 * 4096 * 5
    l23 = 2 * (64 * 2 * 2 * 6 + 64 * 2 * 1024 * 6 + 64 * 4096 * 5)
    l4 = 5 * 2 * 2 * 6 + 5 * 2 * 1024 * 6 + 5 * 4096 * 16
    assert l0 + l1 + l23 + l4 == 9_504_632
    rows = 16_384
    want = rows * 16 * 4 + rows * 5 * 2 + 9_504_632 / 8
    assert roofline.forward_bytes(cfg, rows) == want == 2_400_495


def test_unknown_card_has_no_least_time():
    cfg = config_file("hdr-add2")
    assert roofline.least_seconds(cfg, 1, "some other card") is None
