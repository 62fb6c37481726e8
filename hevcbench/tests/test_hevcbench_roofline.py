"""The roofline arithmetic against hand counts for K1 and K2 at 1080p."""

import pytest

from hevcbench import roofline
from hevcbench.roofline import k1, k2

G1080 = {"width": 1920, "coded_height": 1088, "ctu": 64, "search_range": 32}


def test_k1_at_1080p():
    ops, nbytes = k1.cost(G1080)
    # 510 CTUs x 65^2 displacements x 4096 terms, a multiply-add each.
    assert ops == 2 * 510 * 65 * 65 * 4096
    # The CTUs, the plane cut to R of padding, and the int32 grids.
    assert nbytes == 510 * 4096 + 1152 * 1984 + 510 * 65 * 65 * 4
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0089195, rel=1e-4)


def test_k2_at_1080p():
    ops, nbytes = k2.cost(G1080)
    macs = 4 * 71 * 64 * 8 + 16 * 4096 * 8 + 4096 * 8
    assert ops == 510 * (2 * macs + 2 * 16 * 4096 + 2 * 4 * 4096 * 8)
    assert nbytes == 510 * 4096 + 1159 * 1991 + 510 * 8 + 510 * (4096 + 8 + 512)
    # Bound by the bytes: 0.0020 ms, chip_smoke's bound column.
    assert roofline.bound_s(ops, nbytes) == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0020163, rel=1e-4)


def test_4k_scales_with_the_ctus():
    g = dict(G1080, width=3840, coded_height=2176)
    assert k1.cost(g)[0] == 4 * k1.cost(G1080)[0]
