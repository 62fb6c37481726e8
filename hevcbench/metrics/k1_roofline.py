"""k1_roofline: K1's (ssd_grid_plane) share of its roofline (%)."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "k1")
