"""b14_roofline: B14's (base_grids_ctu) share of its roofline (%), the RD P
frame's sub-block grids at base 8."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "b14")
