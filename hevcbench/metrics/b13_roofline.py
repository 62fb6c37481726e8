"""b13_roofline: B13's (refine_qpel_costmap_dma) share of its roofline (%), the
RD P frame's quarter-pel cost maps of its 8x8 PU tiles."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "b13")
