"""k2_roofline: K2's (inter_ctu_fused_dma) share of its roofline (%)."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "k2")
