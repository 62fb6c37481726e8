"""b3_roofline: B3's (bi_ctu_fused_dma) share of its roofline (%)."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "b3")
