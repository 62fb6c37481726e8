"""chroma_pu_roofline: chroma_pu_fused's share of its roofline (%), the RD P
frame's chroma at an MV a PU tile."""

from hevcbench.record import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "chroma_pu")
