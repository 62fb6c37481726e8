"""intra_host_ms.ra: the host's time inside the program's "hevcasm.intra"
span (the closed-loop I frame: the wavefront luma and both chroma planes),
a GOP on average over the "hevcasm.gop_closed_yuv_b" spans of the traced
sub-window (ms, profiler clock): intra_host_ms of the IBPBP GOP."""

from hevcbench import spans, spans_gop_b


def read(rec):
    return spans_gop_b.host_ms(rec, spans.INTRA)
