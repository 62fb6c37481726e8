"""intra_host_ms: the host's time inside the program's "hevcasm.intra" span
(the closed-loop I frame: the wavefront luma and both chroma planes), a GOP
on average over the "hevcasm.gop_closed_yuv" spans of the traced
sub-window (ms, profiler clock)."""

from hevcbench import spans


def read(rec):
    return spans.host_ms(rec, spans.GOP, spans.INTRA)
