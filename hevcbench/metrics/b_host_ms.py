"""b_host_ms: the host's time inside the program's "hevcasm.inter_b_yuv"
spans (the B frames: both references' search, B3, the bi chroma and the
PSNR), a GOP on average over the "hevcasm.gop_closed_yuv_b" spans of the
traced sub-window (ms, profiler clock)."""

from hevcbench import spans_gop_b


def read(rec):
    return spans_gop_b.host_ms(rec, spans_gop_b.B_FRAME)
