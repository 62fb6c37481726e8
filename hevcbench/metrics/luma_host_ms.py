"""luma_host_ms: the host's time inside the program's "hevcasm.luma" spans
(the frame's tiling, the reference's padding, the search, the refinement
and residual), a P frame on average over the "hevcasm.inter_yuv" spans of
the traced sub-window (ms, profiler clock)."""

from hevcbench import spans


def read(rec):
    return spans.host_ms(rec, spans.P_FRAME, spans.LUMA)
