"""b_launches: host launch records (cudaLaunch*, cuLaunch*) that start
inside the program's "hevcasm.inter_b_yuv" spans, a GOP on average over the
"hevcasm.gop_closed_yuv_b" spans of the traced sub-window.  Standard error
also gives the launch records inside "hevcasm.gop_closed_yuv_b" and in the
whole sub-window, a GOP."""

from hevcbench import spans_gop_b


def read(rec):
    return spans_gop_b.launches(rec, spans_gop_b.B_FRAME)
