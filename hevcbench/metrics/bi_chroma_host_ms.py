"""bi_chroma_host_ms: the host's time inside the program's
"hevcasm.bi_chroma" spans (each B frame's two chroma planes: two MCs to
int16 intermediates, their mean and the residual, a plane), a GOP on
average over the "hevcasm.gop_closed_yuv_b" spans of the traced sub-window
(ms, profiler clock)."""

from hevcbench import spans_gop_b


def read(rec):
    return spans_gop_b.host_ms(rec, spans_gop_b.BI_CHROMA)
