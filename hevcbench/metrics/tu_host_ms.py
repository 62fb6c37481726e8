"""tu_host_ms: the host's time inside the program's "hevcasm.tu_select"
spans (the RD P frame's TU decision: the residual at each TU size, each
CTU's RD cost and the chosen size's reconstruction), a P frame on average
over the "hevcasm.inter_yuv" spans of the traced sub-window (ms, profiler
clock)."""

from hevcbench import spans

TU_SELECT = "hevcasm.tu_select"


def read(rec):
    return spans.host_ms(rec, spans.P_FRAME, TU_SELECT)
