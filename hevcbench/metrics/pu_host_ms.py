"""pu_host_ms: the host's time inside the program's "hevcasm.pu_decision"
spans (the RD P frame's PU decision: B14 or B15, the layout decision's glue,
B13 and the prediction's assembly), a P frame on average over the
"hevcasm.inter_yuv" spans of the traced sub-window (ms, profiler clock)."""

from hevcbench import spans

PU_DECISION = "hevcasm.pu_decision"


def read(rec):
    return spans.host_ms(rec, spans.P_FRAME, PU_DECISION)
