"""pu_launches: host launch records (cudaLaunch*, cuLaunch*) that start
inside the program's "hevcasm.pu_decision" spans, a P frame on average over
the "hevcasm.inter_yuv" spans of the traced sub-window.  Standard error also
gives the launch records inside "hevcasm.inter_yuv" and in the whole
sub-window, a frame."""

from hevcbench import spans

PU_DECISION = "hevcasm.pu_decision"


def read(rec):
    return spans.launches(rec, spans.P_FRAME, PU_DECISION)
