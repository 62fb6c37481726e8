"""tu_launches: host launch records (cudaLaunch*, cuLaunch*) that start
inside the program's "hevcasm.tu_select" spans, a P frame on average over
the "hevcasm.inter_yuv" spans of the traced sub-window.  Standard error also
gives the launch records inside "hevcasm.inter_yuv" and in the whole
sub-window, a frame."""

from hevcbench import spans

TU_SELECT = "hevcasm.tu_select"


def read(rec):
    return spans.launches(rec, spans.P_FRAME, TU_SELECT)
