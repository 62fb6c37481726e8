"""intra_launches: host launch records (cudaLaunch*, cuLaunch*) that start
inside the program's "hevcasm.intra" span, a GOP on average over the
"hevcasm.gop_closed_yuv" spans of the traced sub-window."""

from hevcbench import spans


def read(rec):
    return spans.launches(rec, spans.GOP, spans.INTRA)
