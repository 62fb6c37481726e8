"""chroma_launches: host launch records (cudaLaunch*, cuLaunch*) that start
inside the program's "hevcasm.chroma" spans, a P frame on average over the
"hevcasm.inter_yuv" spans of the traced sub-window.  Standard error also
gives the launch records inside "hevcasm.inter_yuv" and in the whole
sub-window, a frame; the rest are the harness's reads of the outputs."""

from hevcbench import spans


def read(rec):
    return spans.launches(rec, spans.P_FRAME, spans.CHROMA)
