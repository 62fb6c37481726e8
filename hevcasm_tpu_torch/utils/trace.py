"""Spans of the port's layers, recorded only inside a torch.profiler session.

``with span("hevcasm.chroma"): ...`` records a host range of that name into
the profiler's trace when one is running: a ``cpu_op`` at scope FUNCTION, the
kind of record an aten op leaves (``torch._C._profiler._RecordFunctionFast``).
It is not ``torch.profiler.record_function``: that records a user-scope range,
which the profiler mirrors on the card as a ``gpu_user_annotation`` record, so
each span would read as device work.  The spans share the trace, and its clock,
with the card's kernel, copy and memset records; they are kept in the
profiler's memory and read when its session ends.

With no profiler running, ``span`` returns one shared null context: a span
then costs one check of the profiler's flag, and records and allocates
nothing.

The spans of one request are those inside its entry span on the calling
thread: ``hevcasm.inter_yuv`` for a 4:2:0 P frame, ``hevcasm.inter_b_yuv``
for a 4:2:0 B frame, ``hevcasm.gop_closed_yuv`` for a closed-loop 4:2:0 IPPP
GOP and ``hevcasm.gop_closed_yuv_b`` for a closed-loop 4:2:0 IBPBP GOP.  A
span's parent is the innermost span that contains it: in the IBPBP GOP the
I frame's ``hevcasm.intra``, each P frame's ``hevcasm.inter_yuv``, each B
frame's ``hevcasm.inter_b_yuv`` (over ``hevcasm.bi_luma``,
``hevcasm.bi_chroma`` and ``hevcasm.psnr``; ``hevcasm.bi_chroma`` over each
plane's two ``hevcasm.chroma_mc`` and one ``hevcasm.chroma_residual``) and
``hevcasm.gop_stack`` lie inside ``hevcasm.gop_closed_yuv_b``.  The RD P
frame (pu_decision, tu_sizes) records ``hevcasm.pu_decision`` (over
``hevcasm.pu_grids``, ``hevcasm.pu_layout`` and ``hevcasm.pu_refine``) and
``hevcasm.tu_select`` inside ``hevcasm.luma`` of its ``hevcasm.inter_yuv``
on the 4:2:0 frame, and at the top level on the luma frame
(encode_inter_frame).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["SPANS", "span"]

#: Every span name the port records.
SPANS = (
    "hevcasm.inter_yuv",        # encode_inter_frame_yuv: the whole call
    "hevcasm.luma",             # its luma: prepare, pad, _inter_core, untile
    "hevcasm.search",           # _inter_core: the integer search
    "hevcasm.refine_code",      # _inter_core: refinement and residual
    "hevcasm.chroma",           # both chroma planes' MC and residual
    "hevcasm.chroma_mc",        # one plane's MC from one reference, on the plain path
    "hevcasm.chroma_residual",  # one plane's residual, on the plain path
    "hevcasm.psnr",             # a P frame's three PSNRs, a B frame's luma one
    "hevcasm.gop_closed_yuv",   # encode_gop_closed_loop_yuv: the whole call
    "hevcasm.intra",            # the closed-loop I frame
    "hevcasm.intra_luma",       # encode_intra_frame_wavefront
    "hevcasm.intra_wave",       # one non-empty wave
    "hevcasm.intra_chroma",     # both chroma planes' intra
    "hevcasm.gop_stack",        # the GOP's stacked outputs
    "hevcasm.inter_b_yuv",      # encode_b_frame_yuv: the whole call
    "hevcasm.bi_luma",          # its luma: prepare, both searches, B3, untile
    "hevcasm.bi_chroma",        # both chroma planes' bi MC and residual
    "hevcasm.gop_closed_yuv_b",  # encode_gop_closed_loop_yuv_b: the whole call
    "hevcasm.pu_decision",      # the RD P frame's PU decision (loop._decide_pu)
    "hevcasm.pu_grids",         # its B15 call, or B14's (or the grid scorer's)
    "hevcasm.pu_layout",        # its layout decision's glue
    "hevcasm.pu_refine",        # its B13 call and the prediction's assembly
    "hevcasm.tu_select",        # the RD P frame's TU decision (partition.select_tu_recon)
)

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` (one of SPANS) as a host range while
    a profiler runs; otherwise the shared null context."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
