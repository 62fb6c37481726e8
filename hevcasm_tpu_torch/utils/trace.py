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
thread: ``hevcasm.inter_yuv`` for a 4:2:0 P frame, ``hevcasm.gop_closed_yuv``
for a closed-loop 4:2:0 GOP.  A span's parent is the innermost span that
contains it.
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
    "hevcasm.chroma_mc",        # one plane's MC, on the plain path
    "hevcasm.chroma_residual",  # one plane's residual, on the plain path
    "hevcasm.psnr",             # the three PSNRs of a P frame
    "hevcasm.gop_closed_yuv",   # encode_gop_closed_loop_yuv: the whole call
    "hevcasm.intra",            # the closed-loop I frame
    "hevcasm.intra_luma",       # encode_intra_frame_wavefront
    "hevcasm.intra_wave",       # one non-empty wave
    "hevcasm.intra_chroma",     # both chroma planes' intra
    "hevcasm.gop_stack",        # the GOP's stacked outputs
)

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` (one of SPANS) as a host range while
    a profiler runs; otherwise the shared null context."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
