"""The spans of the closed-loop IBPBP GOP (encode_gop_closed_loop_yuv_b), as
the B-frame metrics in metrics/ read them, beside ``spans``' readers of the
P frame and the IPPP GOP.

One "hevcasm.gop_closed_yuv_b" span a GOP holds its I frame's
"hevcasm.intra", each P frame's "hevcasm.inter_yuv" and each B frame's
"hevcasm.inter_b_yuv" (over "hevcasm.bi_luma", "hevcasm.bi_chroma" and
"hevcasm.psnr").  Each reader's number is a GOP on average over the GOP
spans of the traced sub-window, and standard error gets a line where the
frames those GOPs coded (the I frame, the P and B frames inside each) are
not the trace's.  A program that records none of these spans leaves the
readers nothing: each returns None.  Times are in microseconds, as in the
trace."""

from __future__ import annotations

import sys

from . import spans

GOP_B = "hevcasm.gop_closed_yuv_b"
B_FRAME = "hevcasm.inter_b_yuv"
BI_CHROMA = "hevcasm.bi_chroma"
#: Every span name a reader here looks for.
READ = (GOP_B, B_FRAME, BI_CHROMA, spans.P_FRAME, spans.INTRA)


def _gops(rec, child: str):
    """(GOP spans, ``child`` spans) of the traced steps, or None where the
    trace holds none of either."""
    if rec.trace is None:
        return None
    found = spans.Spans(rec.trace)
    outer, inner = found.named(GOP_B), found.named(child)
    if not outer or not inner:
        return None
    coded = len(outer) + sum(len(g) for name in (spans.P_FRAME, B_FRAME)
                             for g in spans.group(outer, found.named(name)))
    if coded != rec.trace.frames:
        print(f"{GOP_B}: {len(outer)} entry spans coded {coded} frames; the trace coded "
              f"{rec.trace.frames}", file=sys.stderr)
    return outer, inner


def host_ms(rec, child: str) -> float | None:
    """Host ms inside ``child`` spans, a GOP on average."""
    got = _gops(rec, child)
    if got is None:
        return None
    per = [sum(e - s for s, e in g) for g in spans.group(*got)]
    return sum(per) / len(per) * 1e-3


def launches(rec, child: str) -> float | None:
    """Launch records that start inside ``child`` spans, a GOP on average,
    beside (standard error) those inside the GOP spans and in the whole
    sub-window; None where the trace holds no launch record (the CPU)."""
    if rec.trace is None:
        return None
    points = sorted(s for name, s, _ in rec.trace.host if name.startswith(spans.LAUNCH))
    got = _gops(rec, child) if points else None
    if got is None:
        return None
    outer, inner = got
    n = len(outer)
    print(f"{child}: launch records a {GOP_B} span: {spans.count_in(points, inner) / n} "
          f"inside {child}, {spans.count_in(points, outer) / n} inside {GOP_B}, "
          f"{len(points) / n} in the traced sub-window ({rec.trace.frames} frames)",
          file=sys.stderr)
    return spans.count_in(points, inner) / n
