"""The program's own spans in the traced sub-window, as the span metrics in
metrics/ read them.

Inside a profiler session the program records a host range for each of its
layers (names starting "hevcasm."), among the host records of
``profiling.Trace.host`` and on the clock of the card's records.  The spans
of one call lie inside its entry span: one "hevcasm.inter_yuv" a P frame, one
"hevcasm.gop_closed_yuv" a GOP.  A span's parent is the innermost span that
contains it.  A program that records no spans leaves the readers nothing:
each returns None.  Times are in microseconds, as in the trace."""

from __future__ import annotations

import bisect
import sys
from itertools import accumulate

PREFIX = "hevcasm."
P_FRAME = "hevcasm.inter_yuv"
GOP = "hevcasm.gop_closed_yuv"
LUMA = "hevcasm.luma"
CHROMA = "hevcasm.chroma"
INTRA = "hevcasm.intra"
#: Every span name a reader looks for (the prefix aside).
READ = (P_FRAME, GOP, LUMA, CHROMA, INTRA)
#: Host records of a kernel launch: the CUDA runtime's cudaLaunch* calls and
#: the lower-level cuLaunch* ones.
LAUNCH = ("cudaLaunch", "cuLaunch")


class Spans:
    """The program's spans of one trace, sorted by start (a parent before a
    child that starts with it): ``at(t)`` finds the innermost one open at
    time t by interval containment."""

    def __init__(self, trace):
        self.spans = sorted(((s, s + d, name) for name, s, d in trace.host
                             if name.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.reach = list(accumulate((e for _, e, _ in self.spans), max))

    def at(self, t: float, before: int | None = None) -> int | None:
        """Index of the latest-started span containing t (the innermost,
        spans of one thread being nested), among the first ``before``."""
        i = bisect.bisect_right(self.starts, t) if before is None else before
        for j in range(i - 1, -1, -1):
            if self.reach[j] < t:
                return None
            if self.spans[j][1] >= t:
                return j
        return None

    def named(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for s, e, n in self.spans if n == name]

    def parents(self) -> list[int | None]:
        """Each span's parent: the innermost other span containing it."""
        out = []
        for j, (s, e, _) in enumerate(self.spans):
            k = self.at(s, before=j)
            while k is not None and self.spans[k][1] < e:    # not a container of j
                k = self.at(s, before=k)
            out.append(k)
        return out

    def self_us(self, parents: list) -> dict[str, float]:
        """Each name's self time over the trace: its spans' durations less
        what their children cover."""
        out: dict[str, float] = {}
        for (s, e, name), k in zip(self.spans, parents):
            out[name] = out.get(name, 0.0) + (e - s)
            if k is not None:
                out[self.spans[k][2]] -= e - s
        return out


def group(outer: list, inner: list) -> list[list]:
    """For each interval of ``outer`` (sorted, disjoint), the intervals of
    ``inner`` it contains."""
    starts = [s for s, _ in outer]
    out: list[list] = [[] for _ in outer]
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out[i].append((s, e))
    return out


def entries(rec, spans: Spans, entry: str) -> list[tuple[float, float]]:
    """The entry spans of the traced steps; a line on standard error when
    the frames they coded (a P frame each; a GOP its I frame and the P
    frames inside it) are not the trace's."""
    found = spans.named(entry)
    if not found:
        return found
    coded = len(found)
    if entry == GOP:
        coded += sum(len(g) for g in group(found, spans.named(P_FRAME)))
    if coded != rec.trace.frames:
        print(f"{entry}: {len(found)} entry spans coded {coded} frames; the trace "
              f"coded {rec.trace.frames}", file=sys.stderr)
    return found


def host_ms(rec, entry: str, child: str) -> float | None:
    """Host ms inside ``child`` spans, an entry span on average; None where
    the trace holds none of either."""
    if rec.trace is None:
        return None
    spans = Spans(rec.trace)
    outer = entries(rec, spans, entry)
    inner = spans.named(child)
    if not outer or not inner:
        return None
    per = [sum(e - s for s, e in g) for g in group(outer, inner)]
    return sum(per) / len(per) * 1e-3


def count_in(points: list[float], intervals: list) -> int:
    return sum(bisect.bisect_right(points, e) - bisect.bisect_left(points, s)
               for s, e in intervals)


def launches(rec, entry: str, child: str) -> float | None:
    """Launch records that start inside ``child`` spans, an entry span on
    average, beside (standard error) those inside the entry spans and in
    the whole sub-window; None where the trace holds no launch record (the
    CPU) or none of the spans."""
    if rec.trace is None:
        return None
    points = sorted(s for name, s, _ in rec.trace.host if name.startswith(LAUNCH))
    spans = Spans(rec.trace)
    outer = entries(rec, spans, entry)
    inner = spans.named(child)
    if not points or not outer or not inner:
        return None
    n = len(outer)
    print(f"{child}: launch records a {entry} span: {count_in(points, inner) / n} inside "
          f"{child}, {count_in(points, outer) / n} inside {entry}, {len(points) / n} in the "
          f"traced sub-window ({rec.trace.frames} frames)", file=sys.stderr)
    return count_in(points, inner) / n
