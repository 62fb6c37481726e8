"""idle_in_program_share: of the card's idle time in the traced sub-window
(profiling.Trace.idle_gaps), the share whose gap begins while one of the
program's spans is open; the rest is idle while the caller runs (the
harness's reads of the outputs, Python between calls).

Standard error gives the idle seconds by the innermost span open as each
gap begins ("outside": none), the host self time of each span (its time
less its children's) an entry span on average, and the count of device
records that carry a span's name (a span mirrored on the card; 0 is
right)."""

import sys

from hevcbench import spans


def read(rec):
    if rec.trace is None:
        return None
    found = spans.Spans(rec.trace)
    if not found.spans:
        return None
    idle: dict[str, float] = {}
    for s, e in rec.trace.idle_gaps():
        j = found.at(s)
        name = "outside" if j is None else found.spans[j][2]
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    total = sum(idle.values())
    parents = found.parents()
    roots = parents.count(None)
    self_ms = {k: v * 1e-3 / roots for k, v in found.self_us(parents).items()}
    mirrored = sum(name.startswith(spans.PREFIX) for name, _, _ in rec.trace.device)
    print("idle s by program span: " + ", ".join(
        f"{k} {v}" for k, v in sorted(idle.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    print(f"host self ms by program span, an entry span ({roots}): " + ", ".join(
        f"{k} {v}" for k, v in sorted(self_ms.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    print(f"device records named {spans.PREFIX}*: {mirrored}", file=sys.stderr)
    if total <= 0:
        return None
    return 1.0 - idle.get("outside", 0.0) / total
