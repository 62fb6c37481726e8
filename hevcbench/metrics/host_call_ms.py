"""host_call_ms.<cells>: the host's time in the entry point's call, until it
returns with the work enqueued, a call on average over the window (ms):
the benchmark's own span around the call."""


def read(rec):
    calls = rec.span_s("call")
    return sum(calls) / len(calls) * 1e3 if calls else None
