"""device_idle_share: 1 - (the union of the card's kernel, copy and memset
records) / the traced sub-window, from the profiler's device records."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 1.0 - rec.trace.busy_s() / rec.trace.window_s
