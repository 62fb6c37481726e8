"""ctus_per_s: every CTU coded in the window over the window (CTU/s).  The
window closes at the end of the last call that began inside --seconds."""


def read(rec):
    return rec.ctus / rec.window_s if rec.window_s > 0 else None
