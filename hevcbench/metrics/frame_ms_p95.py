"""frame_ms_p95: the 95th percentile, over every frame of the window, of
the time from the call for a frame to its outputs on the host (ms)."""

import statistics


def read(rec):
    lat = rec.span_s("frame")
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
