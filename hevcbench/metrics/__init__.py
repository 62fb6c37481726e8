"""One reader a metric, found by the metric's name: ``metrics/<name>.py``,
else ``metrics/<name up to its first dot>.py`` (one reader for a quantity
split by cells, such as host_call_ms.live and host_call_ms.gop).  Each has
``read(record) -> float | None``; None (nothing to read) leaves the metric
out of the run's line."""
