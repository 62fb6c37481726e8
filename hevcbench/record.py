"""What one run recorded, as the metric readers in metrics/ take it."""

from __future__ import annotations

import importlib
import sys
from dataclasses import dataclass, field

from . import roofline
from .profiling import Trace


@dataclass
class Record:
    geometry: dict          # the configuration's coded frame and search
    setup_s: float          # process start to the first timed call
    window_s: float         # the measured window on the host clock
    ctus: int               # CTUs coded in the window
    frames: int             # frames coded in the window
    spans: list = field(default_factory=list)   # (name, start_s, end_s), host clock
    trace: Trace | None = None                   # the traced sub-window (--trace 1)

    def span_s(self, name: str) -> list[float]:
        return [e - s for n, s, e in self.spans if n == name]


def kernel_roofline(rec: Record, kernel: str) -> float | None:
    """A kernel's share (%) of its roofline: the least time of one call at
    this geometry (roofline/<kernel>.py) over the mean device time of its
    records in the trace.  None where the trace holds none.  The records
    are counted against the program's launch counter over the same steps,
    and a shortfall is reported on standard error."""
    if rec.trace is None:
        return None
    mod = importlib.import_module(f"hevcbench.roofline.{kernel}")
    times = [d for name, _, d in rec.trace.kernels() if mod.KERNEL in name]
    launched = rec.trace.launches.get(kernel)
    print(f"{kernel}: {len(times)} device records, {launched} launches counted "
          f"(shortfall {None if launched is None else launched - len(times)})",
          file=sys.stderr)
    if not times:
        return None
    mean_s = sum(times) / len(times) * 1e-6
    return 100.0 * roofline.bound_s(*mod.cost(rec.geometry)) / mean_s
