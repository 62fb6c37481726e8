"""The traced sub-window: torch.profiler over a fixed number of steps, read
into plain lists that the per-layer metrics take apart.

Device time comes from the card's own records (kernels, copies, memsets),
never from the torch ops that launched them.  The sub-window is the span of
the benchmark's annotation "hevcbench.window" on the profiler's clock,
which is the device records' clock too."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "hevcbench.window"


@dataclass
class Trace:
    """Records of one profiled sub-window, times in microseconds on the
    profiler's clock."""

    start: float
    end: float
    device: list = field(default_factory=list)      # (name, start, duration)
    host: list = field(default_factory=list)        # (name, start, duration)
    frames: int = 0
    launches: dict = field(default_factory=dict)    # counter deltas by kernel

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self):
        return [d for d in self.device if not _is_copy(d[0])]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device records' intervals inside the window."""
        spans = sorted((max(s, self.start), min(s + d, self.end)) for _, s, d in self.device
                       if s < self.end and s + d > self.start)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, t = [], self.start
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def breakdown(self) -> dict:
        """The device operations with the most time, and idle time by what
        the host was doing when each gap began, both in seconds."""
        by_op: dict[str, float] = {}
        for name, _, d in self.device:
            by_op[name] = by_op.get(name, 0.0) + d * 1e-6
        gaps = self.idle_gaps()
        names = host_ops_at(self.host, [s + 0.5 * min(e - s, 1.0) for s, e in gaps])
        by_host: dict[str, float] = {}
        for name, (s, e) in zip(names, gaps):
            by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:200], v] for k, v in top],
                "idle_gaps": [[k[:200], v] for k, v in gaps]}


def host_ops_at(host: list, times: list) -> list[str]:
    """For each of ``times`` (ascending), the innermost host record running
    then: the latest-started one that has not ended, however many records
    began and ended inside it; "python" where none runs (the interpreter
    between torch calls).  One sweep in order of start, with the records
    begun so far on a stack; a record found ended is dropped for good,
    since the times only grow."""
    records = sorted(host, key=lambda h: h[1])
    out, running, i = [], [], 0
    for t in times:
        while i < len(records) and records[i][1] <= t:
            running.append(records[i])
            i += 1
        while running and running[-1][1] + running[-1][2] < t:
            running.pop()
        out.append(running[-1][0] if running else "python")
    return out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _us(event, what: str) -> float:
    ns = getattr(event, f"{what}_ns", None)
    return ns() * 1e-3 if ns is not None else getattr(event, f"{what}_us")()


def profile(run_steps, cuda: bool = True) -> Trace:
    """Run ``run_steps()`` under torch.profiler (host and card) inside the
    window annotation, and read the records.  ``cuda`` False traces the
    host alone (the CPU tests)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run_steps()
            if cuda:
                torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        rec = (name, _us(e, "start"), _us(e, "duration"))
        if name == WINDOW:
            if e.device_type() != on_card:
                window = rec
        elif e.device_type() == on_card:
            device.append(rec)
        else:
            host.append(rec)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW!r} annotation")
    return Trace(window[1], window[1] + window[2], device, host)
