"""Timing helpers of the self-test, the counterpart of
``hevcasm_tpu.utils.timing`` (the reference harness's cycle counting and
converging averager, hevcasm_test.c:40-107).

A call's time is taken after warm-up calls.  When any argument is a CUDA
tensor the calls are bracketed by CUDA events on the current stream and
the end event is waited for, so the time is the device's; otherwise the
host clock (``time.perf_counter``) times them.  PyTorch returns before the
card finishes, so the host clock alone would time the enqueue.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_fn", "time_fn_converged", "gbps", "gops"]


def _card(args) -> torch.device | None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return None


def _sample(fn: Callable, args, inner: int, dev: torch.device | None) -> float:
    """Seconds per call of ``inner`` back-to-back calls of fn(*args)."""
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        return (time.perf_counter() - t0) / inner
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(inner):
        fn(*args)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / inner


def _warm(fn: Callable, args, warmup: int, dev: torch.device | None) -> None:
    for _ in range(warmup):
        fn(*args)
    if dev is not None:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, inner: int = 1, warmup: int = 2) -> float:
    """Best-of-``iters`` time of ``fn(*args)`` in seconds; ``inner`` > 1
    times that many calls back to back and divides (the role of
    hevcasm_test.c's batching at :53-55)."""
    dev = _card(args)
    _warm(fn, args, warmup, dev)
    return min(_sample(fn, args, inner, dev) for _ in range(iters))


def time_fn_converged(fn: Callable, *args, inner: int = 4, window: float = 0.125,
                      min_samples: int = 8, max_samples: int = 200,
                      warmup: int = 2) -> float:
    """The reference harness's converging averager (hevcasm_test.c:40-107):
    keep sampling ``inner``-call batches, restart the accumulation whenever
    a sample beats the running minimum by more than ``window``, and return
    the mean of the samples inside the stability window once
    ``min_samples`` agree (or after ``max_samples``)."""
    dev = _card(args)
    _warm(fn, args, warmup, dev)
    lo = float("inf")
    acc, cnt, total = 0.0, 0, 0
    while total < max_samples:
        dt = _sample(fn, args, inner, dev)
        total += 1
        if dt < lo * (1 - window):
            lo, acc, cnt = dt, dt, 1          # a faster regime: restart
            continue
        lo = min(lo, dt)
        if dt <= lo * (1 + window):
            acc += dt
            cnt += 1
            if cnt >= min_samples:
                break
    return acc / max(cnt, 1)


def gbps(num_bytes: int, seconds: float) -> float:
    return num_bytes / seconds / 1e9


def gops(num_ops: int, seconds: float) -> float:
    return num_ops / seconds / 1e9
