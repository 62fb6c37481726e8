"""Input conversion and selection helpers shared by the public functions."""

from __future__ import annotations

import functools

import numpy as np
import torch


def as_tensor(x, device: torch.device | None = None) -> torch.Tensor:
    """A tensor for ``x``: tensors pass through (moved to ``device`` when one
    is given), numpy arrays and Python numbers become CPU tensors of the
    same dtype (or ``device`` tensors).  A read-only array is copied, since
    a tensor does not carry that flag."""
    if isinstance(x, torch.Tensor):
        return x if device is None or x.device == device else x.to(device)
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def entry_device(x, device=None) -> torch.device:
    """The device an entry point runs on for its first input ``x``: a
    tensor's own (the caller chose it); for anything else ``device``, by
    default the CUDA card.  Raises RuntimeError when that is a CUDA device
    and there is none: the CPU runs only when the caller asks for it."""
    if isinstance(x, torch.Tensor):
        return x.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to encode on the CPU")
    return dev


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of ``a`` (a numpy array, or nested sequences of numbers) as
    ``dtype`` on ``device``.  To a CUDA card it goes from pinned memory
    without blocking: no host synchronisation, so a loop that must not read
    the card from the host may build it."""
    t = torch.tensor(np.asarray(a), dtype=dtype)       # a copy, never a view of a
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return to_device(values, dtype, device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A read-only tensor of constant ``values`` (nested sequences of
    numbers) on ``device``, made once per (values, dtype, device) and
    shared: callers must not write to it.  Its copy to a CUDA card does
    not synchronise the host with the card."""
    return _constant(_frozen(values), dtype, torch.device(device))


def _frozen(values):
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return tuple(_frozen(v) for v in values) if isinstance(values, (list, tuple)) else values


TAPS = 8               # the luma interpolation filter's taps
PAD_L = TAPS // 2 - 1  # 3: the rows/columns it reads before a block
PAD_R = TAPS // 2      # 4: and after it


def extract_windows(plane: torch.Tensor, positions: torch.Tensor,
                    size: int | tuple[int, int]) -> torch.Tensor:
    """Gather a (sy, sx) window at each top-left position of a 2-D plane.

    Returns (n, sy, sx).  A start that would reach past the plane is
    clamped so the window fits, as ``jax.lax.dynamic_slice`` does."""
    sy, sx = (size, size) if isinstance(size, int) else size
    plane = as_tensor(plane)
    positions = as_tensor(positions, plane.device).long()
    hp, wp = plane.shape
    y0 = positions[:, 0].clamp(0, hp - sy)
    x0 = positions[:, 1].clamp(0, wp - sx)
    rows = y0[:, None] + torch.arange(sy, device=plane.device)
    cols = x0[:, None] + torch.arange(sx, device=plane.device)
    return plane[rows[:, :, None], cols[:, None, :]]


def mv_from_index(index: torch.Tensor, num: int, r: int) -> torch.Tensor:
    """(..., 2) int32 [dy, dx] in [-r, r] of a row-major index into a
    (num, num) search grid."""
    return torch.stack([index // num - r, index % num - r], dim=-1).to(torch.int32)


def first_min(costs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, value) of the first minimum along the last axis: the minimum
    value, then the smallest index among the entries equal to it.  The
    tie-break is written out rather than left to a library argmin.  Returns
    int32 indices and the values in costs' dtype."""
    best = costs.amin(dim=-1, keepdim=True)
    idx = torch.arange(costs.shape[-1], device=costs.device, dtype=torch.int32)
    big = torch.iinfo(torch.int32).max
    first = torch.where(costs == best, idx, big).amin(dim=-1)
    return first, best[..., 0]


@functools.lru_cache(maxsize=8)
def stack_offsets(n: int, wh: int, device: torch.device) -> torch.Tensor:
    """(n, 2) int32 [i * wh, 0]: window i's top-left in a contiguous stack
    of n windows of wh rows viewed as one plane of n * wh rows, which is how
    the kernels that read windows from a plane take gathered windows.
    Cached, so a frame's call launches nothing but its kernel."""
    rows = torch.arange(n, dtype=torch.int32, device=device) * wh
    return torch.stack([rows, torch.zeros_like(rows)], dim=-1)
