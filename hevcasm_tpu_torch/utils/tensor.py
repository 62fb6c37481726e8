"""Input conversion and selection helpers shared by the public functions."""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, device: torch.device | None = None) -> torch.Tensor:
    """A tensor for ``x``: tensors pass through (moved to ``device`` when one
    is given), numpy arrays and Python numbers become CPU tensors of the
    same dtype (or ``device`` tensors).  A read-only array is copied, since
    a tensor does not carry that flag."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
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
