"""Kernel B9: the exact SAD grid of square blocks against given windows.

``sad_grid`` replaces the TPU kernel ``hevcasm_tpu/kernels/sad_pallas.py``
``sad_grid`` (body ``_sad_grid_kernel``).  Its CUDA source is
``csrc/sad_grid.cu``, B8's grid core (``csrc/grid_core.cuh``) with the
absolute difference for the square; the header says what bounds it on the
card.  Beside it stands its plain PyTorch version, ``sad_grid_ref``
(``ops.sad.sad_grid``).

Contract: ``sad_grid(src, window, num_dy, num_dx)``: src (n, b, b) uint8,
window (n, >= b + num_dy - 1, >= b + num_dx - 1) uint8 -> (n, num_dy,
num_dx) int32, ``out[i, dy, dx] = sum |window[i, dy + y, dx + x] - src[i,
y, x]|``.  The kernel takes B8's geometry: b in {8, 16, 32, 64} and windows
up to 256 wide.  It is the KERNEL tier of the registry's ``sad_grid``, which
``encode.motion.grid_metric_fn("sad")`` returns.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.sad import sad_grid as sad_grid_ref
from ..utils.tensor import as_tensor
from .search import grid_launch

__all__ = ["sad_grid", "sad_grid_ref"]


def sad_grid(src, window, num_dy: int, num_dx: int) -> torch.Tensor:
    """Exact SAD grids (n, num_dy, num_dx) int32 of blocks against their
    windows.  CPU tensors run the plain version (ops.sad.sad_grid); CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched, or the geometry is one it does not take)."""
    src = as_tensor(src)
    window = as_tensor(window, src.device)
    if src.device.type == "cpu":
        return sad_grid_ref(src, window, num_dy, num_dx)
    out = grid_launch("sad_grid", "hevc_sad_grid", src, window, num_dy, num_dx)
    sad_grid.launches += 1
    return out


sad_grid.launches = 0

registry.register("sad_grid", Tier.REF, sad_grid_ref)
registry.register("sad_grid", Tier.KERNEL, sad_grid)
