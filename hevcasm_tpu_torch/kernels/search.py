"""Kernel K1: the exact SSD grid of every CTU, windows read from the plane.

``ssd_grid_plane`` replaces the TPU kernel
``hevcasm_tpu/kernels/search_pallas.py`` ``ssd_grid_plane`` (body
``_kernel_slab``).  The CUDA source is ``csrc/ssd_grid_plane.cu``; its
header says what bounds it on the card.  Beside it stands the plain
PyTorch version, ``ssd_grid_plane_ref``, which the CPU tests use and which
the kernel is held against on the card.

Contract: src (n, 64, 64) uint8 row-major CTUs of a (gr, gc) grid; plane
uint8 with at least 64*gr + 2R rows and 64*gc + 2R columns, the reference
padded by R on the top and left, so the window of CTU (r, c) is
plane[64r : 64r + 64 + 2R, 64c : 64c + 64 + 2R].  Returns (n, 2R+1, 2R+1)
int32 exact SSD grids in [dy, dx] order, for 1 <= R <= 32 and any grid.
"""

from __future__ import annotations

import torch

from ..config import Tier
from .. import registry
from ..ops.ssd import ssd_grid
from ..utils.tensor import as_tensor
from . import build

__all__ = ["ssd_grid_plane", "ssd_grid_plane_ref", "MAX_RADIUS"]

CTU = 64
MAX_RADIUS = 32


def _check_geometry(src: torch.Tensor, plane: torch.Tensor,
                    grid: tuple[int, int], num: int) -> int:
    n = src.shape[0]
    gr, gc = grid
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"src_ctus must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    if n != gr * gc:
        raise ValueError(f"{n} CTUs do not fill a {gr}x{gc} grid")
    if num % 2 == 0 or not 1 <= num // 2 <= MAX_RADIUS:
        raise ValueError(f"num={num}: need num = 2R+1 with 1 <= R <= {MAX_RADIUS}")
    r = num // 2
    if plane.dim() != 2 or plane.shape[0] < CTU * gr + 2 * r \
            or plane.shape[1] < CTU * gc + 2 * r:
        raise ValueError(f"plane {tuple(plane.shape)} is smaller than the "
                         f"({CTU * gr + 2 * r}, {CTU * gc + 2 * r}) the grid needs")
    return r


def ssd_grid_plane_ref(src_ctus, plane, grid: tuple[int, int],
                       num: int) -> torch.Tensor:
    """Plain version: gather every CTU's window from the plane and score
    it by ops.ssd.ssd_grid (one dy row at a time, chunked over CTUs, so
    the temporary stays bounded at 1080p)."""
    src = as_tensor(src_ctus)
    plane = as_tensor(plane, src.device)
    r = _check_geometry(src, plane, grid, num)
    gr, gc = grid
    size = CTU + 2 * r
    win = plane[: (gr - 1) * CTU + size, : (gc - 1) * CTU + size]
    win = win.unfold(0, size, CTU).unfold(1, size, CTU).reshape(gr * gc, size, size)
    return ssd_grid(src, win, num, num)


def ssd_grid_plane(src_ctus, plane, grid: tuple[int, int],
                   num: int) -> torch.Tensor:
    """Exact SSD grids (n, num, num) int32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot be
    built or launched)."""
    src = as_tensor(src_ctus)
    plane = as_tensor(plane, src.device)
    if src.device.type == "cpu":
        return ssd_grid_plane_ref(src, plane, grid, num)
    if src.device.type != "cuda" or plane.device != src.device:
        raise ValueError(f"ssd_grid_plane: tensors on {src.device} and "
                         f"{plane.device}; need one CUDA device")
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8:
        raise TypeError("ssd_grid_plane: src_ctus and plane must be uint8")
    if not (src.is_contiguous() and plane.is_contiguous()):
        raise ValueError("ssd_grid_plane: src_ctus and plane must be contiguous")
    r = _check_geometry(src, plane, grid, num)
    n = src.shape[0]
    out = torch.empty((n, num, num), dtype=torch.int32, device=src.device)
    lib = build.load()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.hevc_ssd_grid_plane(
        src.data_ptr(), plane.data_ptr(), out.data_ptr(), n, grid[1],
        plane.shape[0], plane.shape[1], r, src.device.index or 0, stream)
    build.check(err, "ssd_grid_plane")
    ssd_grid_plane.launches += 1
    return out


ssd_grid_plane.launches = 0

registry.register("ssd_grid_plane", Tier.REF, ssd_grid_plane_ref)
registry.register("ssd_grid_plane", Tier.KERNEL, ssd_grid_plane)
