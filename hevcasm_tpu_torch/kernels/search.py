"""Kernels K1, B7 and B8: exact SSD grids, windows read from one plane
(K1), from each of k planes (B7), or given (B8); and B17: the exhaustive SSD
search with its first minimum taken in the kernel.

``ssd_grid_plane`` replaces the TPU kernel
``hevcasm_tpu/kernels/search_pallas.py`` ``ssd_grid_plane`` (body
``_kernel_slab``), ``ssd_grid_plane_multi`` the TPU kernel
``ssd_grid_plane_multi`` (``_kernel_slab_multi``), ``ssd_grid`` the TPU
kernel ``ssd_grid``, and ``search_mv`` / ``search_mv_dma`` the TPU kernels of
those names (``_kernel_chunked_mv``, ``_search_kernel_dma``), all of the same
file.  K1 and B7 are two C entries of ``csrc/ssd_grid_plane.cu``, B8 is
``csrc/ssd_grid.cu``, and both B17 functions launch the one C entry of
``csrc/search_mv.cu``; their headers say what bounds them on the card.
Beside each stands its plain PyTorch version (``*_ref``), which the CPU
tests use and which the kernel is held against on the card.

Contracts:

* ``ssd_grid_plane(src, plane, grid, num)``: src (n, 64, 64) uint8
  row-major CTUs of a (gr, gc) grid; plane uint8 with at least 64*gr + 2R
  rows and 64*gc + 2R columns, the reference padded by R on the top and
  left, so the window of CTU (r, c) is plane[64r : 64r + 64 + 2R, 64c : 64c
  + 64 + 2R].  Returns (n, 2R+1, 2R+1) int32 exact SSD grids in [dy, dx]
  order, for 1 <= R <= 32 and any grid.
* ``ssd_grid_plane_multi(src, planes, grid, num)``: K1 against each of k
  planes (k, Hp, Wp), each padded and sized as K1's plane (rows contiguous,
  any plane and row stride, so a view of larger padded planes serves);
  returns (n, k, 2R+1, 2R+1) int32 in [dy, dx] order.  The TPU kernel takes
  R = 32 and an even grid width only; the port takes K1's range.
* ``ssd_grid(src, window, num_dy, num_dx)``: src (n, b, b) uint8, window
  (n, >= b + num_dy - 1, >= b + num_dx - 1) uint8 -> (n, num_dy, num_dx)
  int32, ``out[i, dy, dx] = sum (window[i, dy + y, dx + x] - src[i, y,
  x])^2``; any other leading axes (none, or several) are kept, as the
  TPU kernel's 2-D form is.  The kernel takes b in {8, 16, 32, 64} and
  windows up to 256 wide (the TPU kernel's limit is 128).
* ``search_mv(src, windows, num)``: src (n, 64, 64) uint8, windows
  (n, >= 63 + num, >= 63 + num) uint8 gathered at each CTU's search window.
  Returns (mv (n, 2) int32 [dy - R, dx - R], best (n,) int32) of the first
  minimum in row-major [dy, dx] order of the SSD grid, R = num // 2: the
  result of ``encode.motion.full_search``.  The TPU kernel's ``group`` (its
  CTU groups, a grid-step device) has no counterpart.
* ``search_mv_dma(src, ref_padded, positions, r)``: the same, each
  window read at positions + PAD_L from the reference padded by r + 3
  top/left and r + 4 bottom/right (the loop's ``ref_padded``).
  The kernel of both takes 1 <= R <= 32 (the TPU kernels: R = 32); the
  loop runs them at R = 32 only, as EncodeConfig allows.
"""

from __future__ import annotations

import torch

from ..config import Tier
from .. import registry
from ..ops.ssd import ssd_grid as ssd_grid_ref
from ..utils.tensor import (PAD_L, as_tensor, extract_windows, first_min, mv_from_index,
                            stack_offsets)
from . import build

__all__ = ["ssd_grid_plane", "ssd_grid_plane_ref", "ssd_grid_plane_multi",
           "ssd_grid_plane_multi_ref", "ssd_grid", "ssd_grid_ref", "search_mv",
           "search_mv_ref", "search_mv_dma", "search_mv_dma_ref", "grid_launch",
           "MAX_RADIUS", "GRID_BLOCKS", "MAX_WINDOW"]

CTU = 64
MAX_RADIUS = 32
GRID_BLOCKS = (8, 16, 32, 64)         # block sides the B8 kernel takes
MAX_WINDOW = 256                      # the widest window it reads


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
    return ssd_grid_ref(src, win, num, num)


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


def _check_planes(src: torch.Tensor, planes: torch.Tensor,
                  grid: tuple[int, int], num: int) -> int:
    if planes.dim() != 3 or planes.shape[0] < 1:
        raise ValueError(f"planes must be (k, Hp, Wp) with k >= 1, got {tuple(planes.shape)}")
    return _check_geometry(src, planes[0], grid, num)


def ssd_grid_plane_multi_ref(src_ctus, planes, grid: tuple[int, int],
                             num: int) -> torch.Tensor:
    """Plain version: K1's plain version for each plane, stacked on axis 1."""
    src = as_tensor(src_ctus)
    planes = as_tensor(planes, src.device)
    _check_planes(src, planes, grid, num)
    return torch.stack([ssd_grid_plane_ref(src, p, grid, num) for p in planes], dim=1)


def ssd_grid_plane_multi(src_ctus, planes, grid: tuple[int, int],
                         num: int) -> torch.Tensor:
    """Exact SSD grids (n, k, num, num) int32 against k planes.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (and raise if it
    cannot be built or launched)."""
    src = as_tensor(src_ctus)
    planes = as_tensor(planes, src.device)
    if src.device.type == "cpu":
        return ssd_grid_plane_multi_ref(src, planes, grid, num)
    if src.device.type != "cuda" or planes.device != src.device:
        raise ValueError(f"ssd_grid_plane_multi: tensors on {src.device} and "
                         f"{planes.device}; need one CUDA device")
    if src.dtype != torch.uint8 or planes.dtype != torch.uint8:
        raise TypeError("ssd_grid_plane_multi: src_ctus and planes must be uint8")
    if not src.is_contiguous() or planes.stride(2) != 1 or planes.stride(1) >= 2 ** 31:
        raise ValueError("ssd_grid_plane_multi: src_ctus must be contiguous and "
                         "plane rows contiguous")
    r = _check_planes(src, planes, grid, num)
    n, k = src.shape[0], planes.shape[0]
    out = torch.empty((n, k, num, num), dtype=torch.int32, device=src.device)
    lib = build.load()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.hevc_ssd_grid_plane_multi(
        src.data_ptr(), planes.data_ptr(), out.data_ptr(), n, k, grid[1],
        planes.stride(0), planes.stride(1), r, src.device.index or 0, stream)
    build.check(err, "ssd_grid_plane_multi")
    ssd_grid_plane_multi.launches += 1
    return out


def grid_launch(what: str, entry: str, src, window, num_dy: int, num_dx: int) -> torch.Tensor:
    """Check a grid kernel's operands on the card and launch C entry
    ``entry`` (B8 ``hevc_ssd_grid``, B9 ``hevc_sad_grid``, which take the
    same arguments).  Leading axes other than one batch axis are flattened
    around the launch and restored, so (b, b) blocks give (num_dy, num_dx)
    and (a, c, b, b) give (a, c, num_dy, num_dx), as the TPU kernels' do.
    Raises on a geometry the kernels do not take."""
    dev = build.on_card(what, src, window)
    if src.dim() != 3 and src.dim() >= 2 and window.dim() == src.dim():
        *lead, h, w = src.shape
        out = grid_launch(what, entry, src.reshape(-1, h, w),
                          window.reshape(-1, *window.shape[-2:]), num_dy, num_dx)
        return out.reshape(*lead, num_dy, num_dx)
    if src.dtype != torch.uint8 or window.dtype != torch.uint8:
        raise TypeError(f"{what}: src and window must be uint8")
    if src.dim() != 3 or src.shape[1] != src.shape[2] or src.shape[1] not in GRID_BLOCKS:
        raise ValueError(f"{what}: src must be (n, b, b) with b in {GRID_BLOCKS}, "
                         f"got {tuple(src.shape)}")
    n, b = src.shape[0], src.shape[1]
    wh, ww = b + num_dy - 1, b + num_dx - 1
    if num_dy < 1 or num_dx < 1 or max(wh, ww) > MAX_WINDOW:
        raise ValueError(f"{what}: num_dy={num_dy}, num_dx={num_dx} at b={b} need "
                         f"windows of 1 to {MAX_WINDOW} rows and columns")
    if window.dim() != 3 or window.shape[0] != n or window.shape[1] < wh \
            or window.shape[2] < ww:
        raise ValueError(f"{what}: window must be ({n}, >= {wh}, >= {ww}), "
                         f"got {tuple(window.shape)}")
    if not src.is_contiguous() or window.stride(2) != 1 or window.stride(0) >= 2 ** 31:
        raise ValueError(f"{what}: src must be contiguous and window rows contiguous")
    out = torch.empty((n, num_dy, num_dx), dtype=torch.int32, device=dev)
    err = getattr(build.load(), entry)(
        src.data_ptr(), window.data_ptr(), window.stride(0), window.stride(1),
        window.shape[1], window.shape[2], out.data_ptr(),
        n, b, num_dy, num_dx, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    return out


def ssd_grid(src, window, num_dy: int, num_dx: int) -> torch.Tensor:
    """Exact SSD grids (n, num_dy, num_dx) int32 of blocks against their
    windows.  CPU tensors run the plain version (ops.ssd.ssd_grid); CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched, or the geometry is one it does not take)."""
    src = as_tensor(src)
    window = as_tensor(window, src.device)
    if src.device.type == "cpu":
        return ssd_grid_ref(src, window, num_dy, num_dx)
    out = grid_launch("ssd_grid", "hevc_ssd_grid", src, window, num_dy, num_dx)
    ssd_grid.launches += 1
    return out


def search_mv_ref(src, windows, num: int):
    """Plain version: the SSD grid (ops.ssd.ssd_grid) and its first minimum
    in row-major [dy, dx] order."""
    src = as_tensor(src)
    scores = ssd_grid_ref(src, as_tensor(windows, src.device), num, num)
    idx, best = first_min(scores.reshape(scores.shape[0], -1))
    return mv_from_index(idx, num, num // 2), best


def search_mv_dma_ref(src_ctus, ref_padded, positions, r: int):
    """Plain version: the windows gathered at positions + PAD_L, then
    search_mv_ref."""
    src = as_tensor(src_ctus)
    windows = extract_windows(as_tensor(ref_padded, src.device),
                              as_tensor(positions, src.device) + PAD_L, CTU + 2 * r)
    return search_mv_ref(src, windows, 2 * r + 1)


def _search_launch(what: str, src, plane, offsets, shift: int, r: int):
    """Launch B17, one kernel and nothing else, on CTU i's window at
    offsets[i] + shift in the plane."""
    dev = build.on_card(what, src, plane, offsets)
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8:
        raise TypeError(f"{what}: the CTUs and windows must be uint8")
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"{what}: src must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"{what}: R={r}; the kernel takes 1 <= R <= {MAX_RADIUS}")
    if not (src.is_contiguous() and plane.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f"{what}: src, the windows and the offsets must be contiguous")
    if plane.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {plane.shape[0]} window rows pass 2^31")
    n = src.shape[0]
    mv = torch.empty((n, 2), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.int32, device=dev)
    err = build.load().hevc_search_mv(
        src.data_ptr(), plane.data_ptr(), offsets.data_ptr(), shift, mv.data_ptr(),
        best.data_ptr(), n, plane.shape[0], plane.shape[1], r, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    return mv, best


def search_mv(src, windows, num: int):
    """(mv, best) of the exhaustive SSD search on gathered windows.  CPU
    tensors run the plain version; CUDA tensors launch B17 with the
    contiguous window stack viewed as a plane of n * Wh rows (and raise if
    it cannot be built or launched, or the geometry is one it does not
    take)."""
    src = as_tensor(src)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return search_mv_ref(src, windows, num)
    if num % 2 == 0:
        raise ValueError(f"search_mv: num={num}; the kernel takes num = 2R+1")
    r = num // 2
    if windows.dim() != 3 or windows.shape[0] != src.shape[0] \
            or min(windows.shape[1:]) < CTU + 2 * r:
        raise ValueError(f"search_mv: windows must be ({src.shape[0]}, >= {CTU + 2 * r}, "
                         f">= {CTU + 2 * r}), got {tuple(windows.shape)}")
    if not windows.is_contiguous():
        raise ValueError("search_mv: the windows must be contiguous")
    n, wh, ww = windows.shape
    out = _search_launch("search_mv", src, windows.view(n * wh, ww),
                         stack_offsets(n, wh, src.device), 0, r)
    search_mv.launches += 1
    return out


def search_mv_dma(src_ctus, ref_padded, positions, r: int):
    """(mv, best) of the exhaustive SSD search with each CTU's window read
    from ref_padded at positions + PAD_L.  CPU tensors run the plain
    version; CUDA tensors launch B17 (and raise if it cannot be built or
    launched, or the geometry is one it does not take)."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_padded, src.device)
    positions = as_tensor(positions, src.device)
    if src.device.type == "cpu":
        return search_mv_dma_ref(src, plane, positions, r)
    if plane.dim() != 2 or positions.shape != (src.shape[0], 2) \
            or positions.dtype != torch.int32:
        raise ValueError(f"search_mv_dma: ref_padded must be 2-D and positions "
                         f"({src.shape[0]}, 2) int32")
    if min(plane.shape) < CTU + 2 * r:
        raise ValueError(f"search_mv_dma: ref_padded {tuple(plane.shape)} is smaller "
                         f"than one {CTU + 2 * r}-pixel window")
    out = _search_launch("search_mv_dma", src, plane, positions.contiguous(), PAD_L, r)
    search_mv_dma.launches += 1
    return out


ssd_grid_plane.launches = 0
ssd_grid_plane_multi.launches = 0
ssd_grid.launches = 0
search_mv.launches = 0
search_mv_dma.launches = 0

registry.register("ssd_grid_plane", Tier.REF, ssd_grid_plane_ref)
registry.register("ssd_grid_plane", Tier.KERNEL, ssd_grid_plane)
registry.register("ssd_grid_plane_multi", Tier.REF, ssd_grid_plane_multi_ref)
registry.register("ssd_grid_plane_multi", Tier.KERNEL, ssd_grid_plane_multi)
registry.register("ssd_grid", Tier.KERNEL, ssd_grid)
registry.register("search_mv", Tier.REF, search_mv_ref)
registry.register("search_mv", Tier.KERNEL, search_mv)
registry.register("search_mv_dma", Tier.REF, search_mv_dma_ref)
registry.register("search_mv_dma", Tier.KERNEL, search_mv_dma)
