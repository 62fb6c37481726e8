"""Kernels B12 and B13: the quarter-pel cost maps of small blocks.

``refine_qpel_costmap`` replaces the TPU kernel
``hevcasm_tpu/kernels/interp_pallas.py`` ``refine_qpel_costmap`` (bodies
``_costmap_kernel_stacked`` and ``_costmap_kernel``), and
``refine_qpel_costmap_dma`` the TPU kernel ``refine_qpel_costmap_dma``
(``_costmap_kernel_dma``).  Both are C entries over one device core in
``csrc/costmap.cu``; its header says what bounds it on the card.  Beside
each stands its plain PyTorch version (``*_ref``), which gathers the
windows and calls ``ops.pred_inter.qpel_costmap``.

Contracts:

* ``refine_qpel_costmap(src (n, b, b) uint8, windows (n, >= b+7, >= b+7)
  uint8)`` -> (n, 4, 4) int32 QPEL_SCORE maps indexed [yf, xf], for b in
  {8, 16, 32, 64}; only each window's top-left (b+7, b+7) is read.
* ``refine_qpel_costmap_dma(src (n, b, b) uint8, plane (Hp, Wp) uint8,
  offsets (n, 2) int32)`` -> (cost (n, 4, 4) int32, windows (n, b+7, b+7)
  uint8), for b in {8, 16, 32}: tile i's window starts at offsets[i] = [y,
  x] in the plane, and a start past the plane's end is clamped so the
  window fits, as ``encode.motion.extract_windows`` clamps.  The TPU kernel
  returns (n, b+8, 128) aligned slabs, a TPU layout device whose only
  consumer reads [:, :b+7, :b+7]; the port returns that window itself.
  The TPU kernel's chunking above 1536 tiles works around its scalar
  memory and is not needed here.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.pred_inter import KERNEL8, qpel_costmap
from ..utils.tensor import as_tensor, extract_windows
from . import build

__all__ = ["refine_qpel_costmap", "refine_qpel_costmap_ref",
           "refine_qpel_costmap_dma", "refine_qpel_costmap_dma_ref",
           "GATHERED_SIZES", "PLANE_SIZES"]

#: Tile sides served with gathered windows (B12) and from the plane (B13).
GATHERED_SIZES = (8, 16, 32, 64)
PLANE_SIZES = (8, 16, 32)
TAPS = KERNEL8.shape[-1]


def _check_src(src: torch.Tensor, sizes: tuple[int, ...], what: str) -> int:
    if src.dim() != 3 or src.shape[1] != src.shape[2] or src.shape[-1] not in sizes:
        raise ValueError(f"{what}: src must be (n, b, b) with b in {sizes}, "
                         f"got {tuple(src.shape)}")
    return src.shape[-1]


def _check_windows(src: torch.Tensor, windows: torch.Tensor) -> int:
    b = _check_src(src, GATHERED_SIZES, "refine_qpel_costmap")
    if windows.dim() != 3 or windows.shape[0] != src.shape[0] \
            or min(windows.shape[1:]) < b + TAPS - 1:
        raise ValueError(f"refine_qpel_costmap: windows must be ({src.shape[0]}, "
                         f">= {b + TAPS - 1}, >= {b + TAPS - 1}), got {tuple(windows.shape)}")
    return b


def _check_plane(src: torch.Tensor, plane: torch.Tensor, offsets: torch.Tensor) -> int:
    b = _check_src(src, PLANE_SIZES, "refine_qpel_costmap_dma")
    if plane.dim() != 2 or min(plane.shape) < b + TAPS - 1:
        raise ValueError(f"refine_qpel_costmap_dma: plane must be 2-D and at least "
                         f"{b + TAPS - 1} each way, got {tuple(plane.shape)}")
    if offsets.shape != (src.shape[0], 2):
        raise ValueError(f"refine_qpel_costmap_dma: offsets must be ({src.shape[0]}, 2), "
                         f"got {tuple(offsets.shape)}")
    return b


def refine_qpel_costmap_ref(src_blocks, windows) -> torch.Tensor:
    """Plain version: ops.pred_inter.qpel_costmap on the given windows."""
    src = as_tensor(src_blocks)
    windows = as_tensor(windows, src.device)
    _check_windows(src, windows)
    return qpel_costmap(src, windows)


def refine_qpel_costmap(src_blocks, windows) -> torch.Tensor:
    """(n, 4, 4) int32 cost maps.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched)."""
    src = as_tensor(src_blocks)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return refine_qpel_costmap_ref(src, windows)
    dev = build.on_card("refine_qpel_costmap", src, windows)
    if src.dtype != torch.uint8 or windows.dtype != torch.uint8:
        raise TypeError("refine_qpel_costmap: src_blocks and windows must be uint8")
    if not src.is_contiguous() or windows.stride(-1) != 1:
        raise ValueError("refine_qpel_costmap: src_blocks must be contiguous and "
                         "windows rows contiguous")
    b = _check_windows(src, windows)
    n = src.shape[0]
    cost = torch.empty((n, 4, 4), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.hevc_costmap(src.data_ptr(), windows.data_ptr(), windows.stride(0),
                           windows.stride(1), cost.data_ptr(), n, b, dev.index or 0,
                           torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "refine_qpel_costmap")
    refine_qpel_costmap.launches += 1
    return cost


def refine_qpel_costmap_dma_ref(src_blocks, plane, offsets, group: int | None = None):
    """Plain version: gather each (b+7, b+7) window with
    utils.tensor.extract_windows, then ops.pred_inter.qpel_costmap.  ``group`` is
    accepted for signature parity and ignored."""
    src = as_tensor(src_blocks)
    plane = as_tensor(plane, src.device)
    offsets = as_tensor(offsets, src.device)
    b = _check_plane(src, plane, offsets)
    win = extract_windows(plane, offsets, b + TAPS - 1)
    return qpel_costmap(src, win), win


def refine_qpel_costmap_dma(src_blocks, plane, offsets, group: int | None = None):
    """(cost (n, 4, 4) int32, windows (n, b+7, b+7) uint8).  CPU tensors
    run the plain version; CUDA tensors launch the kernel (and raise if it
    cannot be built or launched).  ``group`` is accepted and ignored."""
    src = as_tensor(src_blocks)
    plane = as_tensor(plane, src.device)
    offsets = as_tensor(offsets, src.device)
    if src.device.type == "cpu":
        return refine_qpel_costmap_dma_ref(src, plane, offsets)
    dev = build.on_card("refine_qpel_costmap_dma", src, plane, offsets)
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8 \
            or offsets.dtype != torch.int32:
        raise TypeError("refine_qpel_costmap_dma: src_blocks and plane must be "
                        "uint8 and offsets int32")
    if not (src.is_contiguous() and plane.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("refine_qpel_costmap_dma: inputs must be contiguous")
    b = _check_plane(src, plane, offsets)
    n = src.shape[0]
    win = b + TAPS - 1
    cost = torch.empty((n, 4, 4), dtype=torch.int32, device=dev)
    windows = torch.empty((n, win, win), dtype=torch.uint8, device=dev)
    lib = build.load()
    err = lib.hevc_costmap_dma(src.data_ptr(), plane.data_ptr(), offsets.data_ptr(),
                               cost.data_ptr(), windows.data_ptr(), n, b,
                               plane.shape[0], plane.shape[1], dev.index or 0,
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "refine_qpel_costmap_dma")
    refine_qpel_costmap_dma.launches += 1
    return cost, windows


refine_qpel_costmap.launches = 0
refine_qpel_costmap_dma.launches = 0

registry.register("refine_qpel_costmap", Tier.REF, refine_qpel_costmap_ref)
registry.register("refine_qpel_costmap", Tier.KERNEL, refine_qpel_costmap)
registry.register("refine_qpel_costmap_dma", Tier.REF, refine_qpel_costmap_dma_ref)
registry.register("refine_qpel_costmap_dma", Tier.KERNEL, refine_qpel_costmap_dma)
