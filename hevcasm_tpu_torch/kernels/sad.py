"""Kernels B9 and B10: the exact SAD grid of square blocks against given
windows, and the SAD of blocks against one reference or k.

``sad_grid`` replaces the TPU kernel ``hevcasm_tpu/kernels/sad_pallas.py``
``sad_grid`` (body ``_sad_grid_kernel``).  Its CUDA source is
``csrc/sad_grid.cu``, B8's grid core (``csrc/grid_core.cuh``) with the
absolute difference for the square.  ``sad`` and ``sad_multiref`` replace
the TPU kernels of those names (``_sad_kernel``, ``_sad_multiref_kernel``);
they are the two C entries of ``csrc/sad.cu``.  Each header says what
bounds the kernel on the card.  Beside each stands its plain PyTorch
version (``*_ref``, the ``ops.sad`` function).

Contracts:

* ``sad_grid(src, window, num_dy, num_dx)``: src (n, b, b) uint8, window
  (n, >= b + num_dy - 1, >= b + num_dx - 1) uint8 -> (n, num_dy, num_dx)
  int32, ``out[i, dy, dx] = sum |window[i, dy + y, dx + x] - src[i, y,
  x]|``; any other leading axes (none, or several) are kept, as the TPU
  kernel's 2-D form is.  The kernel takes B8's geometry: b in {8, 16, 32,
  64} and windows up to 256 wide.  It is the KERNEL tier of the registry's
  ``sad_grid``, which ``encode.motion.grid_metric_fn("sad")`` returns.
* ``sad(src, ref)``: (..., h, w) uint8 twice -> (...,) int32 ``sum |src -
  ref|`` over each block; (h, w) gives a 0-d result, as the TPU kernel's
  2-D form does.
* ``sad_multiref(src, refs)``: src (..., h, w), refs (..., k, h, w) uint8
  -> (..., k) int32; a 2-D src with (k, h, w) refs gives (k,).
  B10 takes any h, w with h * w * 255 < 2^31 and any k; rows and blocks may
  be any number of bytes apart (strided views are read in place).  The two
  are the KERNEL tiers of the registry's ``sad`` and ``sad_multiref``.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.sad import sad as sad_ref
from ..ops.sad import sad_grid as sad_grid_ref
from ..ops.sad import sad_multiref as sad_multiref_ref
from ..utils.tensor import as_tensor
from . import build
from .search import grid_launch

__all__ = ["sad_grid", "sad_grid_ref", "sad", "sad_ref", "sad_multiref", "sad_multiref_ref"]

MAX_PIXELS = (2 ** 31 - 1) // 255       # the largest block whose SAD fits int32


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


def _blocks(what: str, x: torch.Tensor, keep: int) -> torch.Tensor:
    """uint8 x with its trailing ``keep`` axes kept and the others merged
    into one, rows contiguous: a view where one exists, else an explicit
    copy."""
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: blocks must be uint8, got {x.dtype}")
    x = x.reshape(-1, *x.shape[x.dim() - keep:])
    return x if x.stride(-1) == 1 else x.contiguous()


def _check_block(what: str, h: int, w: int) -> None:
    if h < 1 or w < 1 or h * w > MAX_PIXELS:
        raise ValueError(f"{what}: blocks of {h}x{w}; the kernel takes h, w >= 1 with "
                         f"h * w <= {MAX_PIXELS}")


def sad(src, ref) -> torch.Tensor:
    """SAD over the trailing two axes, (..., h, w) -> (...,) int32.  CPU
    tensors run the plain version (ops.sad.sad); CUDA tensors launch B10
    (and raise if it cannot be built or launched, or the shape is one it
    does not take)."""
    src = as_tensor(src)
    ref = as_tensor(ref, src.device)
    if src.device.type == "cpu":
        return sad_ref(src, ref)
    dev = build.on_card("sad", src, ref)
    if src.dim() < 2 or ref.shape != src.shape:
        raise ValueError(f"sad: src and ref must be (..., h, w) of one shape, got "
                         f"{tuple(src.shape)} and {tuple(ref.shape)}")
    *lead, h, w = src.shape
    _check_block("sad", h, w)
    s, r = _blocks("sad", src, 2), _blocks("sad", ref, 2)
    n = s.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    err = build.load().hevc_sad(
        s.data_ptr(), s.stride(0), s.stride(1), r.data_ptr(), r.stride(0), r.stride(1),
        out.data_ptr(), n, h, w, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sad")
    sad.launches += 1
    return out.reshape(lead)


def sad_multiref(src, refs) -> torch.Tensor:
    """One block against k references, src (..., h, w) and refs (..., k, h,
    w) -> (..., k) int32.  CPU tensors run the plain version
    (ops.sad.sad_multiref); CUDA tensors launch B10 (and raise if it
    cannot be built or launched, or the shape is one it does not take)."""
    src = as_tensor(src)
    refs = as_tensor(refs, src.device)
    if src.device.type == "cpu":
        return sad_multiref_ref(src, refs)
    dev = build.on_card("sad_multiref", src, refs)
    if src.dim() < 2 or refs.dim() != src.dim() + 1 or refs.shape[:-3] != src.shape[:-2] \
            or refs.shape[-2:] != src.shape[-2:]:
        raise ValueError(f"sad_multiref: src must be (..., h, w) and refs (..., k, h, w), "
                         f"got {tuple(src.shape)} and {tuple(refs.shape)}")
    *lead, h, w = src.shape
    _check_block("sad_multiref", h, w)
    k = refs.shape[-3]
    s, r = _blocks("sad_multiref", src, 2), _blocks("sad_multiref", refs, 3)
    n = s.shape[0]
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    err = build.load().hevc_sad_multiref(
        s.data_ptr(), s.stride(0), s.stride(1), r.data_ptr(), r.stride(0), r.stride(1),
        r.stride(2), out.data_ptr(), n, k, h, w, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sad_multiref")
    sad_multiref.launches += 1
    return out.reshape(*lead, k)


sad_grid.launches = 0
sad.launches = 0
sad_multiref.launches = 0

registry.register("sad_grid", Tier.REF, sad_grid_ref)
registry.register("sad_grid", Tier.KERNEL, sad_grid)
registry.register("sad", Tier.KERNEL, sad)
registry.register("sad_multiref", Tier.KERNEL, sad_multiref)
