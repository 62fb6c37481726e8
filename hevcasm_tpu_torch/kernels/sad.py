"""Kernels B9 and B10: the exact SAD grid of square blocks against given
windows, and the SAD of blocks against one reference or k.

``sad_grid`` replaces the TPU kernel ``hevcasm_tpu/kernels/sad_pallas.py``
``sad_grid`` (body ``_sad_grid_kernel``).  Its CUDA source is
``csrc/sad_grid.cu``: packed terms, four absolute differences an
instruction (VABSDIFF4), on four byte-shifted copies of the window rows.
``sad`` and ``sad_multiref`` replace
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

import math
import struct

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


def _operands(what: str, src: torch.Tensor, refs: torch.Tensor, keep: int):
    """Any layout the wrappers take: check src (..., h, w) and refs (...,
    [k,] h, w) (``keep`` = 2 or 3 trailing axes), raise on what the kernel
    does not take, and return (src, its strides, refs, theirs, n) with one
    leading block axis (stride 0 when there is none)."""
    if src.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {src.device}; need a CUDA device")
    if src.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError(f"{what}: blocks must be uint8, got {src.dtype} and {refs.dtype}")
    shape, rshape = src.shape, refs.shape
    if len(shape) < 2 or len(rshape) != len(shape) + keep - 2 \
            or rshape[:len(shape) - 2] != shape[:-2] or rshape[-2:] != shape[-2:]:
        raise ValueError(f"{what}: src (..., h, w) and refs (..., {'k, ' * (keep - 2)}h, w) "
                         f"must hold blocks of one shape, got {tuple(shape)} and "
                         f"{tuple(rshape)}")
    h, w = shape[-2], shape[-1]
    if h < 1 or w < 1 or h * w > MAX_PIXELS:
        raise ValueError(f"{what}: blocks of {h}x{w}; the kernel takes h, w >= 1 with "
                         f"h * w <= {MAX_PIXELS}")
    out = []
    for x, k in ((src, 2), (refs, keep)):
        st = x.stride()
        if st[-1] != 1 or len(st) > k + 1:     # merge the leading axes; rows contiguous
            x = x.reshape(-1, *x.shape[-k:])
            x = x if x.stride(-1) == 1 else x.contiguous()
            st = x.stride()
        out += [x, st if len(st) == k + 1 else (0, *st)]
    return (*out, math.prod(shape[:-2]))


# B10's calls are host-bound (2.5 us of kernel on an H100 for 510 64x64
# blocks, against ~15 us of host work a call), so the launch path does per
# call only what it must: for the (n, h, w) and (n, k, h, w) operands of a
# batch it reads shapes, strides and pointers inline (every other layout,
# and every error, goes through _operands), allocates the output with its
# size as ints (which PyTorch parses faster than a torch.Size), takes the
# stream handle without a torch.cuda.Stream object, and hands the C entry
# its 14 arguments as one packed block.
_ARGS = struct.Struct("14q")          # csrc/sad.cu SadArgs
_U8 = torch.uint8


def sad(src, ref) -> torch.Tensor:
    """SAD over the trailing two axes, (..., h, w) -> (...,) int32.  CPU
    tensors run the plain version (ops.sad.sad); CUDA tensors launch B10
    (and raise if it cannot be built or launched, or the shape is one it
    does not take)."""
    src = as_tensor(src)
    dev = src.device
    ref = as_tensor(ref, dev)
    if dev.type == "cpu":
        return sad_ref(src, ref)
    shape, ss, rs = src.shape, src.stride(), ref.stride()
    if len(shape) == 3 and ref.shape == shape and ss[2] == 1 and rs[2] == 1 \
            and src.dtype is _U8 and ref.dtype is _U8 and dev.type == "cuda" \
            and 0 < shape[1] * shape[2] <= MAX_PIXELS:
        n = shape[0]
    else:
        src, ss, ref, rs, n = _operands("sad", src, ref, 2)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    err = build.load().hevc_sad(_ARGS.pack(
        src.data_ptr(), ss[0], ss[1], ref.data_ptr(), rs[0], 0, rs[1], out.data_ptr(), n, 1,
        shape[-2], shape[-1], dev.index, build.raw_stream(dev.index)))
    build.check(err, "sad")
    sad.launches += 1
    return out if len(shape) == 3 else out.view(shape[:-2])


def sad_multiref(src, refs) -> torch.Tensor:
    """One block against k references, src (..., h, w) and refs (..., k, h,
    w) -> (..., k) int32.  CPU tensors run the plain version
    (ops.sad.sad_multiref); CUDA tensors launch B10 (and raise if it
    cannot be built or launched, or the shape is one it does not take)."""
    src = as_tensor(src)
    dev = src.device
    refs = as_tensor(refs, dev)
    if dev.type == "cpu":
        return sad_multiref_ref(src, refs)
    shape, rshape, ss, rs = src.shape, refs.shape, src.stride(), refs.stride()
    if len(shape) == 3 and len(rshape) == 4 and rshape[0] == shape[0] \
            and rshape[2:] == shape[1:] and ss[2] == 1 and rs[3] == 1 \
            and src.dtype is _U8 and refs.dtype is _U8 and dev.type == "cuda" \
            and 0 < shape[1] * shape[2] <= MAX_PIXELS:
        n = shape[0]
    else:
        src, ss, refs, rs, n = _operands("sad_multiref", src, refs, 3)
    k = rshape[-3]
    out = torch.empty(n, k, dtype=torch.int32, device=dev)
    err = build.load().hevc_sad_multiref(_ARGS.pack(
        src.data_ptr(), ss[0], ss[1], refs.data_ptr(), rs[0], rs[1], rs[2], out.data_ptr(), n,
        k, shape[-2], shape[-1], dev.index, build.raw_stream(dev.index)))
    build.check(err, "sad_multiref")
    sad_multiref.launches += 1
    return out if len(shape) == 3 else out.view(*shape[:-2], k)


sad_grid.launches = 0
sad.launches = 0
sad_multiref.launches = 0

registry.register("sad_grid", Tier.REF, sad_grid_ref)
registry.register("sad_grid", Tier.KERNEL, sad_grid)
registry.register("sad", Tier.KERNEL, sad)
registry.register("sad_multiref", Tier.KERNEL, sad_multiref)
