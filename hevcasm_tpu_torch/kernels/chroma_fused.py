"""Kernel chroma_p_fused: the chroma of a 4:2:0 P frame, both planes, in one
launch.

It replaces no TPU kernel: hevcasm_tpu codes a P frame's chroma in plain ops
(``encode.video._chroma_mc`` then ``_chroma_residual``, a plane at a time),
and so did the port, some 280 small torch launches a frame with the 4x4
transforms as float64 matrix products.  ``csrc/chroma_fused.cu`` computes
the same integers in one launch: for each 32x32 chroma block of both planes
(the chroma of one 64x64 luma CTU) its window straight from the unpadded
reference plane (edges clamped), the 4-tap prediction on B5's tensor-core
core (``csrc/mc_tc.cuh``), the 4x4 residual on the stage K2, B3, B4 and B19
share (``csrc/residual_core.cuh``), and the reconstruction and nnz written
to the frame's planes; the header says what bounds it on the card.  Beside
it stands its plain version, ``chroma_p_fused_ref``.

Contract: ``chroma_p_fused(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg)``
with four (H/2, W/2) uint8 planes, H/2 and W/2 multiples of 32, mv_qpel (n,
2) integer (dy, dx) luma quarter-pel MVs, one a 32x32 chroma block in raster
order, and cfg the luma EncodeConfig (64x64 CTUs; its qp gives the chroma
quantizer at 4x4 TUs, encode.video._chroma_cfg's).  Returns (rec_cb, nnz_cb,
rec_cr, nnz_cr): (H/2, W/2) uint8 planes and () int32 counts of coded
coefficients.  MVs within cfg's search range reach at most the padding the
plain version builds; the kernel clamps any reach to the plane's edge.

It is the KERNEL tier of the registry's ``chroma_p_fused``, whose REF tier
is the plain version; encode.video.encode_inter_frame_yuv takes it for CUDA
planes at 64x64 CTUs when the tiers include KERNEL.
"""

from __future__ import annotations

import functools
import struct

import torch

from .. import registry
from ..config import Tier
from ..ops.quantize import check_quant_params
from ..utils.tensor import as_tensor
from . import build

__all__ = ["chroma_p_fused", "chroma_p_fused_ref", "BLOCK"]

BLOCK = 32                          # chroma block side: the chroma of a 64x64 luma CTU
_ARGS = struct.Struct("17q")        # csrc/chroma_fused.cu ChromaArgs
_U8, _I32 = torch.uint8, torch.int32


def chroma_p_fused_ref(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg):
    """Plain version: encode.video's _chroma_mc then _chroma_residual at
    Tier.REF, for each plane."""
    from ..encode import video

    cur_cb = as_tensor(cur_cb)
    dev = cur_cb.device
    mv = as_tensor(mv_qpel, dev)
    out = []
    for cur, ref in ((cur_cb, ref_cb), (cur_cr, ref_cr)):
        pred = video._chroma_mc(as_tensor(ref, dev), mv, cfg)
        out += video._chroma_residual(as_tensor(cur, dev), pred, cfg, False, Tier.REF)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _qargs(qp: int) -> tuple:
    """The chroma quantizer (qscale, qshift, qoffset, dscale, dshift) of
    luma qp ``qp`` as host ints: _chroma_cfg's at 4x4 TUs, inter."""
    from ..encode import video
    from ..encode.loop import EncodeConfig

    ccfg = video._chroma_cfg(EncodeConfig(qp=qp))
    q = (*ccfg.quant_params(False), *ccfg.dequant_params())
    check_quant_params(*q[:3])
    return q


def _enqueue(card: int, planes, mv: torch.Tensor, h: int, w: int, qp: int):
    """Launch the kernel on card ``card`` (its index) on checked operands:
    four (h, w) uint8 planes, contiguous and 16-byte aligned, and (h / 32 *
    w / 32, 2) int32 contiguous MVs there."""
    rec = torch.empty((2, h, w), dtype=_U8, device=card)
    nnz = torch.empty(2, dtype=_I32, device=card)
    err = build.load().hevc_chroma_p_fused(_ARGS.pack(
        planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), planes[3].data_ptr(),
        rec.data_ptr(), rec.data_ptr() + h * w, mv.data_ptr(), nnz.data_ptr(), h, w,
        *_qargs(qp), card, build.raw_stream(card)))
    build.check(err, "chroma_p_fused")
    return rec[0], nnz[0], rec[1], nnz[1]


# A frame's call is host-bound (the kernel takes microseconds), so, as B5's
# and B10's, the launch path does per call only what it must: for four
# contiguous, 16-byte aligned (h, w) uint8 planes on one card and contiguous
# int32 MVs there, it reads shapes and pointers inline and hands the C entry
# one packed block.  Every other layout, and every error, goes through
# _launch's checks.
def _fast(planes, mv, cfg):
    first = planes[0]
    if type(first) is not torch.Tensor or not first.is_cuda or cfg.ctu != 2 * BLOCK:
        return None
    shape, card = first.shape, first.get_device()
    if len(shape) != 2 or shape[0] % BLOCK or shape[1] % BLOCK or not shape[0] or not shape[1]:
        return None
    for p in planes:
        if type(p) is not torch.Tensor or p.dtype is not _U8 or p.shape != shape \
                or not p.is_contiguous() or p.data_ptr() & 15 or p.get_device() != card:
            return None
    h, w = shape
    if type(mv) is not torch.Tensor or mv.dtype is not _I32 or not mv.is_contiguous() \
            or mv.shape != (h // BLOCK * (w // BLOCK), 2) or mv.get_device() != card:
        return None
    return _enqueue(card, planes, mv, h, w, cfg.qp)


def _aligned(plane: torch.Tensor) -> torch.Tensor:
    """The plane contiguous at a 16-byte aligned address (a copy if not)."""
    plane = plane.contiguous()
    return plane.clone() if plane.data_ptr() & 15 else plane


def _launch(planes, mv, cfg):
    what = "chroma_p_fused"
    dev = build.on_card(what, *planes, mv)
    if cfg.ctu != 2 * BLOCK:
        raise ValueError(f"{what}: {cfg.ctu}x{cfg.ctu} CTUs; the kernel codes the "
                         f"{BLOCK}x{BLOCK} chroma blocks of 64x64 CTUs")
    if any(p.dtype != _U8 for p in planes):
        raise TypeError(f"{what}: the planes must be uint8, got {[p.dtype for p in planes]}")
    shape = planes[0].shape
    if planes[0].dim() != 2 or any(p.shape != shape for p in planes) or shape[0] % BLOCK \
            or shape[1] % BLOCK or not shape[0] or not shape[1]:
        raise ValueError(f"{what}: planes must be (h, w) of one shape, h and w multiples of "
                         f"{BLOCK}, got {[tuple(p.shape) for p in planes]}")
    h, w = shape
    n = h // BLOCK * (w // BLOCK)
    if mv.dtype.is_floating_point or mv.dtype.is_complex or mv.dtype == torch.bool:
        raise TypeError(f"{what}: MVs must be integers, got {mv.dtype}")
    if tuple(mv.shape) != (n, 2):
        raise ValueError(f"{what}: MVs {tuple(mv.shape)} for {n} blocks; need ({n}, 2)")
    return _enqueue(dev.index, [_aligned(p) for p in planes], mv.to(_I32).contiguous(), h, w,
                    cfg.qp)


def chroma_p_fused(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg):
    """(rec_cb, nnz_cb, rec_cr, nnz_cr).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched, or the shape is one it does not take)."""
    planes = (cur_cb, cur_cr, ref_cb, ref_cr)
    out = _fast(planes, mv_qpel, cfg)
    if out is None:
        planes = [as_tensor(p) for p in planes]
        mv = as_tensor(mv_qpel, planes[0].device)
        if planes[0].device.type == "cpu":
            return chroma_p_fused_ref(*planes, mv, cfg)
        out = _launch(planes, mv, cfg)
    chroma_p_fused.launches += 1
    return out


chroma_p_fused.launches = 0

registry.register("chroma_p_fused", Tier.REF, chroma_p_fused_ref)
registry.register("chroma_p_fused", Tier.KERNEL, chroma_p_fused)
