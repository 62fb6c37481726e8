"""Kernels chroma_p_fused, chroma_b_fused and chroma_pu_fused: the chroma of
a 4:2:0 P frame (one reference) or B frame (two references), both planes, in
one launch; chroma_pu_fused is the RD P frame's, an MV a PU tile.

They replace no TPU kernel: hevcasm_tpu codes a frame's chroma in plain ops
(``encode.video._chroma_mc`` then ``_chroma_residual``, a plane at a time;
a B frame predicts from both references as int16 intermediates and takes
their rounded mean), and so did the port, some 280 (P) or 400 (B) small
torch launches a frame with the 4x4 transforms as float64 matrix products.
``csrc/chroma_fused.cu`` computes the same integers in one launch: for each
32x32 chroma block of both planes (the chroma of one 64x64 luma CTU) its
windows straight from the unpadded reference planes (edges clamped), the
4-tap prediction on B5's tensor-core core, or B6's bi path of it
(``csrc/mc_tc.cuh``), the 4x4 residual on the stage K2, B3, B4 and B19
share (``csrc/residual_core.cuh``), and the reconstruction and nnz written
to the frame's planes; the header says what bounds them on the card.
Beside each stands its plain version, ``chroma_p_fused_ref`` and
``chroma_b_fused_ref``.  chroma_pu_fused predicts each (32 / k)-square tile
of a block at its own MV with a scalar 4-tap filter on the CUDA cores,
reading the windows straight from the planes, then codes the block as the
other two do; its plain version is chroma_p_fused_ref, which takes an MV
field.

Contract: ``chroma_p_fused(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg)``
and ``chroma_b_fused(cur_cb, cur_cr, ref0_cb, ref0_cr, ref1_cb, ref1_cr,
mv0_qpel, mv1_qpel, cfg)`` with (H/2, W/2) uint8 planes, H/2 and W/2
multiples of 32, MVs (n, 2) integer (dy, dx) luma quarter-pel, one a 32x32
chroma block in raster order (mv0 into ref0, mv1 into ref1), and cfg the
luma EncodeConfig (64x64 CTUs; its qp gives the chroma quantizer at 4x4
TUs, encode.video._chroma_cfg's, for both frame types).  Each returns
(rec_cb, nnz_cb, rec_cr, nnz_cr): (H/2, W/2) uint8 planes and () int32
counts of coded coefficients.  ``chroma_pu_fused(cur_cb, cur_cr, ref_cb,
ref_cr, mv_field, cfg)`` takes the same with an MV field (n, k, k, 2), k in
(1, 2, 4, 8): tile (ty, tx) of block i, (32 / k)-square, at mv_field[i, ty,
tx] (the luma PU decision's base tiles: 8x8 luma tiles give k = 8).  MVs
within cfg's search range reach at most the padding the plain versions
build; the kernels clamp any reach to the plane's edge.

They are the KERNEL tiers of the registry's ``chroma_p_fused``,
``chroma_b_fused`` and ``chroma_pu_fused``, whose REF tiers are the plain
versions; encode.video.encode_inter_frame_yuv (chroma_pu_fused for the PU
decision's MV field) and encode_b_frame_yuv take them for CUDA planes at
64x64 CTUs when the tiers include KERNEL.
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

__all__ = ["chroma_p_fused", "chroma_p_fused_ref", "chroma_b_fused", "chroma_b_fused_ref",
           "chroma_pu_fused", "BLOCK"]

BLOCK = 32                          # chroma block side: the chroma of a 64x64 luma CTU
# By the number R of references: the kernel's name (its C entry is hevc_<name>)
# and csrc/chroma_fused.cu's packed ChromaFusedArgs<R>.
_KERNELS = {1: ("chroma_p_fused", struct.Struct("17q")),
            2: ("chroma_b_fused", struct.Struct("20q"))}
# csrc/chroma_fused.cu's ChromaPuArgs, and the MV field's tiles a block side.
_PU_ARGS = struct.Struct("18q")
PU_TILES = (1, 2, 4, 8)
_U8, _I32 = torch.uint8, torch.int32


def chroma_p_fused_ref(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg):
    """Plain version of chroma_p_fused and chroma_pu_fused: encode.video's
    _chroma_mc (MVs (n, 2), or an MV field (n, k, k, 2)) then
    _chroma_residual at Tier.REF, for each plane."""
    from ..encode import video

    cur_cb = as_tensor(cur_cb)
    dev = cur_cb.device
    mv = as_tensor(mv_qpel, dev)
    out = []
    for cur, ref in ((cur_cb, ref_cb), (cur_cr, ref_cr)):
        pred = video._chroma_mc(as_tensor(ref, dev), mv, cfg)
        out += video._chroma_residual(as_tensor(cur, dev), pred, cfg, False, Tier.REF)
    return tuple(out)


def chroma_b_fused_ref(cur_cb, cur_cr, ref0_cb, ref0_cr, ref1_cb, ref1_cr, mv0_qpel,
                       mv1_qpel, cfg):
    """Plain version: for each plane, encode.video's _chroma_mc of each
    reference at its MVs as int16 intermediates, their mean (p0 + p1 + 64)
    >> 7 clipped to 8 bits, then _chroma_residual at Tier.REF."""
    from ..encode import video

    cur_cb = as_tensor(cur_cb)
    dev = cur_cb.device
    mv0, mv1 = as_tensor(mv0_qpel, dev), as_tensor(mv1_qpel, dev)
    out = []
    for cur, ref0, ref1 in ((cur_cb, ref0_cb, ref1_cb), (cur_cr, ref0_cr, ref1_cr)):
        p0 = video._chroma_mc(as_tensor(ref0, dev), mv0, cfg, out16=True).to(_I32)
        p1 = video._chroma_mc(as_tensor(ref1, dev), mv1, cfg, out16=True).to(_I32)
        pred = ((p0 + p1 + 64) >> 7).clamp(0, 255).to(_U8)
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


def _enqueue(card: int, planes, mvs, h: int, w: int, qp: int):
    """Launch the kernel of len(mvs) references on card ``card`` (its
    index) on checked operands: the source planes, then each reference's,
    (h, w) uint8, contiguous and 16-byte aligned, and (h / 32 * w / 32, 2)
    int32 contiguous MVs there, one a reference."""
    what, args = _KERNELS[len(mvs)]
    rec = torch.empty((2, h, w), dtype=_U8, device=card)
    nnz = torch.empty(2, dtype=_I32, device=card)
    err = getattr(build.load(), f"hevc_{what}")(args.pack(
        *[p.data_ptr() for p in planes], rec.data_ptr(), rec.data_ptr() + h * w,
        *[mv.data_ptr() for mv in mvs], nnz.data_ptr(), h, w, *_qargs(qp), card,
        build.raw_stream(card)))
    build.check(err, what)
    return rec[0], nnz[0], rec[1], nnz[1]


# A frame's call is host-bound (the kernel takes microseconds), so, as B5's
# and B10's, the launch path does per call only what it must: for
# contiguous, 16-byte aligned (h, w) uint8 planes on one card and contiguous
# int32 MVs there, it reads shapes and pointers inline and hands the C entry
# one packed block.  Every other layout, and every error, goes through
# _launch's checks.
def _fast(planes, mvs, cfg):
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
    for mv in mvs:
        if type(mv) is not torch.Tensor or mv.dtype is not _I32 or not mv.is_contiguous() \
                or mv.shape != (h // BLOCK * (w // BLOCK), 2) or mv.get_device() != card:
            return None
    return _enqueue(card, planes, mvs, h, w, cfg.qp)


def _aligned(plane: torch.Tensor) -> torch.Tensor:
    """The plane contiguous at a 16-byte aligned address (a copy if not)."""
    plane = plane.contiguous()
    return plane.clone() if plane.data_ptr() & 15 else plane


def _enqueue_pu(card: int, planes, field, h: int, w: int, k: int, qp: int):
    """Launch chroma_pu_fused's kernel on card ``card`` on checked operands:
    the four planes as _enqueue takes them and the (h / 32 * w / 32, k, k,
    2) int32 contiguous MV field there."""
    rec = torch.empty((2, h, w), dtype=_U8, device=card)
    nnz = torch.empty(2, dtype=_I32, device=card)
    err = build.load().hevc_chroma_pu_fused(_PU_ARGS.pack(
        *[p.data_ptr() for p in planes], rec.data_ptr(), rec.data_ptr() + h * w,
        field.data_ptr(), nnz.data_ptr(), h, w, k, *_qargs(qp), card, build.raw_stream(card)))
    build.check(err, "chroma_pu_fused")
    return rec[0], nnz[0], rec[1], nnz[1]


def _launch(what, planes, mvs, cfg, tiles=None):
    """Check the operands and launch: MVs (n, 2) a block, or with ``tiles``
    = k the one MV field (n, k, k, 2) of chroma_pu_fused."""
    dev = build.on_card(what, *planes, *mvs)
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
    want = (n, 2) if tiles is None else (n, tiles, tiles, 2)
    for mv in mvs:
        if mv.dtype.is_floating_point or mv.dtype.is_complex or mv.dtype == torch.bool:
            raise TypeError(f"{what}: MVs must be integers, got {mv.dtype}")
        if tuple(mv.shape) != want:
            raise ValueError(f"{what}: MVs {tuple(mv.shape)} for {n} blocks; need {want}")
    planes = [_aligned(p) for p in planes]
    mvs = [mv.to(_I32).contiguous() for mv in mvs]
    if tiles is None:
        return _enqueue(dev.index, planes, mvs, h, w, cfg.qp)
    return _enqueue_pu(dev.index, planes, mvs[0], h, w, tiles, cfg.qp)


def chroma_p_fused(cur_cb, cur_cr, ref_cb, ref_cr, mv_qpel, cfg):
    """(rec_cb, nnz_cb, rec_cr, nnz_cr).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched, or the shape is one it does not take)."""
    planes, mvs = (cur_cb, cur_cr, ref_cb, ref_cr), (mv_qpel,)
    out = _fast(planes, mvs, cfg)
    if out is None:
        planes = [as_tensor(p) for p in planes]
        mv = as_tensor(mv_qpel, planes[0].device)
        if planes[0].device.type == "cpu":
            return chroma_p_fused_ref(*planes, mv, cfg)
        out = _launch("chroma_p_fused", planes, (mv,), cfg)
    chroma_p_fused.launches += 1
    return out


def chroma_b_fused(cur_cb, cur_cr, ref0_cb, ref0_cr, ref1_cb, ref1_cr, mv0_qpel, mv1_qpel,
                   cfg):
    """(rec_cb, nnz_cb, rec_cr, nnz_cr).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched, or the shape is one it does not take)."""
    planes = (cur_cb, cur_cr, ref0_cb, ref0_cr, ref1_cb, ref1_cr)
    out = _fast(planes, (mv0_qpel, mv1_qpel), cfg)
    if out is None:
        planes = [as_tensor(p) for p in planes]
        mvs = [as_tensor(mv, planes[0].device) for mv in (mv0_qpel, mv1_qpel)]
        if planes[0].device.type == "cpu":
            return chroma_b_fused_ref(*planes, *mvs, cfg)
        out = _launch("chroma_b_fused", planes, mvs, cfg)
    chroma_b_fused.launches += 1
    return out


def chroma_pu_fused(cur_cb, cur_cr, ref_cb, ref_cr, mv_field, cfg):
    """(rec_cb, nnz_cb, rec_cr, nnz_cr), each (32 / k)-square tile of a
    block at its MV of mv_field (n, k, k, 2).  CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot be
    built or launched, or the shape is one it does not take).  The RD
    frame's call takes milliseconds, so every call takes _launch's
    checks."""
    planes = [as_tensor(p) for p in (cur_cb, cur_cr, ref_cb, ref_cr)]
    field = as_tensor(mv_field, planes[0].device)
    if planes[0].device.type == "cpu":
        return chroma_p_fused_ref(*planes, field, cfg)
    k = field.shape[1] if field.dim() == 4 else None
    if k not in PU_TILES:
        raise ValueError(f"chroma_pu_fused: an MV field (n, k, k, 2) with k in {PU_TILES}, "
                         f"got {tuple(field.shape)}")
    out = _launch("chroma_pu_fused", planes, (field,), cfg, k)
    chroma_pu_fused.launches += 1
    return out


chroma_p_fused.launches = 0
chroma_b_fused.launches = 0
chroma_pu_fused.launches = 0

registry.register("chroma_p_fused", Tier.REF, chroma_p_fused_ref)
registry.register("chroma_p_fused", Tier.KERNEL, chroma_p_fused)
registry.register("chroma_b_fused", Tier.REF, chroma_b_fused_ref)
registry.register("chroma_b_fused", Tier.KERNEL, chroma_b_fused)
registry.register("chroma_pu_fused", Tier.REF, chroma_p_fused_ref)
registry.register("chroma_pu_fused", Tier.KERNEL, chroma_pu_fused)
