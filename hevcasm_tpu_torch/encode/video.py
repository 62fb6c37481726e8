"""4:2:0 frames, the counterpart of ``hevcasm_tpu.encode.video``: P frames
over luma and both chroma planes, and B frames bi-predicted from two
references.

* Chroma MVs follow HEVC semantics: the luma quarter-pel MV applied at
  chroma resolution is an eighth-pel MV (integer = mv >> 3, fraction =
  mv & 7, both on the two's-complement value) driving the 4-tap filters.
* Chroma qp derives from luma qp by the 4:2:0 mapping (H.265 table 8-10).
* A B frame searches each reference on its own, refines each, and combines
  the int16 (acc >> 6) intermediates as (r0 + r1 + 64) >> 7.

A CUDA frame's luma runs on the kernels: K1 (the search, once per
reference; a B frame under search_impl "grid" scores both references in
one call of B7, and under me_metric "sad" in one call of B9), the P
frame's search, refine and residual as loop._inter_core runs them (K1, B8,
B9, K2, B16, B11, B4), and under inter_impl "fused*" B3
(kernels.bi_fused.bi_ctu_fused_dma, the B frame's two refinements, combine
and residual), else the staged B path with B4 under residual_impl
"pallas".  Chroma is plain PyTorch on every device.  Every path gives the
same integers as hevcasm_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import Tier
from ..ops.pred_inter import pred_uni, pred_uni_16
from ..utils.psnr import psnr
from ..utils.tensor import as_tensor, constant, entry_device
from . import ctu as ctu_mod
from . import motion
from .loop import (EncodeConfig, _inter_core, _op, _pad_reference,
                   _prepare_frame, _residual_pipeline, _search_impl_resolved)

__all__ = ["YuvFrame", "chroma_qp", "encode_inter_frame_yuv", "encode_b_frame_yuv"]


class YuvFrame(NamedTuple):
    """4:2:0 planes: y (H, W), cb/cr (H/2, W/2), uint8."""

    y: torch.Tensor
    cb: torch.Tensor
    cr: torch.Tensor


# H.265 table 8-10: qPc as a function of qPi for 4:2:0.
_QPC = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34, 37: 34,
        38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp: int) -> int:
    if qp < 30:
        return qp
    if qp > 43:
        return qp - 6
    return _QPC[qp]


def _chroma_cfg(cfg: EncodeConfig) -> EncodeConfig:
    """The chroma planes' configuration: chroma qp, 4x4 TUs, half the CTU
    and the range, staged.  Rebuilding it re-runs EncodeConfig's guards, so
    an explicit search_impl 'slab'/'mv'/'dma' raises ValueError here, as in
    hevcasm_tpu."""
    return dataclasses.replace(
        cfg, qp=chroma_qp(cfg.qp), tu=4, ctu=cfg.ctu // 2,
        search_range=cfg.search_range // 2, inter_impl="stages",
    )


def _as_yuv(frame, device=None) -> YuvFrame:
    """The frame's planes as tensors on ``device``, or, with none given, on
    the device an entry point runs on for its luma (utils.tensor.
    entry_device: a tensor's own, else the CUDA card)."""
    if device is None:
        device = entry_device(frame[0])
    return YuvFrame(*(as_tensor(p, device) for p in frame))


def _chroma_mc(plane: torch.Tensor, mv_qpel: torch.Tensor, cfg: EncodeConfig,
               out16: bool = False) -> torch.Tensor:
    """Motion-compensate one chroma plane (H/2, W/2) with the luma
    quarter-pel MVs (n, 2), one per 64x64 luma CTU = one per 32x32 chroma
    block.  Returns (n, ctu/2, ctu/2) uint8 predictions, or with ``out16``
    the int16 (acc >> 6) bi intermediates."""
    taps = 4
    b = cfg.ctu // 2
    rc = cfg.search_range // 2 + 1  # chroma integer reach (+1 for mv >> 3)
    pad_l, pad_r = taps // 2 - 1, taps // 2
    padded = ctu_mod.pad_frame(plane, rc + pad_l, rc + pad_r + 1, rc + pad_l,
                               rc + pad_r + 1)
    gr, gc = ctu_mod.grid_shape(*plane.shape, b)
    pos = motion.ctu_positions(gr, gc, b, plane.device)
    mv_int = mv_qpel >> 3
    frac = mv_qpel & 7
    win = motion.extract_windows(padded, pos + mv_int + rc, b + taps - 1)
    fn = pred_uni_16 if out16 else pred_uni
    return fn(win, frac[:, 1], frac[:, 0], taps)


def _chroma_residual(cur_plane, pred_blocks, cfg: EncodeConfig, intra: bool,
                     tiers: Tier):
    ccfg = _chroma_cfg(cfg)
    src_blocks = ctu_mod.tile_frame(cur_plane, ccfg.ctu)
    rec, nnz, _ = _residual_pipeline(src_blocks, pred_blocks, ccfg, intra,
                                     luma=False, tiers=tiers)
    return ctu_mod.untile_frame(rec, *cur_plane.shape), nnz


def encode_inter_frame_yuv(cur, ref, cfg: EncodeConfig = EncodeConfig(),
                           tiers: Tier = Tier.ALL, device=None) -> dict:
    """One P frame over 4:2:0 planes: luma ME + refine + residual at the
    cfg-selected composition (loop._inter_core), chroma MC from the luma
    MVs, and the chroma residual at 4x4 TUs.

    cur, ref: YuvFrame (or 3-tuples) of uint8 tensors or numpy arrays.  A
    tensor cur.y runs on its own device, numpy planes on ``device``, by
    default the CUDA card (with none, pass device="cpu").  Returns {"recon": YuvFrame, "mvs": (n, 2) int32
    quarter-pel, "nnz": () int32 over the three planes, "psnr_y",
    "psnr_cb", "psnr_cr": () float32}."""
    _chroma_cfg(cfg)  # its guards, before any work
    cur = _as_yuv(cur, None if device is None else entry_device(cur[0], device))
    ref = _as_yuv(ref, cur.y.device)
    cur_y, (ref_y,), src_ctus, pos, grid = _prepare_frame(cfg, cur.y, ref.y)
    rec_y_ctus, mv_qpel, _, nnz_y = _inter_core(
        src_ctus, _pad_reference(ref_y, cfg.search_range), pos, cfg, grid, tiers)
    rec_y = ctu_mod.untile_frame(rec_y_ctus, *cur_y.shape)

    rec_cb, nnz_cb = _chroma_residual(cur.cb, _chroma_mc(ref.cb, mv_qpel, cfg),
                                      cfg, False, tiers)
    rec_cr, nnz_cr = _chroma_residual(cur.cr, _chroma_mc(ref.cr, mv_qpel, cfg),
                                      cfg, False, tiers)
    return {
        "recon": YuvFrame(rec_y, rec_cb, rec_cr),
        "mvs": mv_qpel,
        "nnz": nnz_y + nnz_cb + nnz_cr,
        "psnr_y": psnr(cur_y, rec_y),
        "psnr_cb": psnr(cur.cb, rec_cb),
        "psnr_cr": psnr(cur.cr, rec_cr),
    }


def _b_fused(cfg: EncodeConfig) -> bool:
    """Whether a B frame's luma runs the fused bi kernel (B3)."""
    return (cfg.inter_impl in ("fused", "fused_batched", "fused_dma")
            and cfg.ctu == 64 and cfg.tu == 8)


def _b_frame_luma(src_ctus, ref0_y, ref1_y, pos, grid, cfg: EncodeConfig,
                  qparams=None, tiers: Tier = Tier.ALL, range_flag=None):
    """The B frame's luma: per-reference integer search, exhaustive
    whatever me_strategy says, as in hevcasm_tpu (K1 per reference where
    the slab route resolves, else one full_search_multi call: B7 on a CUDA
    frame with the SSD metric, 64x64 CTUs and R <= 32, else one grid call of
    the metric's scorer, B9 for SAD), then B3 under
    inter_impl 'fused*' (64x64 CTUs, 8x8 TUs) or the staged refine +
    pred_uni_16 + combine + residual, whose refinement is the plain sweep
    whatever refine_impl and fused_refine say, as in hevcasm_tpu.

    qparams None takes cfg's quantizer; the rate controller's (qscale,
    qshift, qoffset, dscale, dshift) 0-d tensors select the traced-qp
    residual (B3's device-q entry, or rate._residual_pipeline_traced_params
    when staged), checked into ``range_flag`` (ops.quantize) where one is
    given.  Returns (rec_y_ctus, [mv0_qpel, mv1_qpel], nnz () int32 or
    None, bits () int32 or None): nnz with cfg's quantizer or B3, bits with
    qparams, as in hevcasm_tpu."""
    r = cfg.search_range
    planes = torch.stack([_pad_reference(ref0_y, r), _pad_reference(ref1_y, r)])
    if _search_impl_resolved(cfg, src_ctus.device) == "slab":
        grid_plane_fn = _op("ssd_grid_plane", tiers)
        mv_ints = [motion.full_search_slab(src_ctus, p, r, grid,
                                           grid_plane_fn=grid_plane_fn)[0]
                   for p in planes]
    else:
        mv_ints, _ = motion.full_search_multi(
            src_ctus, planes, pos, r, grid_fn=motion.grid_metric_fn(cfg.me_metric, tiers),
            grid=grid, joint=False, metric=cfg.me_metric,
            grid_plane_multi_fn=_op("ssd_grid_plane_multi", tiers))
    qargs = ((*cfg.quant_params(False), *cfg.dequant_params()) if qparams is None
             else tuple(qparams))

    if _b_fused(cfg):
        # Both planes stacked by rows; offsets1 carries the lower plane's
        # row offset, a constant made once per plane height and device.
        hp, wp = planes.shape[1:]
        lower = constant((hp, 0), torch.int32, pos.device)
        rec_y_ctus, f0, f1, nnz_tu, bits_tu = _op("bi_ctu_fused_dma", tiers)(
            src_ctus, planes.reshape(2 * hp, wp), pos + mv_ints[0] + r,
            pos + mv_ints[1] + r + lower, *qargs, group=cfg.fused_group,
            range_flag=range_flag)
        mvs = [motion.qpel_mvs(mv_ints[0], f0), motion.qpel_mvs(mv_ints[1], f1)]
        return (rec_y_ctus, mvs, nnz_tu.sum(dtype=torch.int32),
                bits_tu.sum(dtype=torch.int32))

    refine = _op("refine_qpel", Tier.REF)
    mvs, preds16 = [], []
    for plane, mv_int in zip(planes, mv_ints):
        win = motion.extract_windows(plane, pos + mv_int + r, cfg.ctu + motion.TAPS - 1)
        _, frac, _ = refine(src_ctus, win)
        mvs.append(motion.qpel_mvs(mv_int, frac))
        preds16.append(pred_uni_16(win, frac % 4, frac // 4, motion.TAPS).to(torch.int32))
    pred_y = ((preds16[0] + preds16[1] + 64) >> 7).clamp(0, 255).to(torch.uint8)
    if qparams is None:
        rec_y_ctus, nnz_y, _ = _residual_pipeline(src_ctus, pred_y, cfg, intra=False,
                                                  tiers=tiers)
        return rec_y_ctus, mvs, nnz_y, None
    from .rate import _residual_pipeline_traced_params

    rec_y_ctus, bits = _residual_pipeline_traced_params(src_ctus, pred_y, qparams, cfg,
                                                        range_flag=range_flag)
    return rec_y_ctus, mvs, None, bits


def encode_b_frame_yuv(cur, ref0, ref1, cfg: EncodeConfig = EncodeConfig(),
                       tiers: Tier = Tier.ALL, device=None) -> dict:
    """One B frame over 4:2:0 planes: independent integer search against
    both references, quarter-pel refinement of each, the combining mean
    (r0 + r1 + 64) >> 7 on luma and on chroma (with the same MV pair), and
    the residual of each plane.

    cur, ref0, ref1: YuvFrame (or 3-tuples) of uint8 tensors or numpy
    arrays; devices as for encode_inter_frame_yuv.  Returns {"recon": YuvFrame, "mvs0", "mvs1":
    (n, 2) int32 quarter-pel, "nnz": () int32 over the three planes,
    "psnr_y": () float32}."""
    _chroma_cfg(cfg)  # its guards, before any work
    cur = _as_yuv(cur, None if device is None else entry_device(cur[0], device))
    ref0 = _as_yuv(ref0, cur.y.device)
    ref1 = _as_yuv(ref1, cur.y.device)
    cur_y, (ref0_y, ref1_y), src_ctus, pos, grid = _prepare_frame(
        cfg, cur.y, ref0.y, ref1.y)
    rec_y_ctus, (mv0, mv1), nnz_y, _ = _b_frame_luma(
        src_ctus, ref0_y, ref1_y, pos, grid, cfg, tiers=tiers)
    rec_y = ctu_mod.untile_frame(rec_y_ctus, *cur_y.shape)

    def chroma_bi(plane0, plane1, cur_plane):
        p0 = _chroma_mc(plane0, mv0, cfg, out16=True).to(torch.int32)
        p1 = _chroma_mc(plane1, mv1, cfg, out16=True).to(torch.int32)
        pred = ((p0 + p1 + 64) >> 7).clamp(0, 255).to(torch.uint8)
        return _chroma_residual(cur_plane, pred, cfg, False, tiers)

    rec_cb, nnz_cb = chroma_bi(ref0.cb, ref1.cb, cur.cb)
    rec_cr, nnz_cr = chroma_bi(ref0.cr, ref1.cr, cur.cr)
    return {
        "recon": YuvFrame(rec_y, rec_cb, rec_cr),
        "mvs0": mv0,
        "mvs1": mv1,
        "nnz": nnz_y + nnz_cb + nnz_cr,
        "psnr_y": psnr(cur_y, rec_y),
    }
