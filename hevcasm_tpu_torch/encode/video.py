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
"pallas".  A CUDA P frame at 64x64 CTUs codes both chroma planes in one
launch of kernels.chroma_fused.chroma_p_fused (window, 4-tap MC and 4x4
residual of every 32x32 chroma block) when the tiers include KERNEL; the
CPU, tiers=Tier.REF, other CTU sizes, the B frame's chroma and intra chroma
run the plain PyTorch composition (_chroma_mc, _chroma_residual,
_chroma_intra_plane), the golden model.  Every path gives the same
integers as hevcasm_tpu.

The I frame (encode_intra_frame_yuv: loop.encode_intra_frame's luma,
chroma planar/DC/H/V) starts the GOPs: encode_gop_yuv (open loop, IPPP or
IBPBP), and, each reference a reconstruction with the wavefront frame's
luma first, encode_gop_closed_loop (luma), encode_gop_closed_loop_yuv and
encode_gop_closed_loop_yuv_b (encode order I, P2, B1, P4, B3, ...).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import Tier
from ..kernels import chroma_fused
from ..ops.pred_inter import pred_uni, pred_uni_16
from ..ops.pred_intra import filter_flag, pred_intra
from ..utils.psnr import psnr
from ..utils.tensor import as_tensor, constant, entry_device, first_min
from ..utils.trace import span
from . import ctu as ctu_mod
from . import motion
from .intra_wavefront import encode_intra_frame_wavefront
from .loop import (EncodeConfig, _inter_core, _intra_neighbours, _op, _pad_reference,
                   _prepare_frame, _prepare_frames, _prepare_intra_refs, _residual_pipeline,
                   _satd_cost, _search_impl_resolved, encode_inter_frame, encode_intra_frame)

__all__ = ["YuvFrame", "chroma_qp", "encode_inter_frame_yuv", "encode_b_frame_yuv",
           "encode_intra_frame_yuv", "encode_gop_yuv", "encode_gop_closed_loop",
           "encode_gop_closed_loop_yuv", "encode_gop_closed_loop_yuv_b"]


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
    with span("hevcasm.chroma_mc"):
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
    with span("hevcasm.chroma_residual"):
        ccfg = _chroma_cfg(cfg)
        src_blocks = ctu_mod.tile_frame(cur_plane, ccfg.ctu)
        rec, nnz, _ = _residual_pipeline(src_blocks, pred_blocks, ccfg, intra,
                                         luma=False, tiers=tiers)
        return ctu_mod.untile_frame(rec, *cur_plane.shape), nnz


def _uses_chroma_kernel(cfg: EncodeConfig, tiers: Tier, plane: torch.Tensor) -> bool:
    """Whether a P frame's chroma runs kernels.chroma_fused.chroma_p_fused:
    tiers with KERNEL, CUDA planes and 64x64 luma CTUs (the 32x32 chroma
    blocks at 4x4 TUs that _chroma_cfg gives)."""
    return bool(tiers & Tier.KERNEL) and plane.is_cuda and cfg.ctu == 2 * chroma_fused.BLOCK


def encode_inter_frame_yuv(cur, ref, cfg: EncodeConfig = EncodeConfig(),
                           tiers: Tier = Tier.ALL, device=None) -> dict:
    """One P frame over 4:2:0 planes: luma ME + refine + residual at the
    cfg-selected composition (loop._inter_core), chroma MC from the luma
    MVs, and the chroma residual at 4x4 TUs.  Chroma runs in one launch of
    chroma_p_fused (both planes) where _uses_chroma_kernel says so, else
    the plain _chroma_mc and _chroma_residual a plane; both give the same
    integers.

    cur, ref: YuvFrame (or 3-tuples) of uint8 tensors or numpy arrays.  A
    tensor cur.y runs on its own device, numpy planes on ``device``, by
    default the CUDA card (with none, pass device="cpu").  Returns {"recon": YuvFrame, "mvs": (n, 2) int32
    quarter-pel, "nnz": () int32 over the three planes, "psnr_y",
    "psnr_cb", "psnr_cr": () float32}."""
    with span("hevcasm.inter_yuv"):
        _chroma_cfg(cfg)  # its guards, before any work
        cur = _as_yuv(cur, None if device is None else entry_device(cur[0], device))
        ref = _as_yuv(ref, cur.y.device)
        with span("hevcasm.luma"):
            cur_y, (ref_y,), src_ctus, pos, grid = _prepare_frame(cfg, cur.y, ref.y)
            rec_y_ctus, mv_qpel, _, nnz_y = _inter_core(
                src_ctus, _pad_reference(ref_y, cfg.search_range), pos, cfg, grid, tiers)
            rec_y = ctu_mod.untile_frame(rec_y_ctus, *cur_y.shape)

        with span("hevcasm.chroma"):
            if _uses_chroma_kernel(cfg, tiers, cur.cb):
                rec_cb, nnz_cb, rec_cr, nnz_cr = _op("chroma_p_fused", tiers)(
                    cur.cb, cur.cr, ref.cb, ref.cr, mv_qpel, cfg)
            else:
                rec_cb, nnz_cb = _chroma_residual(cur.cb, _chroma_mc(ref.cb, mv_qpel, cfg),
                                                  cfg, False, tiers)
                rec_cr, nnz_cr = _chroma_residual(cur.cr, _chroma_mc(ref.cr, mv_qpel, cfg),
                                                  cfg, False, tiers)
        with span("hevcasm.psnr"):
            psnrs = psnr(cur_y, rec_y), psnr(cur.cb, rec_cb), psnr(cur.cr, rec_cr)
        return {
            "recon": YuvFrame(rec_y, rec_cb, rec_cr),
            "mvs": mv_qpel,
            "nnz": nnz_y + nnz_cb + nnz_cr,
            "psnr_y": psnrs[0],
            "psnr_cb": psnrs[1],
            "psnr_cr": psnrs[2],
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


def _chroma_intra_plane(plane: torch.Tensor, cfg: EncodeConfig, tiers: Tier = Tier.ALL):
    """Chroma intra of one plane: planar, DC, horizontal or vertical (modes
    0, 1, 10, 26) per block of half the CTU, decided by SATD from open-loop
    neighbours, each mode on the filtered references where filter_flag(mode,
    n) says so (strong smoothing at n = 32 included), as hevcasm_tpu does;
    then the chroma TU pipeline.  Returns (recon plane, nnz () int32)."""
    ccfg = _chroma_cfg(cfg)
    n = ccfg.ctu
    blocks = ctu_mod.tile_frame(plane, n)
    refs_plain, refs_filt = _prepare_intra_refs(*_intra_neighbours(plane, n), n, ccfg)
    preds, costs = [], []
    for mode in (0, 1, 10, 26):
        p = pred_intra(mode, *(refs_filt if filter_flag(mode, n) else refs_plain), n,
                       filter_edge=False)
        preds.append(p)
        costs.append(_satd_cost(blocks, p))
    best, _ = first_min(torch.stack(costs, dim=1))
    pred = torch.gather(torch.stack(preds, dim=1), 1,
                        best.long()[:, None, None, None].expand(-1, 1, n, n))[:, 0]
    rec, nnz, _ = _residual_pipeline(blocks, pred, ccfg, intra=True, luma=False, tiers=tiers)
    return ctu_mod.untile_frame(rec, *plane.shape), nnz


def encode_intra_frame_yuv(cur, cfg: EncodeConfig = EncodeConfig(), tiers: Tier = Tier.ALL,
                           device=None) -> dict:
    """I frame over 4:2:0 planes: luma by encode_intra_frame (35 modes,
    open loop), each chroma plane by _chroma_intra_plane (planar, DC, H and
    V by SATD; hevcasm_tpu's docstring says DC only, its code decides among
    the four).

    cur: YuvFrame (or 3-tuple) of uint8 tensors or numpy arrays; devices
    as for encode_inter_frame_yuv.  Returns {"recon": YuvFrame, "nnz": ()
    int32 over the three planes, "psnr_y": () float32}."""
    _chroma_cfg(cfg)  # its guards, before any work
    cur = _as_yuv(cur, None if device is None else entry_device(cur[0], device))
    out_y = encode_intra_frame(cur.y, cfg, tiers)
    rec_cb, nnz_cb = _chroma_intra_plane(cur.cb, cfg, tiers)
    rec_cr, nnz_cr = _chroma_intra_plane(cur.cr, cfg, tiers)
    return {"recon": YuvFrame(out_y["recon"], rec_cb, rec_cr),
            "nnz": out_y["nnz"] + nnz_cb + nnz_cr, "psnr_y": out_y["psnr_db"]}


def _as_yuv_gop(frames, device) -> YuvFrame:
    """A GOP's planes (leading time axis) as tensors on its entry device,
    checked: (T, H, W) luma and (T, H/2, W/2) chroma, uint8."""
    frames = _as_yuv(frames, None if device is None else entry_device(frames[0], device))
    y = frames.y
    if (y.dim() != 3 or any(p.dtype != torch.uint8 for p in frames) or any(
            tuple(p.shape) != (y.shape[0], y.shape[1] // 2, y.shape[2] // 2)
            for p in frames[1:])):
        raise ValueError("frames must be a YuvFrame of (T, H, W) luma and (T, H/2, W/2) "
                         "chroma uint8 planes")
    return frames


def _stack_yuv(frames) -> YuvFrame:
    return YuvFrame(*(torch.stack(planes) for planes in zip(*frames)))


def encode_gop_yuv(frames, cfg: EncodeConfig = EncodeConfig(), b_frames: bool = False,
                   tiers: Tier = Tier.ALL, device=None) -> dict:
    """Encode a 4:2:0 GOP in open loop, frame 0 by encode_intra_frame_yuv.

    b_frames=False: IPPP, frame t > 0 a P frame from source frame t - 1.
    b_frames=True: IBPBP, each odd frame that has a successor a B frame
    bi-predicted from the source frames around it, the others P frames from
    source frame t - 1.

    frames: YuvFrame of (T, H, W) luma and (T, H/2, W/2) chroma uint8
    tensors or numpy arrays; devices as for encode_inter_frame_yuv.
    Returns {"recon": YuvFrame of stacks, "psnr_y": () float32 over the
    GOP's luma, "nnz": int, read from the card once}."""
    _chroma_cfg(cfg)
    frames = _as_yuv_gop(frames, device)
    t_total = frames.y.shape[0]

    def at(t):
        return YuvFrame(*(p[t] for p in frames))

    results = [encode_intra_frame_yuv(at(0), cfg, tiers)]
    for t in range(1, t_total):
        if b_frames and t % 2 == 1 and t + 1 < t_total:
            results.append(encode_b_frame_yuv(at(t), at(t - 1), at(t + 1), cfg, tiers))
        else:
            results.append(encode_inter_frame_yuv(at(t), at(t - 1), cfg, tiers))
    rec = _stack_yuv([r["recon"] for r in results])
    nnz = torch.stack([r["nnz"] for r in results]).sum(dtype=torch.int64)
    return {"recon": rec, "psnr_y": psnr(frames.y, rec.y), "nnz": int(nnz)}


def _closed_loop_seed(frames: YuvFrame, cfg: EncodeConfig, tiers: Tier):
    """The closed-loop GOPs' I frame: the wavefront luma and open-loop
    chroma intra.  Returns (recon YuvFrame, psnr_y)."""
    with span("hevcasm.intra"):
        intra_y = encode_intra_frame_wavefront(frames.y[0], cfg, tiers)
        with span("hevcasm.intra_chroma"):
            rec_cb = _chroma_intra_plane(frames.cb[0], cfg, tiers)[0]
            rec_cr = _chroma_intra_plane(frames.cr[0], cfg, tiers)[0]
        return YuvFrame(intra_y["recon"], rec_cb, rec_cr), intra_y["psnr_db"]


def encode_gop_closed_loop_yuv(frames, cfg: EncodeConfig = EncodeConfig(),
                               tiers: Tier = Tier.ALL, device=None) -> dict:
    """Closed-loop 4:2:0 IPPP GOP: frame 0 intra (the wavefront luma,
    open-loop chroma), every P frame predicted on all three planes from the
    previous frame's *reconstruction* (encode_inter_frame_yuv chained), the
    conforming chain.

    frames as for encode_gop_yuv.  Returns {"recon": YuvFrame of stacks,
    "psnr_y": (T,) float32 a frame}."""
    with span("hevcasm.gop_closed_yuv"):
        _chroma_cfg(cfg)
        frames = _as_yuv_gop(frames, device)
        prev, psnr0 = _closed_loop_seed(frames, cfg, tiers)
        recs, psnrs = [prev], [psnr0]
        for t in range(1, frames.y.shape[0]):
            out = encode_inter_frame_yuv(YuvFrame(*(p[t] for p in frames)), prev, cfg, tiers)
            prev = out["recon"]
            recs.append(prev)
            psnrs.append(out["psnr_y"])
        with span("hevcasm.gop_stack"):
            return {"recon": _stack_yuv(recs), "psnr_y": torch.stack(psnrs)}


def encode_gop_closed_loop_yuv_b(frames, cfg: EncodeConfig = EncodeConfig(),
                                 tiers: Tier = Tier.ALL, device=None) -> dict:
    """Closed-loop 4:2:0 GOP with B frames.  Display order I B P B P ...
    (an odd frame count of at least 3, ending on P); encode order I, P2,
    B1, P4, B3, ...: each P is predicted from the previous P's (or the I
    frame's) reconstruction, each B bi-predicts from the reconstructions
    around it.

    frames as for encode_gop_yuv.  Returns {"recon": YuvFrame of stacks in
    display order, "psnr_y": (T,) float32 a frame}.  An even frame count or
    one below 3 raises ValueError (hevcasm_tpu stops on a bare assert)."""
    _chroma_cfg(cfg)
    frames = _as_yuv_gop(frames, device)
    t_total = frames.y.shape[0]
    if t_total % 2 != 1 or t_total < 3:
        raise ValueError(f"an IBPBP GOP needs an odd frame count >= 3, got {t_total}")
    prev, psnr0 = _closed_loop_seed(frames, cfg, tiers)
    recs, psnrs = [prev], [psnr0]
    for t in range(1, t_total, 2):
        out_p = encode_inter_frame_yuv(YuvFrame(*(p[t + 1] for p in frames)), prev, cfg, tiers)
        out_b = encode_b_frame_yuv(YuvFrame(*(p[t] for p in frames)), prev, out_p["recon"],
                                   cfg, tiers)
        prev = out_p["recon"]
        recs += [out_b["recon"], prev]
        psnrs += [out_b["psnr_y"], out_p["psnr_y"]]
    return {"recon": _stack_yuv(recs), "psnr_y": torch.stack(psnrs)}


def encode_gop_closed_loop(frames_y, cfg: EncodeConfig, num_frames: int,
                           tiers: Tier = Tier.ALL, device=None) -> dict:
    """Closed-loop IPPP luma GOP: frame 0 by the wavefront intra encoder,
    each P frame predicted from the previous frame's *reconstruction*
    (encode_inter_frame chained), the conforming chain, I frame included.

    frames_y: (T, H, W) uint8 tensor or numpy array; the first num_frames
    are coded.  Returns {"recon": (num_frames, H, W) uint8, "psnr_db":
    (num_frames,) float32 a frame}."""
    frames_y = _prepare_frames(frames_y, device)
    intra = encode_intra_frame_wavefront(frames_y[0], cfg, tiers)
    recs, psnrs = [intra["recon"]], [intra["psnr_db"]]
    for t in range(1, min(num_frames, frames_y.shape[0])):
        out = encode_inter_frame(frames_y[t], recs[-1], cfg, tiers)
        recs.append(out["recon"])
        psnrs.append(out["psnr_db"])
    return {"recon": torch.stack(recs), "psnr_db": torch.stack(psnrs)}
