"""Rate control, the counterpart of ``hevcasm_tpu.encode.rate``: per-frame
qp adaptation toward a bit budget.

qp is a 0-d int32 tensor on the frame's device from the first frame of a
GOP to the last, and nothing in the GOP's loop reads the card from the
host:

* quant_params_traced derives the five quantizer parameters from it by
  table gathers and shifts on that device;
* the fused inter_impl values take them as tensors: K2 (``fused_dma``),
  B16 (``fused``, ``fused_batched``) and, on a B frame, B3 launch their
  device-q C entries (kernels.inter_fused, kernels.bi_fused), which read
  the parameters from an int32[5] on the card, and the controller takes the
  kernels' per-TU Exp-Golomb bit counts;
* the staged path refines with B11 under ``fused_refine`` (else the plain
  sweep), then runs the plain residual with the tensor parameters
  (residual_impl is ignored, as in hevcasm_tpu);
* the quantizer's asserted ranges are checked on the device into one range
  flag (ops.quantize), which the GOP reads once after its last frame and
  raises on: the counterpart of hevcasm_tpu's checkify.

Bit cost is the Exp-Golomb-style proxy 0 for a zero level, else
2 * floor(log2 |q|) + 3 (ops.residual.bits_egk).  The controller is the
per-frame proportional update, in float32 and in hevcasm_tpu's order of
operations:

  qp[t+1] = clip(qp[t] + clip(round(1.5 * log2(max(bits, 1) / target)), -6, 6),
                 qp_min, qp_max)

with round half to even.  hevcasm_tpu runs the GOP as one lax.scan; here
it is a Python loop whose frames only enqueue work on the card.
"""

from __future__ import annotations

import torch

from ..config import Tier
from ..ops.quantize import raise_on_flag, range_flag
from ..ops.residual import bits_egk, residual_levels
from ..utils.psnr import psnr
from ..utils.tensor import as_tensor, constant, entry_device
from . import ctu as ctu_mod
from . import motion
from .loop import (DEQUANT_SCALES, QUANT_SCALES, EncodeConfig, _integer_search, _op,
                   _pad_reference, _prepare_frame)

__all__ = ["quant_params_traced", "bits_estimate",
           "encode_inter_frame_traced_qp", "encode_b_frame_traced_qp",
           "encode_gop_rate_controlled"]

_FUSED = ("fused", "fused_batched", "fused_dma")


def quant_params_traced(qp, tu_log2: int, intra: bool = False):
    """Tensor-qp version of EncodeConfig.quant_params/dequant_params.

    qp: an integer tensor (or an int) on any device.  Returns (qscale,
    qshift, qoffset, dscale, dshift) as int32 tensors of qp's shape on its
    device (hevcasm_tpu gives qoffset and dshift as ints), computed there
    with no host read."""
    qp = torch.as_tensor(qp).to(torch.int32)
    rem, per = (qp % 6).long(), qp // 6
    qscale = torch.take(constant(QUANT_SCALES, torch.int32, qp.device), rem)
    qshift = per + (21 - tu_log2)
    qoffset = torch.full_like(qp, (171 if intra else 85) << 7)
    dscale = torch.take(constant(DEQUANT_SCALES, torch.int32, qp.device), rem) << per
    dshift = torch.full_like(qp, tu_log2 - 1)
    return qscale, qshift, qoffset, dscale, dshift


def bits_estimate(levels: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb-style bit-cost proxy of quantized levels: a 0-d int32
    sum, the same per-level count the fused kernels make."""
    return bits_egk(as_tensor(levels)).sum(dtype=torch.int32)


def _residual_pipeline_traced_params(src_blocks, pred_blocks, qparams,
                                     cfg: EncodeConfig, range_flag=None):
    """The cfg-shaped plain residual pipeline with tensor quantizer
    parameters, checked into ``range_flag`` (ops.quantize.quantize); returns
    (rec, bits () int32)."""
    rec, levels, _ = residual_levels(src_blocks, pred_blocks, *qparams, tu=cfg.tu,
                                     range_flag=range_flag)
    return rec, bits_estimate(levels)


def _residual_pipeline_traced(src_blocks, pred_blocks, qp, cfg: EncodeConfig,
                              intra: bool, range_flag=None):
    """The plain residual pipeline at a tensor qp; returns (rec, bits)."""
    qparams = quant_params_traced(qp, cfg.tu_log2, intra)
    return _residual_pipeline_traced_params(src_blocks, pred_blocks, qparams, cfg,
                                            range_flag)


def _as_qp(qp, device) -> torch.Tensor:
    """qp as a 0-d int32 tensor on ``device``; an int is made there with no
    copy from the host."""
    if isinstance(qp, torch.Tensor):
        return qp.to(device, torch.int32).reshape(())
    return torch.full((), int(qp), dtype=torch.int32, device=device)


def _inter_frame(cur, ref, qp, cfg: EncodeConfig, tiers: Tier, flag) -> dict:
    """encode_inter_frame_traced_qp, its range checks into ``flag``."""
    if cfg.pu_decision or cfg.tu_sizes:
        # The traced-qp path runs the fixed CTU/TU geometry; silently
        # dropping a requested RDO decision would encode something else.
        raise ValueError("encode_inter_frame_traced_qp does not compose with "
                         "pu_decision/tu_sizes (use encode_inter_frame at fixed qp)")
    cur, (ref,), src_ctus, pos, grid = _prepare_frame(cfg, cur, ref)
    qp = _as_qp(qp, cur.device)
    r = cfg.search_range
    ref_padded = _pad_reference(ref, r)
    mv_int, _ = _integer_search(src_ctus, ref_padded, pos, cfg, grid, tiers)
    start = (pos + mv_int + r).to(torch.int32).contiguous()
    if cfg.inter_impl in _FUSED:
        qparams = quant_params_traced(qp, cfg.tu_log2, False)
        if cfg.inter_impl == "fused_dma":
            rec_ctus, _, _, _, bits_tu = _op("inter_ctu_fused_dma", tiers)(
                src_ctus, ref_padded, start, *qparams, group=cfg.fused_group,
                range_flag=flag)
        else:
            win = motion.extract_windows(ref_padded, start, cfg.ctu + motion.TAPS - 1)
            rec_ctus, _, _, _, bits_tu = _op("inter_ctu_fused", tiers)(
                src_ctus, win, *qparams, range_flag=flag)
        bits = bits_tu.sum(dtype=torch.int32)
    else:
        win = motion.extract_windows(ref_padded, start, cfg.ctu + motion.TAPS - 1)
        refine = (_op("refine_quarter_pel_fused", tiers) if cfg.fused_refine
                  else _op("refine_qpel", Tier.REF))
        pred, _, _ = refine(src_ctus, win)
        rec_ctus, bits = _residual_pipeline_traced(src_ctus, pred, qp, cfg, False, flag)
    recon = ctu_mod.untile_frame(rec_ctus, *cur.shape)
    return {"recon": recon, "bits": bits, "psnr_db": psnr(cur, recon), "qp": qp}


def _b_frame(cur, ref0, ref1, qp, cfg: EncodeConfig, tiers: Tier, flag) -> dict:
    """encode_b_frame_traced_qp, its range checks into ``flag``."""
    from .video import _b_frame_luma

    if cfg.pu_decision or cfg.tu_sizes:
        raise ValueError("encode_b_frame_traced_qp does not compose with "
                         "pu_decision/tu_sizes")
    cur, (ref0, ref1), src_ctus, pos, grid = _prepare_frame(cfg, cur, ref0, ref1)
    qp = _as_qp(qp, cur.device)
    qparams = quant_params_traced(qp, cfg.tu_log2, False)
    rec_ctus, _, _, bits = _b_frame_luma(src_ctus, ref0, ref1, pos, grid, cfg,
                                         qparams=qparams, tiers=tiers, range_flag=flag)
    recon = ctu_mod.untile_frame(rec_ctus, *cur.shape)
    return {"recon": recon, "bits": bits, "psnr_db": psnr(cur, recon), "qp": qp}


def _checked_call(frame_fn, cur, *args, checked: bool, device) -> dict:
    """One frame with a range flag of its own, read at its end if checked."""
    cur = as_tensor(cur, entry_device(cur, device))
    flag = range_flag(cur.device)
    out = frame_fn(cur, *args, flag)
    if checked:
        raise_on_flag(flag)
    return out


def encode_inter_frame_traced_qp(cur, ref, qp, cfg: EncodeConfig = EncodeConfig(),
                                 checked: bool = False, tiers: Tier = Tier.ALL,
                                 device=None) -> dict:
    """encode_inter_frame at a qp held in a tensor: the cfg-selected search,
    then K2 (fused_dma) or B16 (fused, fused_batched) through their
    device-q entries, else the staged refine (B11 under fused_refine) and
    the plain residual.  cur, ref and devices as for encode_inter_frame; qp
    an int or an integer tensor.  With ``checked`` the call reads its range
    flag once at its end and raises ValueError ("outside") if the
    quantizer's parameters left their asserted ranges.

    Returns {"recon": (H, W) uint8, "bits": () int32 Exp-Golomb bit
    proxy, "psnr_db": () float32, "qp": () int32}, tensors on the frame's
    device."""
    return _checked_call(_inter_frame, cur, ref, qp, cfg, tiers, checked=checked,
                         device=device)


def encode_b_frame_traced_qp(cur, ref0, ref1, qp, cfg: EncodeConfig = EncodeConfig(),
                             checked: bool = False, tiers: Tier = Tier.ALL,
                             device=None) -> dict:
    """The B frame's luma (video._b_frame_luma) at a qp held in a tensor:
    B3 through its device-q entry under a fused inter_impl, else the staged
    bi path with the plain residual.  Arguments and result as for
    encode_inter_frame_traced_qp."""
    return _checked_call(_b_frame, cur, ref0, ref1, qp, cfg, tiers, checked=checked,
                         device=device)


def _qp_update(qp, bits, frame_target, qp_min: int, qp_max: int) -> torch.Tensor:
    # Damped proportional update in the log-bit domain: 1.5 steps an octave,
    # at most 6 a frame, as in hevcasm_tpu (float32, its order of operations).
    err = torch.log2(bits.to(torch.float32).clamp_min(1.0) / frame_target)
    step = torch.round(1.5 * err).to(torch.int32).clamp(-6, 6)
    return (qp + step).clamp(qp_min, qp_max)


def _stack(items: list, empty_shape: tuple, dtype, device) -> torch.Tensor:
    return torch.stack(items) if items else torch.empty(empty_shape, dtype=dtype,
                                                        device=device)


def _gop_rc_body(frames, target, qp, cfg: EncodeConfig, qp_min: int, qp_max: int,
                 b_frames: bool, tiers: Tier, flag) -> dict:
    """The GOP's loop: frames (T, H, W) uint8, target () float32 and qp ()
    int32 on one device; range checks into ``flag``.  It reads nothing of
    the card from the host."""
    dev = frames.device
    frame_shape = tuple(frames.shape[1:])
    prev = frames[0]
    recs, bits, qps, psnrs = [], [], [], []
    if not b_frames:
        for cur in frames[1:]:
            out = _inter_frame(cur, prev, qp, cfg, tiers, flag)
            recs.append(out["recon"])
            bits.append(out["bits"])
            qps.append(qp)
            psnrs.append(out["psnr_db"])
            prev, qp = out["recon"], _qp_update(qp, out["bits"], target, qp_min, qp_max)
    else:
        # IBPBP...: display order B(2k+1), P(2k+2); encode order P first
        # (from the previous P/I recon), then B bi-predicted from the two
        # surrounding recons; one qp serves the pair and updates on the
        # pair's bits against twice the per-frame target.
        for k in range((frames.shape[0] - 1) // 2):
            outp = _inter_frame(frames[2 * k + 2], prev, qp, cfg, tiers, flag)
            outb = _b_frame(frames[2 * k + 1], prev, outp["recon"], qp, cfg, tiers, flag)
            bits2 = outp["bits"] + outb["bits"]
            recs += [outb["recon"], outp["recon"]]
            psnrs += [outb["psnr_db"], outp["psnr_db"]]
            bits.append(bits2)
            qps.append(qp)
            prev, qp = outp["recon"], _qp_update(qp, bits2, 2.0 * target, qp_min, qp_max)
    return {"recon": _stack(recs, (0, *frame_shape), torch.uint8, dev),
            "bits": _stack(bits, (0,), torch.int32, dev),
            "qp": _stack(qps, (0,), torch.int32, dev),
            "psnr_db": _stack(psnrs, (0,), torch.float32, dev)}


def encode_gop_rate_controlled(frames, target_bits_per_frame, qp0,
                               cfg: EncodeConfig = EncodeConfig(), qp_min: int = 10,
                               qp_max: int = 49, b_frames: bool = False,
                               tiers: Tier = Tier.ALL, device=None) -> dict:
    """Closed-loop GOP with per-frame proportional qp control.

    frames (T, H, W) uint8, a tensor or numpy array (a numpy array goes to
    ``device``, by default the CUDA card, in one copy before the loop);
    frame 0 is the initial reference, uncoded (the caller codes it intra).
    b_frames=False codes IPPP; b_frames=True display-order IBPBP... (odd T,
    else ValueError): each P from the previous P/I recon, each B
    bi-predicted from the two surrounding recons, one qp a B/P pair updated
    on the pair's bits.  The inter path is cfg's, with qp on the device
    (module docstring); target_bits_per_frame and qp0 are numbers or 0-d
    tensors.  The quantizer's asserted ranges are checked on the device
    and read once after the last frame: a qp that leaves them raises
    ValueError ("outside").

    Returns {"recon": (T-1, H, W) uint8 in display order, "bits" and "qp"
    int32 a coded frame (a B/P pair with b_frames), "psnr_db" float32 a
    frame}, tensors on the frames' device.
    """
    frames = as_tensor(frames, entry_device(frames, device))
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be (T, H, W) uint8, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if b_frames and frames.shape[0] % 2 == 0:
        raise ValueError(f"a b_frames GOP needs an odd frame count (ends on P), "
                         f"got {frames.shape[0]}")
    dev = frames.device
    if isinstance(target_bits_per_frame, torch.Tensor):
        target = target_bits_per_frame.to(dev, torch.float32).reshape(())
    else:
        target = torch.full((), float(target_bits_per_frame), dtype=torch.float32,
                            device=dev)
    flag = range_flag(dev)
    out = _gop_rc_body(frames, target.clamp_min(1.0), _as_qp(qp0, dev), cfg, qp_min, qp_max,
                       b_frames, tiers, flag)
    raise_on_flag(flag)
    return out
