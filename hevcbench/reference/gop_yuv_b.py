"""The closed-loop 4:2:0 IBPBP GOP, the reference's side of
../entries/gop_yuv_b.py, in plain PyTorch from H.265's equations.

Display order I B P B ... P (an odd frame count of at least 3); encode
order I, P2, B1, P4, B3, ...: the I frame as ``Reference.intra_seed_yuv``
codes it, each P frame from the previous anchor's (P or I) reconstruction
as ``Reference.inter_yuv`` codes it, and each B frame bi-predicted from the
reconstructions of the anchors before and after it in display order.

The B frame, by the encoder's stated rules: against each reference on its
own, the exhaustive integer SSD search over [-R, R]^2 (first minimum in
row-major [dy, dx] order) and the quarter-pel refinement by QPEL_SCORE
(first minimum in yf * 4 + xf order), as a P frame's; each chroma plane
takes each CTU's luma MV as an eighth-pel MV of its 32x32 block.  Each
reference's prediction is kept as its 14-bit intermediate, the
interpolation's second pass shifted by shift2 = 6 (8.5.3.3.3.1, 8-bit:
shift1 = 0), and the two are combined by default weighted sample
prediction (8.5.3.3.4.2): Clip3(0, 255, (p0 + p1 + offset2) >> shift2) with
shift2 = 15 - 8 = 7, offset2 = 64.  At 8 bits both passes' values fit 16
bits, so no store wraps.  The residual: 8x8 luma TUs at the configuration's
QP, 4x4 chroma TUs at its 4:2:0 chroma QP (table 8-10)."""

from __future__ import annotations

import torch

from . import ops
from .encoder import chroma_qp


def _bi_luma(ref, cur: torch.Tensor, refs):
    """The B frame's luma: each reference searched and refined on its own,
    the two 14-bit predictions combined, the residual coded.  Returns
    (recon (H, W) int64, [mv0, mv1] quarter-pel (n, 2) int64)."""
    b, r = ref.ctu, ref.r
    h, w = cur.shape
    src = ops.tile(cur, b)
    pos = ops.block_positions(h, w, b, cur.device)
    preds, mvs = [], []
    for plane in refs:
        padded = ops.edge_pad(plane, r + 3, r + 4, r + 3, r + 4)
        chunk = 512
        mv_int = torch.cat([
            ops.ssd_search(src[c:c + chunk],
                           ops.windows(padded, pos[c:c + chunk] + 3, b + 2 * r), r)[0]
            for c in range(0, src.shape[0], chunk)])
        win = ops.windows(padded, pos + mv_int + r, b + 7)
        _, frac = ops.quarter_pel(src, win)
        preds.append(ops.interpolate(win, frac % 4, frac // 4, ops.LUMA_FILTER) >> 6)
        mvs.append(mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1))
    pred = ((preds[0] + preds[1] + 64) >> 7).clamp(0, 255)
    rec, _ = ops.code_residual(src, pred, ref.qp, ref.tu, False, ref.dtype)
    return ops.untile(rec, h, w), mvs


def _bi_chroma(ref, cur: torch.Tensor, refs, mvs):
    """One chroma plane of the B frame: each reference's 4-tap prediction
    at its luma MV as an eighth-pel MV (integer part mv >> 3, fraction mv &
    7), the two 14-bit predictions combined, the residual coded at 4x4 TUs.
    Returns the recon (H/2, W/2) int64."""
    b = ref.ctu // 2
    rc = ref.r // 2 + 1                  # chroma integer reach, +1 for mv >> 3
    h, w = cur.shape
    pos = ops.block_positions(h, w, b, cur.device)
    preds = []
    for plane, mv in zip(refs, mvs):
        padded = ops.edge_pad(plane, rc + 1, rc + 3, rc + 1, rc + 3)
        win = ops.windows(padded, pos + (mv >> 3) + rc, b + 3)
        frac = mv & 7
        preds.append(ops.interpolate(win, frac[:, 1], frac[:, 0], ops.CHROMA_FILTER) >> 6)
    pred = ((preds[0] + preds[1] + 64) >> 7).clamp(0, 255)
    rec, _ = ops.code_residual(ops.tile(cur, b), pred, chroma_qp(ref.qp), 4, False, ref.dtype)
    return ops.untile(rec, h, w)


def _b_frame(ref, cur, ref0, ref1) -> dict:
    """One 4:2:0 B frame from the reconstructions before (ref0) and after
    (ref1) it: {"recon": (y, cb, cr) uint8, "psnr_y"}."""
    cur = [p.to(torch.int64) for p in cur]
    refs = list(zip(*([p.to(torch.int64) for p in r] for r in (ref0, ref1))))
    rec_y, mvs = _bi_luma(ref, cur[0], refs[0])
    recs = [rec_y] + [_bi_chroma(ref, cur[c], refs[c], mvs) for c in (1, 2)]
    return {"recon": tuple(p.to(torch.uint8) for p in recs), "psnr_y": ops.psnr(cur[0], rec_y)}


def gop_yuv_b(ref, frames) -> dict:
    """frames: (y, cb, cr) stacks of an odd number of frames, display order
    I B P B ... P.  Returns {"recon": (y, cb, cr) stacks in display order,
    "psnr_y": [T floats]}."""
    count = frames[0].shape[0]
    if count % 2 != 1 or count < 3:
        raise ValueError(f"an IBPBP GOP needs an odd frame count >= 3, got {count}")

    def at(t):
        return tuple(p[t] for p in frames)

    out = ref.intra_seed_yuv(at(0))
    recs, psnrs = [out["recon"]], [out["psnr_y"]]
    for t in range(1, count, 2):
        anchor = ref.inter_yuv(at(t + 1), recs[-1])
        bi = _b_frame(ref, at(t), recs[-1], anchor["recon"])
        recs += [bi["recon"], anchor["recon"]]
        psnrs += [bi["psnr_y"], anchor["psnr_y"]]
    return {"recon": tuple(torch.stack(p) for p in zip(*recs)), "psnr_y": psnrs}
