"""The 4:2:0 RD P frame, the reference's side of ../entries/inter_yuv_rd.py,
in plain PyTorch from the encoder's stated rules and H.265's equations.

Luma, each 64x64 CTU (CTUs in blocks, so that the search grids fit):

* the PU decision: each layout of ``pu_layouts`` tiles the CTU into equal
  PUs in raster order (2Nx2N one 64x64, 2NxN two 64 wide and 32 high, Nx2N
  two 32 wide and 64 high, NxN four 32x32, quarter sixteen 16x16, eighth
  sixty-four 8x8).  Each PU takes the exhaustive integer SSD search over
  [-R, R]^2 against the edge-extended reference, the first minimum in
  row-major [dy, dx] order; a PU's SSD at a displacement is the sum of its
  8x8 tiles' SSDs there, each from an FFT correlation in float64, exact
  after rounding (as ``ops.ssd_search``).  A layout costs the sum of its
  PUs' minima plus lambda times its number of PUs, lambda = round(0.85 *
  2^((qp - 12) / 3)) (Python's round, at least 1), and each CTU takes the
  first minimum in ``pu_layouts`` order;
* each PU of the chosen layout is refined to quarter-pel at its integer
  MV: the 16 fractions (yf, xf) in 0..3 scored by sum |acc - (src << 12)|
  >> 4 over the PU's samples, the first minimum in yf * 4 + xf order; the
  PU is predicted at it (8.5.3.3.3, as ``ops.quarter_pel`` a block);
* the TU decision: the residual at each TU size of ``tu_sizes`` (the DCT,
  HM's quantizer and the standard's scaling at that size, inter), costed
  SSD(source, reconstruction) + lambda * bits, bits the sum over the CTU's
  levels of 2 floor(log2 |l|) + 3 (0 for l = 0), the first minimum in
  ``tu_sizes`` order; luma's nnz counts the chosen size's coded TUs (a TU
  with a non-zero level).

Chroma: each 4x4 chroma tile (the chroma of an 8x8 luma tile) is predicted
at the quarter-pel luma MV of the PU that holds it, as an eighth-pel chroma
MV (integer part mv >> 3, fraction mv & 7, the 4-tap filters), and coded at
4x4 TUs and the chroma QP of table 8-10; its nnz counts non-zero levels.

Outputs: "recon" (y, cb, cr), "mvs" the MV field (n, 8, 8, 2) quarter-pel
(each 8x8 luma tile's PU MV), "nnz" over the three planes, and the three
PSNRs."""

from __future__ import annotations

import torch

from . import ops
from .encoder import chroma_qp

SIX = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter", "eighth")
TUS = (4, 8, 16, 32)
#: The RD coding tools this side codes, beside the reference's FIELDS.
FIELDS = {"pu_decision": (True,), "pu_layouts": (SIX,), "tu_sizes": (TUS,)}

CTU = 64
BASE = 8                      # the smallest PU side: every PU is a union of 8x8 tiles
K = CTU // BASE
#: Each layout's PU (height, width).
PU_SIZE = {"2Nx2N": (64, 64), "2NxN": (32, 64), "Nx2N": (64, 32), "NxN": (32, 32),
           "quarter": (16, 16), "eighth": (8, 8)}
#: CTUs a block of the search: its tiles' grids take ~2 MB a CTU at R = 32.
CHUNK = 64


def _lambda(qp: int) -> int:
    return max(1, int(round(0.85 * 2.0 ** ((qp - 12) / 3.0))))


def _ssd_grids(src: torch.Tensor, win: torch.Tensor, r: int) -> torch.Tensor:
    """The SSD of each (n, b, b) block against every displacement of its
    (n, b + 2r, b + 2r) window, as ops.ssd_search computes it: (n, 2r + 1,
    2r + 1) int64, row-major [dy, dx] from -r."""
    n, b, _ = src.shape
    size, num = b + 2 * r, 2 * r + 1
    corr = torch.fft.irfft2(torch.fft.rfft2(win.to(torch.float64))
                            * torch.fft.rfft2(src.to(torch.float64), s=(size, size)).conj(),
                            s=(size, size))[:, :num, :num]
    exact = corr.round()
    err = float((corr - exact).abs().max())
    if err > 0.25:
        raise ArithmeticError(f"FFT correlation off by {err} from an integer")
    integral = torch.nn.functional.pad((win.to(torch.int64) ** 2).cumsum(1).cumsum(2),
                                       (1, 0, 1, 0))
    energy = (integral[:, b:, b:] - integral[:, :num, b:] - integral[:, b:, :num]
              + integral[:, :num, :num])
    return (src.to(torch.int64) ** 2).sum((1, 2))[:, None, None] + energy \
        - 2 * exact.to(torch.int64)


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """(c, 64, 64) -> (c, 8, 8, 8, 8): the 8x8 tiles of each CTU by (ty, tx)."""
    return x.reshape(-1, K, BASE, K, BASE).transpose(2, 3)


def _untiles(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(2, 3).reshape(-1, CTU, CTU)


def _decide(src, pos, padded, r: int, lam: int, layouts):
    """The PU decision and refinement of a block of c CTUs: (pred (c, 64,
    64) int64, MV field (c, 8, 8, 2) int64 quarter-pel)."""
    c, dev = src.shape[0], src.device
    num = 2 * r + 1
    offs = torch.arange(K, device=dev) * BASE
    tile_pos = (pos[:, None, None, :] + torch.stack(torch.meshgrid(offs, offs, indexing="ij"),
                                                    dim=-1)).reshape(-1, 2)
    src_t = _tiles(src)                                              # (c, 8, 8, 8, 8)
    # Padded coordinates: a plane sample p lies at p + r + 3.
    grids = _ssd_grids(src_t.reshape(-1, BASE, BASE),
                       ops.windows(padded, tile_pos + 3, BASE + 2 * r), r)
    grids = grids.reshape(c, K, K, num, num)
    costs, tile_mvs = [], []
    for name in layouts:
        ph, pw = (s // BASE for s in PU_SIZE[name])
        pu = grids.reshape(c, K // ph, ph, K // pw, pw, num * num).sum((2, 4))
        idx, best = ops.first_min(pu)                               # (c, K/ph, K/pw)
        mv = torch.stack([idx // num - r, idx % num - r], dim=-1)
        costs.append(best.sum((1, 2)) + lam * (K // ph) * (K // pw))
        tile_mvs.append(mv.repeat_interleave(ph, 1).repeat_interleave(pw, 2))
    choice, _ = ops.first_min(torch.stack(costs, dim=-1))
    rows = torch.arange(c, device=dev)
    mv_int = torch.stack(tile_mvs, dim=1)[rows, choice]            # (c, 8, 8, 2)
    # Each tile's PU, as (tile row // PU rows, tile column // PU columns).
    sizes = torch.tensor([PU_SIZE[name] for name in layouts], device=dev)[choice] // BASE
    t = torch.arange(K, device=dev)
    pu_cols = K // sizes[:, 1]
    pu_of = (t[None, :, None] // sizes[:, 0, None, None]) * pu_cols[:, None, None] \
        + t[None, None, :] // sizes[:, 1, None, None]               # (c, 8, 8)
    # The 16 fractions of every tile at its PU's integer MV, summed a PU.
    win = ops.windows(padded, tile_pos + mv_int.reshape(-1, 2) + r, BASE + 7)
    flat = src_t.reshape(-1, BASE, BASE)
    accs, scores = [], []
    for yf in range(4):
        for xf in range(4):
            full = torch.full((flat.shape[0],), 0, device=dev)
            acc = ops.interpolate(win, full + xf, full + yf, ops.LUMA_FILTER)
            accs.append(acc)
            scores.append(((acc - (flat << 12)).abs() >> 4).sum((1, 2)).reshape(c, K * K))
    per_pu = torch.zeros((c, K * K, 16), dtype=torch.int64, device=dev)
    per_pu.scatter_add_(1, pu_of.reshape(c, K * K, 1).expand(-1, -1, 16),
                        torch.stack(scores, dim=-1))
    frac_pu, _ = ops.first_min(per_pu)                              # (c, 64)
    frac = torch.gather(frac_pu, 1, pu_of.reshape(c, K * K)).reshape(-1)
    acc = torch.stack(accs, dim=1)[torch.arange(frac.shape[0], device=dev), frac]
    pred = _untiles(ops.uni_pred(acc).reshape(c, K, K, BASE, BASE))
    field = mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1).reshape(c, K, K, 2)
    return pred, field


def _code(src, pred, qp: int, tu: int, dtype):
    """ops.code_residual at tu x tu TUs, inter, keeping the levels: (recon
    (n, 64, 64) int64, levels (n, (64 / tu)^2, tu, tu) int64)."""
    qscale, qshift, qoffset, dscale, dshift = ops.quant_params(qp, tu, False)
    coeffs = ops.forward_transform(ops.split_tus(src - pred, tu), dtype)
    level = (coeffs.abs() * qscale + qoffset) >> qshift
    level = ops.clip16(torch.where(coeffs < 0, -level, level))
    scaled = ops.clip16((level * dscale + (1 << (dshift - 1))) >> dshift)
    res = ops.inverse_transform(scaled, dtype)
    recon = ops.merge_tus((ops.split_tus(pred, tu) + res).clamp(0, 255), src.shape[-1])
    return recon, level.reshape(src.shape[0], -1, tu, tu)


def _bits(level: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb bits of each CTU's levels (n, ...): 2 floor(log2 |l|) + 3
    a non-zero level."""
    a = level.abs().reshape(level.shape[0], -1)
    log2 = torch.where(a > 0, torch.frexp(a.to(torch.float64))[1] - 1, 0)
    return torch.where(a > 0, 2 * log2 + 3, 0).sum(-1)


def _select_tu(ref, src, pred, qp: int, lam: int):
    """The TU decision: (recon (n, 64, 64) int64, coded TUs of the chosen
    sizes)."""
    recs, costs, coded = [], [], []
    for tu in ref.cfg["tu_sizes"]:
        rec, level = _code(src, pred, qp, tu, ref.dtype)
        costs.append(((src - rec) ** 2).sum((1, 2)) + lam * _bits(level))
        recs.append(rec)
        coded.append((level != 0).any(-1).any(-1).sum(-1))
    choice, _ = ops.first_min(torch.stack(costs, dim=-1))
    rows = torch.arange(src.shape[0], device=src.device)
    return torch.stack(recs, dim=1)[rows, choice], torch.stack(coded, dim=-1)[rows, choice].sum()


def _chroma(ref, cur: torch.Tensor, prev: torch.Tensor, field: torch.Tensor, qp: int):
    """One chroma plane: each 4x4 tile at its PU's MV, then the 4x4 residual.
    Returns (recon (H/2, W/2) int64, nnz)."""
    b, t = CTU // 2, BASE // 2
    rc = ref.r // 2 + 1                  # chroma integer reach, +1 for mv >> 3
    h, w = cur.shape
    dev = cur.device
    pos = ops.block_positions(h, w, b, dev)
    offs = torch.arange(K, device=dev) * t
    tile_pos = pos[:, None, None, :] + torch.stack(torch.meshgrid(offs, offs, indexing="ij"),
                                                   dim=-1)
    padded = ops.edge_pad(prev, rc + 1, rc + 3, rc + 1, rc + 3)
    mv = field.reshape(-1, 2)
    win = ops.windows(padded, tile_pos.reshape(-1, 2) + (mv >> 3) + rc, t + 3)
    frac = mv & 7
    pred = ops.uni_pred(ops.interpolate(win, frac[:, 1], frac[:, 0], ops.CHROMA_FILTER))
    pred = pred.reshape(-1, K, K, t, t).transpose(2, 3).reshape(-1, b, b)
    rec, nnz = ops.code_residual(ops.tile(cur, b), pred, chroma_qp(qp), 4, False, ref.dtype)
    return ops.untile(rec, h, w), nnz


def inter_yuv_rd(ref, cur, prev, qp: int | None = None) -> dict:
    """One RD P frame of (y, cb, cr) from the reconstruction ``prev``:
    {"recon": (y, cb, cr) uint8, "mvs": (n, 8, 8, 2), "nnz", "psnr_y",
    "psnr_cb", "psnr_cr"}."""
    if ref.ctu != CTU:
        raise ValueError(f"the RD P frame codes {CTU}x{CTU} CTUs, not {ref.ctu}")
    qp = ref.qp if qp is None else qp
    cur = [p.to(torch.int64) for p in cur]
    prev = [p.to(torch.int64) for p in prev]
    r, (h, w) = ref.r, cur[0].shape
    lam = _lambda(qp)
    src = ops.tile(cur[0], CTU)
    pos = ops.block_positions(h, w, CTU, src.device)
    padded = ops.edge_pad(prev[0], r + 3, r + 4, r + 3, r + 4)
    decided = [_decide(src[i:i + CHUNK], pos[i:i + CHUNK], padded, r, lam,
                       ref.cfg["pu_layouts"]) for i in range(0, src.shape[0], CHUNK)]
    pred = torch.cat([d[0] for d in decided])
    field = torch.cat([d[1] for d in decided])
    rec_y, nnz = _select_tu(ref, src, pred, qp, lam)
    recs = [ops.untile(rec_y, h, w)]
    for c in (1, 2):
        rec_c, nnz_c = _chroma(ref, cur[c], prev[c], field, qp)
        recs.append(rec_c)
        nnz = nnz + nnz_c
    out = {"recon": tuple(p.to(torch.uint8) for p in recs), "mvs": field, "nnz": int(nnz)}
    for name, a, b in zip(("psnr_y", "psnr_cb", "psnr_cr"), cur, recs):
        out[name] = ops.psnr(a, b)
    return out
