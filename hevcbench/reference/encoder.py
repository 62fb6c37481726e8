"""The benchmark's plain reference encoder.

It codes what the measured program's entry points code, with the same
semantics and the same output keys, from the standard's equations in
``ops`` and the coding rules that a configuration file states:

* P frames: an exhaustive integer SSD search over [-R, R]^2 against the
  edge-extended reference, the first minimum in row-major [dy, dx] order;
  the 16 quarter-pel fractions at or after it scored by the pre-shift
  accumulator, the first minimum in yf * 4 + xf order; the luma residual at
  tu x tu DCT TUs.  4:2:0 chroma takes each CTU's quarter-pel luma MV as an
  eighth-pel chroma MV (integer part mv >> 3, fraction mv & 7) and codes
  its residual at 4x4 TUs and the chroma qp of table 8-10.
* Closed-loop I frames: 32x32 luma blocks, each predicted from the
  reconstruction of the blocks before it, in any order that codes a block
  after its left, above, above-right and above-left neighbours (here:
  waves of blocks (r, c) with 2r + c constant); the 35 modes scored in the
  8x8 Hadamard domain, sum |H acc H - (H src H) << s| >> (s + 2); the
  below-left samples never available.  Chroma I blocks are 32x32 from the
  source's own samples, planar/DC/H/V by 8x8 SATD.

``Reference(dtype)`` computes every matrix product in ``dtype``: float64,
exact, is the reference; a lower precision is the control.  Outputs are on
the inputs' device; numbers that the program returns as 0-d tensors are
Python numbers here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import lookup
from . import ops

# H.265 table 8-10 (4:2:0): QpC as a function of qPi from 30 to 43.
_QPC = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def chroma_qp(qp: int) -> int:
    return qp if qp < 30 else qp - 6 if qp > 43 else _QPC[qp - 30]


#: The encode fields the reference codes, each with the values it takes
#: (None: any value).  The program's implementation fields choose among
#: its ways to compute the same integers, so any value of theirs codes the
#: same; any other field, or another value, raises: the reference does not
#: code it.  The reference's side of an entry point that a configuration
#: names may declare ``FIELDS`` of its own, which add to these.
FIELDS = {"ctu": None, "tu": None, "intra_block": (32,), "search_range": None, "qp": None,
          "strong_intra_smoothing": None, "me_metric": ("ssd",), "me_strategy": ("full",),
          "pu_decision": (False,), "tu_sizes": ((),)}
IMPLEMENTATION = ("search_impl", "fused_refine", "refine_impl", "residual_impl", "inter_impl",
                  "fused_group")


def fields(modules=()) -> dict:
    """``FIELDS`` with those of the given entry modules added: a value that
    either side's list takes is taken."""
    out = dict(FIELDS)
    for mod in modules:
        for key, allowed in getattr(mod, "FIELDS", {}).items():
            if key in out and out[key] is None or allowed is None:
                out[key] = None
            else:
                out[key] = tuple(out.get(key, ())) + tuple(allowed)
    return out


class Reference:
    """Entry points with the program's names and outputs, in plain PyTorch.

    cfg: the configuration file's "encode" fields; those that the reference
    does not code (``fields``) raise ValueError.  entries: the
    configuration's "entries", whose reference sides are bound as entry
    points (``lookup.bind``).  A frame entry's ``qp`` replaces the
    configuration's for that frame."""

    def __init__(self, cfg: dict, dtype: torch.dtype = ops.EXACT, entries=(),
                 dirs=lookup.DIRS):
        self.cfg = cfg
        self.ctu = cfg.get("ctu", 64)
        self.tu = cfg.get("tu", 8)
        self.intra_block = cfg.get("intra_block", 32)
        self.r = cfg["search_range"]
        self.qp = cfg["qp"]
        self.strong = cfg.get("strong_intra_smoothing", True)
        self.dtype = dtype
        coded = fields(lookup.bind(self, entries, "reference", dirs))
        for key, value in cfg.items():
            if key in IMPLEMENTATION:
                continue
            if key not in coded:
                raise ValueError(f"the reference does not code the encode field {key!r}")
            allowed = coded[key]
            value = tuple(value) if isinstance(value, list) else value
            if allowed is not None and value not in allowed:
                raise ValueError(f"the reference codes {key} in {allowed}, not {value!r}")

    # ---- P frames ----------------------------------------------------------

    def _luma_p(self, cur: torch.Tensor, ref: torch.Tensor, qp: int):
        b, r = self.ctu, self.r
        h, w = cur.shape
        src = ops.tile(cur, b)
        pos = ops.block_positions(h, w, b, cur.device)
        padded = ops.edge_pad(ref, r + 3, r + 4, r + 3, r + 4)
        chunk = 512
        mv_int = torch.cat([
            ops.ssd_search(src[c:c + chunk], ops.windows(padded, pos[c:c + chunk] + 3, b + 2 * r),
                           r)[0]
            for c in range(0, src.shape[0], chunk)])
        pred, frac = ops.quarter_pel(src, ops.windows(padded, pos + mv_int + r, b + 7))
        rec, nnz = ops.code_residual(src, pred, qp, self.tu, False, self.dtype)
        mvs = mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1)
        return ops.untile(rec, h, w), mvs, nnz

    def _chroma_p(self, cur: torch.Tensor, ref: torch.Tensor, mvs: torch.Tensor, qp: int):
        b = self.ctu // 2
        rc = self.r // 2 + 1                 # chroma integer reach, +1 for mv >> 3
        h, w = cur.shape
        pos = ops.block_positions(h, w, b, cur.device)
        padded = ops.edge_pad(ref, rc + 1, rc + 3, rc + 1, rc + 3)
        win = ops.windows(padded, pos + (mvs >> 3) + rc, b + 3)
        frac = mvs & 7
        pred = ops.uni_pred(ops.interpolate(win, frac[:, 1], frac[:, 0], ops.CHROMA_FILTER))
        rec, nnz = ops.code_residual(ops.tile(cur, b), pred, chroma_qp(qp), 4, False,
                                     self.dtype)
        return ops.untile(rec, h, w), nnz

    def inter_yuv(self, cur, ref, qp: int | None = None) -> dict:
        """encode_inter_frame_yuv: {"recon": (y, cb, cr), "mvs", "nnz",
        "psnr_y", "psnr_cb", "psnr_cr"}."""
        cur = [p.to(torch.int64) for p in cur]
        ref = [p.to(torch.int64) for p in ref]
        qp = self.qp if qp is None else qp
        rec_y, mvs, nnz = self._luma_p(cur[0], ref[0], qp)
        recs = [rec_y]
        for c in (1, 2):
            rec_c, nnz_c = self._chroma_p(cur[c], ref[c], mvs, qp)
            recs.append(rec_c)
            nnz += nnz_c
        out = {"recon": tuple(p.to(torch.uint8) for p in recs), "mvs": mvs, "nnz": int(nnz)}
        for name, a, b in zip(("psnr_y", "psnr_cb", "psnr_cr"), cur, recs):
            out[name] = ops.psnr(a, b)
        return out

    # ---- I frames ----------------------------------------------------------

    def _decide_32(self, src, left, above, corner):
        """The 35-mode decision of 32x32 blocks in the Hadamard domain from
        substituted neighbours.  Returns the chosen prediction (m, 32, 32)."""
        plain = (left, above, corner)
        acc, shifts = ops.intra_accs(plain, ops.smooth(*plain, self.strong), 32)
        s = shifts[None, :, None, None, None]
        acc_t = ops.hadamard_8x8(acc, self.dtype)                  # (m, 35, 16, 8, 8)
        src_t = ops.hadamard_8x8(src, self.dtype)[:, None]
        score = ((acc_t - (src_t << s)).abs() >> (s + 2)).sum((-3, -2, -1))
        best, _ = ops.first_min(score)
        pick = torch.arange(src.shape[0], device=src.device)
        return (acc[pick, best] >> shifts[best][:, None, None]).clamp(0, 255)

    def intra_luma(self, cur: torch.Tensor) -> dict:
        """encode_intra_frame_wavefront: {"recon", "nnz", "psnr_db"}."""
        n = self.intra_block
        if n != 32:
            raise ValueError("the reference codes 32x32 intra blocks")
        cur = cur.to(torch.int64)
        h, w = cur.shape
        dev = cur.device
        gr, gc = h // n, w // n
        rec = torch.full((h * w,), 128, dtype=torch.int64, device=dev)
        tiles = ops.tile(cur, n)
        i = np.arange(2 * n)
        nnz = 0
        for wave in range(2 * (gr - 1) + gc):
            r = np.arange(max(0, (wave - gc + 2) // 2), min(gr - 1, wave // 2) + 1)
            c = wave - 2 * r
            if r.size == 0:
                continue
            y0, x0 = (r * n)[:, None], (c * n)[:, None]

            def at(y, x):
                return np.clip(y, 0, h - 1) * w + np.clip(x, 0, w - 1)

            idx = torch.as_tensor(np.concatenate(
                [at(y0 + i, x0 - 1), at(y0 - 1, x0 + i), at(y0 - 1, x0 - 1)], axis=1),
                device=dev)
            nb = rec[idx]
            avail = torch.as_tensor(np.concatenate(
                [(x0 > 0) & (i < n) & (y0 + i < h), (y0 > 0) & (x0 + i < w),
                 (x0 > 0) & (y0 > 0)], axis=1), device=dev)
            refs = ops.substitute(nb[:, :2 * n], nb[:, 2 * n:4 * n], nb[:, 4 * n],
                                  avail[:, :2 * n], avail[:, 2 * n:4 * n], avail[:, 4 * n])
            blocks = torch.as_tensor(r * gc + c, device=dev)
            src = tiles[blocks]
            pred = self._decide_32(src, *refs)
            out, nnz_w = ops.code_residual(src, pred, self.qp, self.tu, True, self.dtype)
            nnz += nnz_w
            pix = torch.as_tensor(at(y0[:, :, None] + np.arange(n)[None, :, None],
                                     x0[:, :, None] + np.arange(n)[None, None, :]),
                                  device=dev)
            rec[pix.reshape(-1)] = out.reshape(-1)
        rec = rec.reshape(h, w)
        return {"recon": rec.to(torch.uint8), "nnz": int(nnz), "psnr_db": ops.psnr(cur, rec)}

    def _chroma_intra(self, plane: torch.Tensor):
        """Open-loop chroma I blocks of half the CTU: neighbours from the
        source (available where inside the picture), modes planar, DC, H
        and V by 8x8 SATD, the first minimum in that order."""
        n = self.ctu // 2
        h, w = plane.shape
        dev = plane.device
        pos = ops.block_positions(h, w, n, dev)
        y0, x0 = pos[:, :1], pos[:, 1:]
        i = torch.arange(2 * n, device=dev)
        flat = plane.reshape(-1)

        def at(y, x):
            return flat[y.clamp(0, h - 1) * w + x.clamp(0, w - 1)]

        refs = ops.substitute(at(y0 + i, x0 - 1), at(y0 - 1, x0 + i), at(y0 - 1, x0 - 1)[:, 0],
                              (x0 > 0) & (y0 + i < h), (y0 > 0) & (x0 + i < w),
                              ((x0 > 0) & (y0 > 0))[:, 0])
        acc, shifts = ops.intra_accs(refs, ops.smooth(*refs, self.strong), n)
        modes = [0, 1, 10, 26]
        preds = (acc[:, modes] >> shifts[modes][None, :, None, None]).clamp(0, 255)
        src = ops.tile(plane, n)
        costs = torch.stack([ops.satd8(src, preds[:, i], self.dtype) for i in range(4)], -1)
        best, _ = ops.first_min(costs)
        pred = preds[torch.arange(src.shape[0], device=dev), best]
        rec, nnz = ops.code_residual(src, pred, chroma_qp(self.qp), 4, True, self.dtype)
        return ops.untile(rec, h, w), nnz

    def intra_seed_yuv(self, cur) -> dict:
        """The closed-loop 4:2:0 GOP's I frame (wavefront luma, open-loop
        chroma): {"recon": (y, cb, cr), "psnr_y"}."""
        luma = self.intra_luma(cur[0])
        chroma = [self._chroma_intra(p.to(torch.int64))[0].to(torch.uint8) for p in cur[1:]]
        return {"recon": (luma["recon"], *chroma), "psnr_y": luma["psnr_db"]}

    # ---- GOPs ----------------------------------------------------------------

    def gop_yuv(self, frames) -> dict:
        """encode_gop_closed_loop_yuv: frame 0 the closed-loop 4:2:0 I frame,
        each later frame a P frame from the previous reconstruction on all
        three planes.  frames: (y, cb, cr) stacks.  Returns {"recon": (y, cb,
        cr) stacks, "psnr_y" [T floats]}."""
        out = self.intra_seed_yuv(tuple(p[0] for p in frames))
        recs, psnrs = [out["recon"]], [out["psnr_y"]]
        for t in range(1, frames[0].shape[0]):
            out = self.inter_yuv(tuple(p[t] for p in frames), recs[-1])
            recs.append(out["recon"])
            psnrs.append(out["psnr_y"])
        return {"recon": tuple(torch.stack(p) for p in zip(*recs)), "psnr_y": psnrs}
