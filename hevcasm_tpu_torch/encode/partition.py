"""Variable block structure, the counterpart of
``hevcasm_tpu.encode.partition``: the per-CTU PU-layout decision (square
64/32/16/8 levels and the rectangular 2NxN / Nx2N splits) and the per-CTU
TU-size selection (4/8/16/32).

* Motion per PU: the integer SSD grid is additive over sub-blocks, so one
  search at base granularity (the smallest PU side of the layout set) gives
  the exact grid of every PU as a sum of sub-block grids.  Each PU takes
  its own first minimum; each CTU takes the layout minimising
  sum(best SSD) + lambda * number of PUs.
* Quarter-pel refinement per PU: the QPEL_SCORE maps of the PU's square
  tiles are summed, one fraction is chosen for the whole PU, and each tile
  is interpolated at it.
* TU size: the residual pipeline runs at each candidate size and each CTU
  takes the minimum of SSD + lambda * Exp-Golomb bits.

The kernels are passed in, as encode.motion takes them: ``decide_fn``
(B15 base_layout_decide), ``grids_fn`` (B14 base_grids_ctu), ``costmap_fn``
(B12 refine_qpel_costmap), ``costmap_dma_fn`` (B13 refine_qpel_costmap_dma)
and ``grid_fn`` (an SSD-grid scorer: B8 kernels.search.ssd_grid or its
plain version).  The defaults are the kernel wrappers, which run the plain
versions on CPU tensors; encode.loop picks them from the registry, so
Tier.REF runs the plain path on a card.  Every route gives the same
integers.

Under a profiler the pruned PU decision records its steps as spans
(utils.trace): ``hevcasm.pu_grids`` (B15, or B14 / the grid scorer),
``hevcasm.pu_layout`` (the layout decision's glue) and ``hevcasm.pu_refine``
(B13 and the prediction's assembly); the TU decision records
``hevcasm.tu_select``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.base_grids import base_grids_ctu, base_layout_decide
from ..kernels.costmap import PLANE_SIZES, refine_qpel_costmap, refine_qpel_costmap_dma
from ..ops.pred_inter import pred_uni
from ..ops.residual import residual_pipeline_frame
from ..utils.tensor import first_min
from ..utils.trace import span
from . import ctu as ctu_mod
from . import motion

__all__ = [
    "PU_LAYOUTS", "base_for", "base_grid_search", "grid_integral",
    "rect_grid", "layout_decision", "refine_layout", "select_pu_layout",
    "select_pu_layout_pruned", "multi_level_search", "select_tu_recon",
    "mv_lambda",
]

CTU = 64

# Layout name -> PU rects (y0, x0, h, w) tiling the 64x64 CTU.
PU_LAYOUTS = {
    "2Nx2N": ((0, 0, 64, 64),),
    "2NxN": ((0, 0, 32, 64), (32, 0, 32, 64)),
    "Nx2N": ((0, 0, 64, 32), (0, 32, 64, 32)),
    "NxN": tuple((32 * i, 32 * j, 32, 32) for i in range(2) for j in range(2)),
    "quarter": tuple((16 * i, 16 * j, 16, 16) for i in range(4) for j in range(4)),
    "eighth": tuple((8 * i, 8 * j, 8, 8) for i in range(8) for j in range(8)),
}


def mv_lambda(qp: int) -> int:
    """Motion-cost weight of the PU decision: the HM-style
    lambda = 0.85 * 2^((qp-12)/3) in integer-SSD units (Python's round,
    half to even)."""
    return max(1, int(round(0.85 * 2.0 ** ((qp - 12) / 3.0))))


def base_for(layouts) -> int:
    """Base search granularity: the smallest PU side over the layout set."""
    sides = [min(r[2], r[3]) for name in layouts for r in PU_LAYOUTS[name]]
    if not sides:
        raise ValueError("pu_layouts is empty: the PU decision needs at least one layout")
    return min(sides)


def _argmin_grid(g: torch.Tensor, r: int):
    """(..., ndy, ndx) -> (mv (..., 2) int32 in [-r, r], best (...,)), the
    first minimum in row-major [dy, dx] order."""
    ndy, ndx = g.shape[-2], g.shape[-1]
    idx, best = first_min(g.reshape(*g.shape[:-2], ndy * ndx))
    mv = torch.stack([idx // ndx - r, idx % ndx - r], dim=-1).to(torch.int32)
    return mv, best


def base_grid_search(src_ctus, windows, r: int, grid_fn, base: int) -> torch.Tensor:
    """Full search at (base x base) granularity.

    src_ctus (n, 64, 64); windows (n, >= 64+2r, >= 64+2r) CTU search
    windows (each sub-block's window is a slice of its CTU's).  Returns the
    exact grids (n, k, k, num, num), k = 64 // base, num = 2r + 1."""
    n = src_ctus.shape[0]
    num = 2 * r + 1
    k = CTU // base
    wsub = base + 2 * r
    srcb = ctu_mod.split_blocks(src_ctus, base)               # (n*k*k, base, base)
    win = windows[:, : CTU + 2 * r, : CTU + 2 * r]
    winb = win.unfold(1, wsub, base).unfold(2, wsub, base)    # (n, k, k, wsub, wsub)
    winb = winb.reshape(n * k * k, wsub, wsub)
    return grid_fn(srcb, winb, num, num).reshape(n, k, k, num, num)


def grid_integral(g: torch.Tensor) -> torch.Tensor:
    """2-D integral image over the sub-block axes, zero-padded in front, so
    any rectangular PU's grid is 4 lookups.  int32: a whole-CTU SSD is at
    most 64*64*255^2 < 2^31."""
    n, k1, k2 = g.shape[:3]
    gi = g.to(torch.int32).cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
    out = gi.new_zeros((n, k1 + 1, k2 + 1, *g.shape[3:]))
    out[:, 1:, 1:] = gi
    return out


def rect_grid(gint: torch.Tensor, rect, base: int) -> torch.Tensor:
    """Exact SSD grid of the PU ``rect`` from the integral image: (n, num, num)."""
    y0, x0, h, w = rect
    i0, j0 = y0 // base, x0 // base
    i1, j1 = (y0 + h) // base, (x0 + w) // base
    return gint[:, i1, j1] - gint[:, i0, j1] - gint[:, i1, j0] + gint[:, i0, j0]


def layout_decision(gint: torch.Tensor, layouts, r: int, lam: int, base: int,
                    rect_fn=None):
    """Integer-MV first minimum per PU per layout, and per-CTU layout costs.

    rect_fn(rect) -> (n, num, num) overrides the integral lookup.  Returns
    (costs (n, L) int32, mvs {layout: (n, P, 2) int32 integer MVs})."""
    if rect_fn is None:
        rect_fn = lambda rect: rect_grid(gint, rect, base)  # noqa: E731
    costs, mvs = [], {}
    for name in layouts:
        rects = PU_LAYOUTS[name]
        tot = 0
        mvl = []
        for rect in rects:
            mv, best = _argmin_grid(rect_fn(rect), r)
            tot = tot + best
            mvl.append(mv)
        costs.append(tot + lam * len(rects))
        mvs[name] = torch.stack(mvl, dim=1)
    return torch.stack(costs, dim=-1), mvs


def refine_layout(src_ctus, ref_padded, pos, rects, mvs, r: int,
                  costmap_fn=refine_qpel_costmap):
    """Quarter-pel refine one PU layout: square tiles of side min(h, w) per
    PU, the tiles' cost maps summed per PU, one fraction per PU (the first
    minimum in yf*4 + xf order), each tile interpolated at its PU's
    fraction.

    mvs (n, P, 2) integer MVs.  Returns (pred (n, 64, 64) uint8,
    mv_qpel (n, P, 2) int32)."""
    n = src_ctus.shape[0]
    dev = src_ctus.device
    t = min(rects[0][2], rects[0][3])               # uniform within a layout
    tiles = [(pi, y0 + dy, x0 + dx)
             for pi, (y0, x0, hh, ww) in enumerate(rects)
             for dy in range(0, hh, t) for dx in range(0, ww, t)]
    m, npu = len(tiles), len(rects)
    src_tiles = torch.stack([src_ctus[:, ty:ty + t, tx:tx + t] for _, ty, tx in tiles],
                            dim=1).reshape(n * m, t, t)
    offs = torch.tensor([(ty, tx) for _, ty, tx in tiles], dtype=torch.int32, device=dev)
    pu_of = torch.tensor([pi for pi, _, _ in tiles], dtype=torch.long, device=dev)
    mv_tiles = mvs[:, pu_of]                                           # (n, m, 2)
    start = (pos[:, None, :] + offs[None] + mv_tiles + r).reshape(n * m, 2)
    win = motion.extract_windows(ref_padded, start, t + motion.TAPS - 1)
    costs = costmap_fn(src_tiles.contiguous(), win).reshape(n, m, 16)
    cost_pu = torch.zeros((n, npu, 16), dtype=torch.int32, device=dev)
    cost_pu.index_add_(1, pu_of, costs)
    frac_pu, _ = first_min(cost_pu)                                    # (n, P)
    frac_tiles = frac_pu[:, pu_of].reshape(n * m)
    pt = pred_uni(win, frac_tiles % 4, frac_tiles // 4).reshape(n, m, t, t)
    pred = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    for ti, (_, ty, tx) in enumerate(tiles):
        pred[:, ty:ty + t, tx:tx + t] = pt[:, ti]
    return pred, motion.qpel_mvs(mvs, frac_pu)


def _tile_pu_table(layouts, base: int) -> np.ndarray:
    """(L, k*k) int32: the PU index owning each (base x base) tile, per
    layout.  Every PU of every layout is a union of base tiles, so one base
    tiling serves every layout's refinement."""
    k = CTU // base
    table = np.zeros((len(layouts), k * k), np.int32)
    for li, name in enumerate(layouts):
        for pi, (y0, x0, hh, ww) in enumerate(PU_LAYOUTS[name]):
            if hh % base or ww % base:
                raise ValueError(f"{name} PU {hh}x{ww} is not a union of {base}x{base} tiles")
            for ty in range(y0 // base, (y0 + hh) // base):
                for tx in range(x0 // base, (x0 + ww) // base):
                    table[li, ty * k + tx] = pi
    return table


def _pu_lists(layouts, base: int) -> tuple[tuple[int, ...], ...]:
    """Every PU of every layout, in order, as its sub-block indices in the
    base tiling; then the whole CTU (for best64)."""
    k = CTU // base
    lists = [tuple(ti * k + tj
                   for ti in range(y0 // base, (y0 + hh) // base)
                   for tj in range(x0 // base, (x0 + ww) // base))
             for name in layouts for (y0, x0, hh, ww) in PU_LAYOUTS[name]]
    return tuple(lists) + (tuple(range(k * k)),)


def select_pu_layout_pruned(src_ctus, ref_padded, pos, windows, r: int, lam: int,
                            layouts, grid_fn, grid=None, metric: str = "ssd", *,
                            decide_fn=base_layout_decide, grids_fn=base_grids_ctu,
                            costmap_dma_fn=refine_qpel_costmap_dma):
    """The PU decision with the refinement pruned to each CTU's winning
    layout: the integer layout decision first, then one quarter-pel pass
    over a single base tiling shared by every layout, each base tile
    looking up its owning PU in the chosen layout.  Equal, output for
    output, to select_pu_layout's selected result.

    Routing, as in hevcasm_tpu: with ``grid`` given, 64 + 2r == 128 and the
    SSD metric, base >= 16 decides in ``decide_fn`` (B15) and base 8 takes
    the sub-block grids from ``grids_fn`` (B14) and the integral image;
    otherwise base_grid_search runs ``grid_fn``.  The refinement always runs
    ``costmap_dma_fn`` (B13), which serves tiles up to 32 wide.

    Returns (pred (n, 64, 64) uint8, choice (n,) int32 index into
    ``layouts``, mv_qpel_tiles (n, k, k, 2) int32 per-base-tile quarter-pel
    MVs, best64 (n,) int32)."""
    n = src_ctus.shape[0]
    dev = src_ctus.device
    base = base_for(layouts)
    if base > max(PLANE_SIZES):
        raise ValueError(
            f"pu_layouts {tuple(layouts)} give base {base}: the pruned refinement "
            f"(refine_qpel_costmap_dma) serves tiles up to {max(PLANE_SIZES)} wide; "
            "add a layout with PUs of side <= 32")
    k = CTU // base
    m = k * k
    pmax = max(len(PU_LAYOUTS[name]) for name in layouts)

    aligned = grid is not None and CTU + 2 * r == 128 and metric == "ssd"
    if aligned:
        win_ctu = motion.extract_aligned_windows(
            ref_padded, (motion.PAD_L, motion.PAD_L), grid, CTU, 128)
    decided = aligned and base >= 16
    with span("hevcasm.pu_grids"):
        if decided:
            dec = decide_fn(src_ctus, win_ctu, base, _pu_lists(layouts, base))
        elif aligned:
            g = grids_fn(src_ctus, win_ctu, base)
        else:
            g = base_grid_search(src_ctus, windows, r, grid_fn, base)
    with span("hevcasm.pu_layout"):
        if decided:
            costs_l, mvs = [], {}
            o = 0
            for name in layouts:
                p = len(PU_LAYOUTS[name])
                seg = dec[:, o:o + p]
                o += p
                mvs[name] = seg[:, :, :2]
                costs_l.append(seg[:, :, 2].sum(dim=1, dtype=torch.int32) + lam * p)
            costs = torch.stack(costs_l, dim=-1)
            best64 = dec[:, -1, 2]
        else:
            gint = grid_integral(g)
            costs, mvs = layout_decision(gint, layouts, r, lam, base)
            _, best64 = _argmin_grid(rect_grid(gint, (0, 0, CTU, CTU), base), r)
        choice, _ = first_min(costs)

        # Per-tile PU index and integer MV of the chosen layout only.
        table = torch.as_tensor(_tile_pu_table(layouts, base), device=dev).long()  # (L, m)
        pu_of = table[choice.long()]                                           # (n, m)
        mv_tiles_l = torch.stack([mvs[name][:, table[li]] for li, name in enumerate(layouts)],
                                 dim=1)                                        # (n, L, m, 2)
        mv_tiles = mv_tiles_l[torch.arange(n, device=dev), choice.long()]     # (n, m, 2)

    with span("hevcasm.pu_refine"):
        # One cost-map call over every base tile of the frame, the windows
        # read from the plane at the MV offsets.
        offs = torch.tensor([(ty * base, tx * base) for ty in range(k) for tx in range(k)],
                            dtype=torch.int32, device=dev)
        src_tiles = ctu_mod.split_blocks(src_ctus, base).contiguous()      # (n*m, b, b)
        start = (pos[:, None, :] + offs[None] + mv_tiles + r).reshape(n * m, 2)
        cost_t, win = costmap_dma_fn(src_tiles, ref_padded.contiguous(),
                                     start.to(torch.int32).contiguous())
        cost_t = cost_t.reshape(n, m, 16)

        # Tile maps -> per-PU maps (slots past a layout's PU count stay 0);
        # one fraction per PU.
        cost_pu = torch.zeros((n, pmax, 16), dtype=torch.int32, device=dev)
        cost_pu.scatter_add_(1, pu_of[:, :, None].expand(n, m, 16), cost_t)
        frac_pu, _ = first_min(cost_pu)                                     # (n, pmax)
        frac_t = torch.gather(frac_pu, 1, pu_of).reshape(n * m)

        # Interpolate each tile once at its PU's fraction, assemble the CTU.
        pt = pred_uni(win, frac_t % 4, frac_t // 4)                         # (n*m, b, b)
        pred = ctu_mod.merge_blocks(pt, CTU)
        mv_qpel = motion.qpel_mvs(mv_tiles, frac_t.reshape(n, m))
        return pred, choice, mv_qpel.reshape(n, k, k, 2), best64


def select_pu_layout(src_ctus, ref_padded, pos, windows, r: int, lam: int, layouts,
                     grid_fn, costmap_fn=refine_qpel_costmap):
    """The full PU decision: base search -> integral grids -> per-layout
    costs and MVs -> every layout refined -> per-CTU layout selection.

    Returns (pred (n, 64, 64) uint8, choice (n,) int32 index into
    ``layouts``, mv_qpel {layout: (n, P, 2) int32}, best64 (n,) int32
    whole-CTU best integer SSD)."""
    base = base_for(layouts)
    g = base_grid_search(src_ctus, windows, r, grid_fn, base)
    gint = grid_integral(g)
    costs, mvs = layout_decision(gint, layouts, r, lam, base)
    choice, _ = first_min(costs)
    _, best64 = _argmin_grid(rect_grid(gint, (0, 0, CTU, CTU), base), r)

    preds, mvq = [], {}
    for name in layouts:
        p, q = refine_layout(src_ctus, ref_padded, pos, PU_LAYOUTS[name], mvs[name], r,
                             costmap_fn=costmap_fn)
        preds.append(p)
        mvq[name] = q
    preds = torch.stack(preds, dim=1)                                       # (n, L, 64, 64)
    pred = preds[torch.arange(preds.shape[0], device=preds.device), choice.long()]
    return pred, choice, mvq, best64


def multi_level_search(src_ctus, windows, r: int, grid_fn, base: int = 16):
    """The classic 64/32/16 square levels from one 16x16-granularity search
    (``base`` is accepted and, as in hevcasm_tpu, not used: the levels need
    16).  Returns mv16 (n, 4, 4, 2), mv32 (n, 2, 2, 2), mv64 (n, 2) and the
    matching best16 / best32 / best64."""
    g = base_grid_search(src_ctus, windows, r, grid_fn, 16)
    gint = grid_integral(g)
    n = src_ctus.shape[0]
    out = {}
    for name, key in (("quarter", "16"), ("NxN", "32"), ("2Nx2N", "64")):
        rects = PU_LAYOUTS[name]
        mvl, bl = [], []
        for rect in rects:
            mv, best = _argmin_grid(rect_grid(gint, rect, 16), r)
            mvl.append(mv)
            bl.append(best)
        k = int(len(rects) ** 0.5)
        if k == 1:
            out[f"mv{key}"] = mvl[0]
            out[f"best{key}"] = bl[0]
        else:
            out[f"mv{key}"] = torch.stack(mvl, dim=1).reshape(n, k, k, 2)
            out[f"best{key}"] = torch.stack(bl, dim=1).reshape(n, k, k)
    return out


def select_tu_recon(src_ctus, pred, cfg, tu_sizes, intra: bool = False):
    """The residual pipeline at each candidate TU size, and per CTU the
    first minimum of SSD + lambda * bits (int32), with the Exp-Golomb bits
    of the quantized levels and lambda = mv_lambda(cfg.qp).

    Returns (recon (n, 64, 64) uint8, tu_choice (n,) int32 index into
    tu_sizes, nnz () int32 coded TUs of the selected sizes)."""
    with span("hevcasm.tu_select"):
        n = src_ctus.shape[0]
        lam = mv_lambda(cfg.qp)
        src32 = src_ctus.to(torch.int32)
        recs, costs, nnzs = [], [], []
        for tu in tu_sizes:
            c = dataclasses.replace(cfg, tu=tu)
            tr_type = 1 if (intra and tu == 4) else 0
            scale, shift, offset = c.quant_params(intra)
            dscale, dshift = c.dequant_params()
            rec, _, cbf, bits = residual_pipeline_frame(
                src_ctus, pred, scale, shift, offset, dscale, dshift, tu=tu, tr_type=tr_type)
            d = src32 - rec.to(torch.int32)
            dist = (d * d).sum(dim=(-2, -1), dtype=torch.int32)
            costs.append(dist + lam * bits)
            recs.append(rec)
            nnzs.append(cbf.reshape(n, -1).sum(dim=-1, dtype=torch.int32))
        choice, _ = first_min(torch.stack(costs, dim=-1))                   # (n,)
        rows = torch.arange(n, device=src_ctus.device)
        recon = torch.stack(recs, dim=1)[rows, choice.long()]
        nnz_sel = torch.stack(nnzs, dim=-1)[rows, choice.long()]
        return recon, choice, nnz_sel.sum(dtype=torch.int32)
