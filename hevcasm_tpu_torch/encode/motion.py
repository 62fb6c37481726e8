"""Motion estimation: full-search and pyramid integer ME and quarter-pel
refinement, the counterpart of ``hevcasm_tpu.encode.motion``.

Every CTU of a frame searches in one batched call:

  1. integer search: the exact SSD or SAD of each CTU against every
     displacement in [-R, R]^2 (full search), or at a 4x-decimated level
     and then in a +-3 grid around its upscaled winner (pyramid search),
     keeping the first minimum in row-major [dy, dx] order;
  2. quarter-pel refinement: the 16 (yf, xf) luma interpolations at the
     best integer MV, scored by QPEL_SCORE (ops.pred_inter.refine_qpel).
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..kernels.sad import sad_grid
from ..kernels.search import MAX_RADIUS, ssd_grid, ssd_grid_plane, ssd_grid_plane_multi
from ..ops.pred_inter import refine_qpel
from ..utils.tensor import (PAD_L, PAD_R, TAPS, as_tensor, extract_windows, first_min,
                            mv_from_index)
from . import ctu as ctu_mod

__all__ = [
    "TAPS", "PAD_L", "PAD_R",
    "grid_metric_fn",
    "ctu_positions",
    "extract_windows",
    "extract_aligned_windows",
    "full_search",
    "full_search_slab",
    "full_search_multi",
    "pyramid_search",
    "refine_quarter_pel",
    "qpel_mvs",
]


def grid_metric_fn(metric: str, tiers: Tier = Tier.ALL):
    """The grid scorer of a metric name among ``tiers``: "sad" the registry's
    sad_grid (kernel B9 for CUDA tensors), "ssd" its ssd_grid (B8)."""
    op = {"sad": "sad_grid", "ssd": "ssd_grid"}[metric]
    fn = registry.get(op, tiers)
    if fn is None:
        raise RuntimeError(f"no implementation of {op!r} in tiers {tiers!r}")
    return fn


def ctu_positions(grid_rows: int, grid_cols: int, ctu: int,
                  device: torch.device | None = None) -> torch.Tensor:
    """(n, 2) int32 [y, x] pixel positions of each CTU, row-major."""
    r = torch.arange(grid_rows, dtype=torch.int32, device=device) * ctu
    c = torch.arange(grid_cols, dtype=torch.int32, device=device) * ctu
    yy, xx = torch.meshgrid(r, c, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def extract_aligned_windows(plane: torch.Tensor, origin: tuple[int, int],
                            grid: tuple[int, int], tile: int,
                            size: int) -> torch.Tensor:
    """Windows of a CTU grid whose starts are origin + (r*tile, c*tile),
    for ``size`` a multiple of ``tile``: unfolded views of one slice of the
    plane, no per-window gather.  Returns (gr*gc, size, size), equal to
    extract_windows at the same positions."""
    gr, gc = grid
    if size % tile:
        raise ValueError(f"window size {size} is not a multiple of the tile {tile}")
    oy, ox = origin
    a = plane[oy : oy + (gr - 1) * tile + size, ox : ox + (gc - 1) * tile + size]
    win = a.unfold(0, size, tile).unfold(1, size, tile)   # (gr, gc, size, size)
    return win.reshape(gr * gc, size, size)


def full_search(src_ctus, ref_padded, positions, search_range: int,
                grid_fn=ssd_grid, grid: tuple[int, int] | None = None):
    """Integer-pel full search on gathered windows.

    src_ctus (n, B, B) uint8; ref_padded the reference padded by
    (R + PAD_L) top/left and (R + PAD_R) bottom/right; positions (n, 2)
    CTU positions in unpadded coordinates; grid_fn(src, windows, num, num)
    the grid scorer; grid the (rows, cols) of the CTU grid, which selects
    the reshape-based window extraction when the span is tile-aligned.

    Returns (mvs (n, 2) int32 [dy, dx] in [-R, R], best (n,) int32).
    """
    b = src_ctus.shape[-1]
    r = search_range
    num = 2 * r + 1
    size = b + 2 * r
    if grid is not None and size % b == 0:
        win = extract_aligned_windows(ref_padded, (PAD_L, PAD_L), grid, b, size)
    else:
        win = extract_windows(ref_padded, positions + PAD_L, size)
    scores = grid_fn(src_ctus, win, num, num)              # (n, num, num)
    best, best_score = first_min(scores.reshape(scores.shape[0], -1))
    return mv_from_index(best, num, r), best_score


def full_search_slab(src_ctus, ref_padded, search_range: int,
                     grid: tuple[int, int], grid_plane_fn=ssd_grid_plane):
    """Integer full search with the windows read straight from the plane
    (kernels.search.ssd_grid_plane): the same contract and results as
    full_search with the SSD metric, for 64x64 CTUs, 1 <= R <= 32 and any
    CTU-grid width.  ``grid_plane_fn`` is the ssd_grid_plane tier to run."""
    b = src_ctus.shape[-1]
    r = search_range
    num = 2 * r + 1
    gr, gc = grid
    # ref_padded carries (R + PAD_L) top/left; the plane kernel wants the
    # window of CTU (r, c) at plane[64r, 64c], i.e. exactly R of padding.
    plane = ref_padded[PAD_L : PAD_L + gr * b + 2 * r,
                       PAD_L : PAD_L + gc * b + 2 * r].contiguous()
    scores = grid_plane_fn(src_ctus, plane, grid, num)
    best, best_score = first_min(scores.reshape(scores.shape[0], -1))
    return mv_from_index(best, num, r), best_score


def full_search_multi(src_ctus, planes, positions, search_range: int,
                      grid_fn=ssd_grid, grid: tuple[int, int] | None = None,
                      joint: bool = True, metric: str | None = None,
                      grid_plane_multi_fn=ssd_grid_plane_multi):
    """Integer full search against k stacked reference planes (k, Hp, Wp),
    each padded like full_search's ref_padded.

    With metric "ssd", 64x64 CTUs, 1 <= R <= 32 and the grid given, the
    multi-plane route runs, as hevcasm_tpu's does on its accelerator:
    ``grid_plane_multi_fn`` (kernel B7 on a CUDA frame, its plain version
    on the CPU) scores every CTU against the k planes, reading the windows
    from them.  Otherwise one ``grid_fn`` call scores the k*n gathered
    windows.  Both give the same grids.

    joint: (mv (n, 2), ref_idx (n,), best (n,)), the first minimum over
    (ref, dy, dx) in that order.  joint=False: per reference, (mv (k, n, 2),
    best (k, n)).  All int32."""
    src_ctus = as_tensor(src_ctus)
    planes = as_tensor(planes, src_ctus.device)
    positions = as_tensor(positions, src_ctus.device)
    k = planes.shape[0]
    n, b = src_ctus.shape[0], src_ctus.shape[-1]
    r = search_range
    num = 2 * r + 1
    size = b + 2 * r
    if metric == "ssd" and b == 64 and 1 <= r <= MAX_RADIUS and grid is not None:
        # Each plane's window of CTU (r, c) starts at [64r, 64c] of the
        # plane cut to exactly R of padding: a view, no copy.
        gr, gc = grid
        sub = planes[:, PAD_L:PAD_L + gr * b + 2 * r, PAD_L:PAD_L + gc * b + 2 * r]
        scores = grid_plane_multi_fn(src_ctus, sub, grid, num).reshape(n, k, num * num)
    else:
        if grid is not None and size % b == 0:
            wins = [extract_aligned_windows(p, (PAD_L, PAD_L), grid, b, size) for p in planes]
        else:
            wins = [extract_windows(p, positions + PAD_L, size) for p in planes]
        scores = grid_fn(src_ctus.repeat(k, 1, 1), torch.cat(wins), num, num)
        scores = scores.reshape(k, n, num * num).transpose(0, 1)    # (n, k, num^2)
    if joint:
        best, best_score = first_min(scores.reshape(n, k * num * num))
        return (mv_from_index(best % (num * num), num, r),
                best // (num * num), best_score)
    best, best_score = first_min(scores.transpose(0, 1))
    return mv_from_index(best, num, r), best_score


def _downsample4(x: torch.Tensor) -> torch.Tensor:
    """4x box decimation with rounding, (v + 8) >> 4, over the trailing two
    axes."""
    h, w = x.shape[-2] // 4, x.shape[-1] // 4
    v = x.to(torch.int32).reshape(*x.shape[:-2], h, 4, w, 4).sum(dim=(-3, -1))
    return ((v + 8) >> 4).to(torch.uint8)


def pyramid_search(src_ctus, ref_plane, ref_padded, positions, search_range: int,
                   grid_fn=sad_grid, fine_range: int = 3,
                   grid: tuple[int, int] | None = None):
    """Two-level integer search over the same +-R window as full_search.

    Level 0: the 4x-decimated CTUs against the decimated reference, edge
    padded by R/4, over every displacement in +-R/4; its first minimum,
    times 4 and clipped to +-(R - fine_range), is the coarse MV.  Level 1:
    the full-resolution CTUs over a +-fine_range grid around it.  Both grids
    run in ``grid_fn``.

    src_ctus (n, B, B) uint8; ref_plane (H, W) the unpadded reference;
    ref_padded it padded as full_search takes it; positions (n, 2); grid the
    (rows, cols) of the CTU grid, which selects the reshape-based coarse
    windows when their span is tile-aligned.  Returns (mv (n, 2) int32,
    best (n,) int32 the fine level's score)."""
    b = src_ctus.shape[-1]
    r = search_range
    rc, bc = r // 4, b // 4

    src_c = _downsample4(src_ctus)                                 # (n, B/4, B/4)
    ref_c = _downsample4(as_tensor(ref_plane, src_ctus.device))    # (H/4, W/4)
    ref_c_pad = ctu_mod.pad_frame(ref_c, rc, rc, rc, rc)            # edge padding
    if grid is not None and (bc + 2 * rc) % bc == 0:
        win_c = extract_aligned_windows(ref_c_pad, (0, 0), grid, bc, bc + 2 * rc)
    else:
        win_c = extract_windows(ref_c_pad, positions // 4, bc + 2 * rc)
    num_c = 2 * rc + 1
    idx_c, _ = first_min(grid_fn(src_c, win_c, num_c, num_c).reshape(src_c.shape[0], -1))
    mv_c = mv_from_index(idx_c, num_c, rc) * 4

    f = fine_range
    mv_c = mv_c.clamp(-r + f, r - f)               # keeps the fine grid in range
    win_f = extract_windows(ref_padded, positions + mv_c - f + (r + PAD_L), b + 2 * f)
    num_f = 2 * f + 1
    scores = grid_fn(src_ctus, win_f, num_f, num_f)
    idx_f, best = first_min(scores.reshape(scores.shape[0], -1))
    return (mv_c + mv_from_index(idx_f, num_f, f)).to(torch.int32), best


def refine_quarter_pel(src_ctus, ref_padded, positions, mv_int,
                       search_range: int, refine_fn=refine_qpel):
    """The 16 fractional offsets at the best integer MV.  Returns (pred
    (n, B, B) uint8, mv_qpel (n, 2) int32 = mv_int*4 + frac, windows)."""
    b = src_ctus.shape[-1]
    # Interp window top-left: y0 + dy - PAD_L in unpadded coordinates, so
    # y0 + dy + R in the padded plane.
    start = positions + mv_int + search_range
    win = extract_windows(ref_padded, start, b + TAPS - 1)  # (n, B+7, B+7)
    pred, frac, _ = refine_fn(src_ctus, win)
    return pred, qpel_mvs(mv_int, frac), win


def qpel_mvs(mv_int: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Quarter-pel MVs (..., 2) int32 from integer MVs (..., 2) and fraction
    indices yf*4 + xf (...)."""
    return (mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1)).to(torch.int32)
