"""Motion estimation: full-search integer ME and quarter-pel refinement,
the counterpart of ``hevcasm_tpu.encode.motion``.

Every CTU of a frame searches in one batched call:

  1. integer full search: the exact SSD of each CTU against every
     displacement in [-R, R]^2, then the first minimum in row-major
     [dy, dx] order;
  2. quarter-pel refinement: the 16 (yf, xf) luma interpolations at the
     best integer MV, scored by QPEL_SCORE (ops.pred_inter.refine_qpel).
"""

from __future__ import annotations

import torch

from ..kernels.search import ssd_grid_plane
from ..ops.pred_inter import refine_qpel
from ..ops.ssd import ssd_grid
from ..utils.tensor import as_tensor, first_min

__all__ = [
    "TAPS", "PAD_L", "PAD_R",
    "ctu_positions",
    "extract_windows",
    "extract_aligned_windows",
    "full_search",
    "full_search_slab",
    "refine_quarter_pel",
]

TAPS = 8
PAD_L = TAPS // 2 - 1  # 3
PAD_R = TAPS // 2      # 4


def ctu_positions(grid_rows: int, grid_cols: int, ctu: int,
                  device: torch.device | None = None) -> torch.Tensor:
    """(n, 2) int32 [y, x] pixel positions of each CTU, row-major."""
    r = torch.arange(grid_rows, dtype=torch.int32, device=device) * ctu
    c = torch.arange(grid_cols, dtype=torch.int32, device=device) * ctu
    yy, xx = torch.meshgrid(r, c, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def extract_windows(plane: torch.Tensor, positions: torch.Tensor,
                    size: int | tuple[int, int]) -> torch.Tensor:
    """Gather a (sy, sx) window at each top-left position of a 2-D plane.

    Returns (n, sy, sx).  A start that would reach past the plane is
    clamped so the window fits, as ``jax.lax.dynamic_slice`` does."""
    sy, sx = (size, size) if isinstance(size, int) else size
    plane = as_tensor(plane)
    positions = as_tensor(positions, plane.device).long()
    hp, wp = plane.shape
    y0 = positions[:, 0].clamp(0, hp - sy)
    x0 = positions[:, 1].clamp(0, wp - sx)
    rows = y0[:, None] + torch.arange(sy, device=plane.device)
    cols = x0[:, None] + torch.arange(sx, device=plane.device)
    return plane[rows[:, :, None], cols[:, None, :]]


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


def _mv_from_index(best: torch.Tensor, num: int, r: int) -> torch.Tensor:
    return torch.stack([best // num - r, best % num - r], dim=-1).to(torch.int32)


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
    return _mv_from_index(best, num, r), best_score


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
    return _mv_from_index(best, num, r), best_score


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
    mv_qpel = mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1)
    return pred, mv_qpel.to(torch.int32), win
