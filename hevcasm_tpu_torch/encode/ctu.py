"""CTU tiling: frame <-> (num_ctus, ctu, ctu) block stacks."""

from __future__ import annotations

import torch

__all__ = ["grid_shape", "tile_frame", "untile_frame", "pad_frame",
           "split_blocks", "merge_blocks"]


def grid_shape(height: int, width: int, ctu: int) -> tuple[int, int]:
    if height % ctu or width % ctu:
        raise ValueError(f"frame {height}x{width} is not a multiple of the "
                         f"{ctu}x{ctu} CTU; pad it first")
    return height // ctu, width // ctu


def tile_frame(frame: torch.Tensor, ctu: int) -> torch.Tensor:
    """(..., H, W) -> (..., nRows*nCols, ctu, ctu), row-major CTU order."""
    h, w = frame.shape[-2], frame.shape[-1]
    gr, gc = grid_shape(h, w, ctu)
    lead = frame.shape[:-2]
    x = frame.reshape(*lead, gr, ctu, gc, ctu).transpose(-3, -2)
    return x.reshape(*lead, gr * gc, ctu, ctu)


def untile_frame(blocks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of tile_frame: (..., n, ctu, ctu) -> (..., H, W)."""
    ctu = blocks.shape[-1]
    gr, gc = grid_shape(height, width, ctu)
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, gr, gc, ctu, ctu).transpose(-3, -2)
    return x.reshape(*lead, height, width)


def _clamped_index(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.arange(-before, n + after, device=device).clamp_(0, n - 1)


def pad_frame(frame: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicating pad over the trailing two axes (HEVC reference-frame
    boundary extension).  Built from clamped index vectors, so it is exact
    for every dtype on every device."""
    h, w = frame.shape[-2], frame.shape[-1]
    rows = _clamped_index(h, top, bottom, frame.device)
    cols = _clamped_index(w, left, right, frame.device)
    return frame.index_select(-2, rows).index_select(-1, cols)


def split_blocks(blocks: torch.Tensor, sub: int) -> torch.Tensor:
    """(..., n, N, N) -> (..., n * (N/sub)^2, sub, sub): split CTUs into TUs
    in raster TU order."""
    n = blocks.shape[-3]
    k = blocks.shape[-1] // sub
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, n, k, sub, k, sub).transpose(-3, -2)
    return x.reshape(*lead, n * k * k, sub, sub)


def merge_blocks(tus: torch.Tensor, big: int) -> torch.Tensor:
    """Inverse of split_blocks."""
    sub = tus.shape[-1]
    k = big // sub
    lead = tus.shape[:-3]
    n = tus.shape[-3] // (k * k)
    x = tus.reshape(*lead, n, k, k, sub, sub).transpose(-3, -2)
    return x.reshape(*lead, n, big, big)
