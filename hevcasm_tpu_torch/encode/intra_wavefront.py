"""Closed-loop intra frames in wavefront order, the counterpart of
``hevcasm_tpu.encode.intra_wavefront``.

HEVC intra predicts each block from *reconstructed* neighbours: left,
above, above-right and the corner.  With wave index w = 2r + c every
dependency of block (r, c) lands in an earlier wave (left and above-right
in w - 1, above in w - 2, the corner in w - 3), so the blocks of one wave
are independent and are coded together.  A frame of gr x gc blocks takes
2 (gr - 1) + gc waves, each of at most min(gr, ceil(gc / 2)) blocks.

The reconstruction stays in block-tiled layout on the device.  Which
blocks a wave codes, where their neighbour samples lie and which of them
are available depend on the frame's shape alone, so they are computed once
on the host and copied to the card without blocking (one table per shape):
the wave loop makes no host read of the card.  A wave gathers its
neighbour runs with one index_select and writes its blocks back with one
index_copy_.  The output equals the raster-order encode bit for bit (and
hevcasm_tpu's skewed-canvas schedule, whose invalid slots code nothing).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Tier
from ..utils.psnr import psnr
from ..utils.tensor import to_device
from ..utils.trace import span
from . import ctu as ctu_mod
from .loop import (EncodeConfig, _intra_mode_decide, _prepare_intra_refs, _prepare_plane,
                   _residual_pipeline)

__all__ = ["encode_intra_frame_wavefront", "UNAVAILABLE"]

UNAVAILABLE = 128  # HEVC substitution value when no neighbour exists


@functools.lru_cache(maxsize=16)
def _schedule(h: int, w: int, n: int, device: torch.device):
    """The wave schedule of an (h, w) frame of n x n blocks.

    Returns (spans, blocks, refs, lav, aav, cav): spans [(start, stop)] into
    the block-ordered tables per wave; blocks (num,) int64 block indices in
    wave order; refs (num, 4n + 1) int64 offsets into the tiled canvas of
    each block's [left(2n), above(2n), corner] samples (clamped into range
    where unavailable); lav, aav (num, 2n) and cav (num,) bool availability
    under the wavefront order: the below-left run is never available, the
    above-right run only inside the frame."""
    gr, gc = ctu_mod.grid_shape(h, w, n)
    # Wave wv codes the blocks (r, wv - 2r) with 0 <= wv - 2r < gc.
    rows = [np.arange(max(0, (wv - gc + 2) // 2), min(gr - 1, wv // 2) + 1)
            for wv in range(2 * (gr - 1) + gc)]
    stops = np.cumsum([len(rr) for rr in rows]).tolist()
    spans = list(zip([0] + stops[:-1], stops))
    r = np.concatenate(rows)
    c = np.concatenate([wv - 2 * rr for wv, rr in enumerate(rows)])
    i = np.arange(2 * n)

    def tiled(y, x):
        """Offset of frame sample (y, x) in the block-tiled canvas."""
        y, x = np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)
        return ((y // n) * gc + x // n) * n * n + (y % n) * n + x % n

    y0, x0 = (r * n)[:, None], (c * n)[:, None]
    refs = np.concatenate([tiled(y0 + i, x0 - 1), tiled(y0 - 1, x0 + i),
                           tiled(y0 - 1, x0 - 1)], axis=1)
    lav = (x0 > 0) & (y0 + i < h) & (i < n)
    aav = (y0 > 0) & (x0 + i < w)
    cav = (c > 0) & (r > 0)
    return (spans, to_device(r * gc + c, torch.int64, device),
            to_device(refs, torch.int64, device), to_device(lav, torch.bool, device),
            to_device(aav, torch.bool, device), to_device(cav, torch.bool, device))


def encode_intra_frame_wavefront(cur, cfg: EncodeConfig = EncodeConfig(),
                                 tiers: Tier = Tier.ALL, device=None) -> dict:
    """Closed-loop intra frame: each block's 35-mode decision
    (loop._intra_mode_decide) against *reconstructed* neighbours, coded
    wave by wave.

    cur: (H, W) uint8 tensor or numpy array, H and W multiples of
    cfg.intra_block; devices as for encode_inter_frame.  Returns {"recon":
    (H, W) uint8, "nnz": () int32, "psnr_db": () float32}."""
    with span("hevcasm.intra_luma"):
        cur = _prepare_plane(cur, device)
        h, w = cur.shape
        n = cfg.intra_block
        dev = cur.device
        spans, order, refs, lav, aav, cav = _schedule(h, w, n, dev)
        src = ctu_mod.tile_frame(cur, n).index_select(0, order)      # blocks in wave order
        canvas = torch.full((h * w,), UNAVAILABLE, dtype=torch.uint8, device=dev)
        tiles = canvas.view(-1, n, n)
        nnz = torch.zeros((), dtype=torch.int32, device=dev)
        for s, e in spans:
            if s == e:          # one block column: odd waves are empty
                continue
            with span("hevcasm.intra_wave"):
                nb = canvas.index_select(0, refs[s:e].reshape(-1)).view(e - s, 4 * n + 1)
                refs_plain, refs_filt = _prepare_intra_refs(
                    nb[:, :2 * n], nb[:, 2 * n:4 * n], nb[:, 4 * n], lav[s:e], aav[s:e],
                    cav[s:e], n, cfg)
                pred, _ = _intra_mode_decide(src[s:e], refs_plain, refs_filt, n)
                rec, nnz_w, _ = _residual_pipeline(src[s:e], pred, cfg, intra=True,
                                                   tiers=tiers)
                tiles.index_copy_(0, order[s:e], rec)
                nnz = nnz + nnz_w
        recon = ctu_mod.untile_frame(tiles, h, w)
        return {"recon": recon, "nnz": nnz, "psnr_db": psnr(cur, recon)}
