"""Intra prediction (REF tier), the counterpart of
``hevcasm_tpu.ops.pred_intra``: DC, planar and the 33 angular modes of the
HEVC Main profile (H.265 section 8.4.4.2), batched over leading axes, and
the reference-sample processing callers run before them (substitution,
[1 2 1] and strong smoothing, the filter decision).

Neighbour convention:
  left:   (..., 2n) samples p[-1][0..2n-1]   (top to bottom)
  above:  (..., 2n) samples p[0..2n-1][-1]   (left to right)
  corner: (...,)    sample  p[-1][-1]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tensor import as_tensor, to_device

__all__ = [
    "ANGLES", "INV_ANGLES", "pred_intra_dc", "pred_intra_planar", "pred_intra_angular",
    "pred_intra", "pred_intra_all_modes", "substitute_references", "filter_references",
    "strong_smoothing_condition", "filter_flag",
]

# intraPredAngle per predModeIntra 2..34 (H.265 table 8-5).
ANGLES = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}

# invAngle per negative angle (H.265 table 8-6): round(8192 * 32 / angle).
INV_ANGLES = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482, -21: -390, -26: -315,
              -32: -256}

# intraHorVerDistThres per nTbS (H.265 table 8-7).
_FILTER_THRES = {8: 7, 16: 1, 32: 0}


def _i32(x, device=None) -> torch.Tensor:
    return as_tensor(x, device).to(torch.int32)


def _scan_pack(left, above, corner):
    """The neighbours in the 8.4.4.2.2 scan order: p[-1][2n-1] .. p[-1][0],
    p[-1][-1], p[0][-1] .. p[2n-1][-1], i.e. reversed left, corner, above."""
    return torch.cat([left.flip(-1), corner[..., None], above], dim=-1)


def _scan_unpack(s, n2):
    return s[..., :n2].flip(-1), s[..., n2 + 1:], s[..., n2]


def substitute_references(left, above, corner, left_avail, above_avail, corner_avail):
    """Reference-sample substitution (H.265 8.4.4.2.2).

    left/above (..., 2n) uint8, corner (...,); *_avail boolean masks of the
    same shapes.  An unavailable sample takes the previous available one in
    scan order (bottom-left -> corner -> above-right); a leading unavailable
    run takes the first available sample; with nothing available every
    sample is 128.  Returns (left, above, corner) uint8."""
    left = _i32(left)
    dev = left.device
    n2 = left.shape[-1]
    s = _scan_pack(left, _i32(above, dev), _i32(corner, dev))
    m = _scan_pack(as_tensor(left_avail, dev).bool(), as_tensor(above_avail, dev).bool(),
                   as_tensor(corner_avail, dev).bool())
    pos = torch.arange(s.shape[-1], device=dev).expand_as(s)
    # The last available position at or before each sample, -1 if none.
    last = torch.where(m, pos, torch.full_like(pos, -1)).cummax(dim=-1).values
    first = m.to(torch.int8).argmax(dim=-1, keepdim=True).expand_as(s)
    vals = torch.gather(s, -1, torch.where(last >= 0, last, first))
    vals = torch.where(m.any(dim=-1, keepdim=True), vals, torch.full_like(vals, 128))
    return tuple(p.to(torch.uint8) for p in _scan_unpack(vals, n2))


def filter_references(left, above, corner, n: int, strong=None):
    """Reference-sample smoothing (H.265 8.4.4.2.3): [1 2 1] / 4 along the
    scan-order run, endpoints unchanged.  ``strong`` ((...,) bool, n = 32
    only) selects the strong bilinear smoothing per block: each edge run
    interpolated between the corner and its outermost sample.  Returns
    (left, above, corner) uint8."""
    left = _i32(left)
    dev = left.device
    above, corner = _i32(above, dev), _i32(corner, dev)
    n2 = left.shape[-1]
    s = _scan_pack(left, above, corner)
    interior = (s[..., :-2] + 2 * s[..., 1:-1] + s[..., 2:] + 2) >> 2
    lf, af, cf = _scan_unpack(torch.cat([s[..., :1], interior, s[..., -1:]], dim=-1), n2)
    if strong is not None:
        if n2 != 64:
            raise ValueError("strong smoothing is defined for 32x32 blocks")
        strong = as_tensor(strong, dev).bool()
        c = corner[..., None]
        k = torch.arange(n2, dtype=torch.int32, device=dev)
        a_end, l_end = above[..., n2 - 1:], left[..., n2 - 1:]
        a_str = ((63 - k) * c + (k + 1) * a_end + 32) >> 6
        l_str = ((63 - k) * c + (k + 1) * l_end + 32) >> 6
        a_str[..., n2 - 1] = a_end[..., 0]
        l_str[..., n2 - 1] = l_end[..., 0]
        lf = torch.where(strong[..., None], l_str, lf)
        af = torch.where(strong[..., None], a_str, af)
        cf = torch.where(strong, corner, cf)
    return lf.to(torch.uint8), af.to(torch.uint8), cf.to(torch.uint8)


def strong_smoothing_condition(left, above, corner, bit_depth: int = 8) -> torch.Tensor:
    """The 32x32 flatness test gating strong smoothing (8.4.4.2.3): both
    edges near-linear within 1 << (BitDepth - 5).  Returns (...,) bool."""
    left = _i32(left)
    a, c = _i32(above, left.device), _i32(corner, left.device)
    thr = 1 << (bit_depth - 5)
    cond_a = (c + a[..., 63] - 2 * a[..., 31]).abs() < thr
    cond_l = (c + left[..., 63] - 2 * left[..., 31]).abs() < thr
    return cond_a & cond_l


def filter_flag(mode: int, n: int) -> bool:
    """Whether mode ``mode`` predicts from the filtered reference samples of
    an n x n luma block (H.265 8.4.4.2.3 filterFlag)."""
    if mode == 1 or n not in _FILTER_THRES:
        return False
    return min(abs(mode - 26), abs(mode - 10)) > _FILTER_THRES[n]  # 10 for planar


def pred_intra_dc(left, above, n: int, filter_edge: bool = False) -> torch.Tensor:
    """DC prediction: dcVal = (n + sum(above[:n]) + sum(left[:n])) >>
    (log2(n) + 1); with filter_edge the first row and column are blended
    1:3 with the neighbours.  (..., n, n) uint8."""
    k = n.bit_length() - 1
    left = _i32(left)
    a, l = _i32(above, left.device)[..., :n], left[..., :n]
    dc = (n + a.sum(-1) + l.sum(-1)) >> (k + 1)
    out = dc[..., None, None].expand(*dc.shape, n, n).clone()
    if filter_edge:
        dcb = dc[..., None]
        out[..., 0, :] = (a + 3 * dcb + 2) >> 2
        out[..., :, 0] = (l + 3 * dcb + 2) >> 2
        out[..., 0, 0] = (l[..., 0] + 2 * dc + a[..., 0] + 2) >> 2
    return out.to(torch.uint8)


def pred_intra_planar(left, above, n: int) -> torch.Tensor:
    """Planar prediction (H.265 8.4.4.2.4): ((n-1-x) left[y] + (x+1)
    above[n] + (n-1-y) above[x] + (y+1) left[n] + n) >> (log2(n) + 1)."""
    k = n.bit_length() - 1
    l = _i32(left)
    a = _i32(above, l.device)
    x = torch.arange(n, dtype=torch.int32, device=l.device)
    ax, ly = a[..., None, :n], l[..., :n, None]
    tr, bl = a[..., n, None, None], l[..., n, None, None]
    h = (n - 1 - x)[None, :] * ly + (x + 1)[None, :] * tr
    v = (n - 1 - x)[:, None] * ax + (x + 1)[:, None] * bl
    return ((h + v + n) >> (k + 1)).to(torch.uint8)


def _angular_ref(left, above, corner, n: int, angle: int):
    """The reference run ref[-neg .. 2n] (index offset neg) of a
    vertical-family mode, H.265 8.4.4.2.6 steps 1-2; the horizontal family
    passes left and above swapped."""
    c = corner[..., None]
    pos = torch.cat([c, above], dim=-1)                    # ref[0 .. 2n]
    if angle >= 0:
        return pos, 0
    inv = INV_ANGLES[angle]
    neg_len = -((n * angle) >> 5)
    # ref[x] for x = -neg_len .. -1 is p[-1][y0], the corner where y0 = -1.
    # At angle -2 the run computes one sample no prediction reads, at a y0
    # past the edge; its index is clamped, as JAX's indexing clamps it.
    y0s = [-1 + ((x * inv + 128) >> 8) for x in range(-neg_len, 0)]
    last = left.shape[-1] - 1
    neg = torch.stack([c[..., 0] if y0 < 0 else left[..., min(y0, last)] for y0 in y0s],
                      dim=-1)
    return torch.cat([neg, pos], dim=-1), neg_len


@functools.lru_cache(maxsize=256)
def _angular_tables(n: int, angle: int, off: int, length: int, device: torch.device):
    """(gather (n, n), next (n, n) int64 indices into the reference run of
    ``length`` samples, weight (n, 1) int32) of one angle, made once per
    device without a host synchronisation."""
    yy = np.arange(1, n + 1)
    i_idx, i_fact = (yy * angle) >> 5, (yy * angle) & 31
    gather = off + np.arange(n)[None, :] + i_idx[:, None] + 1
    # At angle +-32 the second sample of the last column lies one past the
    # run; its weight is 0 there, so the index is clamped.
    nxt = np.minimum(gather + 1, length - 1)
    return (to_device(gather, torch.int64, device), to_device(nxt, torch.int64, device),
            to_device(i_fact[:, None], torch.int32, device))


def pred_intra_angular(left, above, corner, n: int, mode: int,
                       filter_edge: bool = False) -> torch.Tensor:
    """Angular prediction, modes 2..34 (H.265 8.4.4.2.6); filter_edge
    smooths the boundary of the pure horizontal and vertical modes (10 and
    26) of luma blocks below 32x32.  (..., n, n) uint8."""
    if not 2 <= mode <= 34:
        raise ValueError(f"angular modes are 2..34, got {mode}")
    left = _i32(left)
    above, corner = _i32(above, left.device), _i32(corner, left.device)
    angle = ANGLES[mode]
    vertical = mode >= 18
    if not vertical:
        left, above = above, left          # horizontal family: swap, then transpose
    ref, off = _angular_ref(left, above, corner, n, angle)
    gather, nxt, w = _angular_tables(n, angle, off, ref.shape[-1], ref.device)
    out = ((32 - w) * ref[..., gather] + w * ref[..., nxt] + 16) >> 5
    if filter_edge and angle == 0 and n < 32:
        # In the swapped frame `above` is the main edge and `left` the side.
        delta = (left[..., :n] - corner[..., None]) >> 1
        out[..., :, 0] = (above[..., :1] + delta).clamp(0, 255)
    out = out.clamp(0, 255).to(torch.uint8)
    return out if vertical else out.transpose(-1, -2)


def pred_intra(mode: int, left, above, corner, n: int,
               filter_edge: bool = False) -> torch.Tensor:
    """One of the 35 HEVC intra modes (0 planar, 1 DC, 2..34 angular)."""
    if mode == 0:
        return pred_intra_planar(left, above, n)
    if mode == 1:
        return pred_intra_dc(left, above, n, filter_edge)
    return pred_intra_angular(left, above, corner, n, mode, filter_edge)


def pred_intra_all_modes(left, above, corner, n: int) -> torch.Tensor:
    """All 35 modes, (..., 35, n, n) uint8."""
    return torch.stack([pred_intra(m, left, above, corner, n) for m in range(35)], dim=-3)
