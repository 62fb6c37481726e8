"""Inter prediction: HEVC motion-compensation interpolation (REF tier).

The counterpart of ``hevcasm_tpu.ops.pred_inter``: one always-separable
two-pass path,

  pass1 (H, shift 0)  : p  = sum_k cx[k] * ref[y, x+k-pad]   wrapped to int16
  pass2 (V, shift 12) : out= Clip3(0,255, (sum_k cy[k]*p + 2048) >> 12)

which reduces bit-exactly to the copy / H-only / V-only paths when a
fraction is zero (the filter row is then the unit kernel).

Windows are (..., h + taps - 1, w + taps - 1) with the integer-pel block
origin at (pad, pad), pad = taps//2 - 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tensor import as_tensor, constant, first_min

__all__ = ["KERNEL8", "KERNEL4", "pred_uni", "pred_uni_16", "pred_bi",
           "qpel_score", "qpel_costmap", "refine_qpel_costmap_mxu", "refine_qpel"]

# Luma 8-tap quarter-pel filters (H.265 table 8-11).
KERNEL8 = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [-1, 4, -10, 58, 17, -5, 1, 0],
        [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1],
    ],
    dtype=np.int32,
)

# Chroma 4-tap eighth-pel filters (H.265 table 8-12).
KERNEL4 = np.array(
    [
        [0, 64, 0, 0],
        [-2, 58, 10, -2],
        [-4, 54, 16, -2],
        [-6, 46, 28, -4],
        [-4, 36, 36, -4],
        [-4, 28, 46, -6],
        [-2, 16, 54, -4],
        [-2, 10, 58, -2],
    ],
    dtype=np.int32,
)


def _fir(x: torch.Tensor, coef, axis: int, out_len: int) -> torch.Tensor:
    """Valid FIR along ``axis`` (-1 or -2): sum_k coef[..., k] * x[shifted k],
    int32.  ``coef`` is a numpy row of ints shared by the whole batch (zero
    taps are skipped), or an int32 tensor (..., taps) of per-block rows
    broadcast over the trailing (h, w) axes."""
    if isinstance(coef, torch.Tensor):
        acc = x.narrow(axis, 0, out_len) * coef[..., 0, None, None]
        for k in range(1, coef.shape[-1]):
            acc = acc + x.narrow(axis, k, out_len) * coef[..., k, None, None]
        return acc
    acc = None
    for k, c in enumerate(coef):
        c = int(c)
        if c == 0:
            continue
        term = x.narrow(axis, k, out_len) * c
        acc = term if acc is None else acc + term
    if acc is None:
        shape = list(x.shape)
        shape[axis] = out_len
        acc = x.new_zeros(shape)
    return acc


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """The C int16_t intermediate store: two's-complement wrap to 16 bits,
    kept in int32."""
    return ((x + 32768) & 0xFFFF) - 32768


def _coef(frac, taps: int, device):
    """Filter row(s) for a fraction: the numpy row for an int (the shared
    fast path), else an int32 tensor (..., taps) gathered per block."""
    kern = KERNEL8 if taps == 8 else KERNEL4
    if isinstance(frac, (int, np.integer)):
        return kern[int(frac)]
    frac = as_tensor(frac, device).long()
    return _kern_table(taps, device)[frac]


@functools.lru_cache(maxsize=8)
def _kern_table(taps: int, device) -> torch.Tensor:
    return constant(KERNEL8 if taps == 8 else KERNEL4, torch.int32, device)


def _hv(window: torch.Tensor, xfrac, yfrac, taps: int) -> torch.Tensor:
    """Pre-shift vertical accumulation (int32) of shape (..., h, w)."""
    h = window.shape[-2] - taps + 1
    w = window.shape[-1] - taps + 1
    x = window.to(torch.int32)
    cx = _coef(xfrac, taps, x.device)
    cy = _coef(yfrac, taps, x.device)
    inter = _wrap16(_fir(x, cx, axis=-1, out_len=w))
    return _fir(inter, cy, axis=-2, out_len=h)


def pred_uni(window, xfrac, yfrac, taps: int = 8) -> torch.Tensor:
    """Uni-prediction 8to8: (..., h+t-1, w+t-1) uint8 -> (..., h, w) uint8.
    xfrac/yfrac are ints shared by the batch or integer tensors
    broadcastable over its leading axes (one fraction per block)."""
    acc = _hv(as_tensor(window), xfrac, yfrac, taps)
    return ((acc + 2048) >> 12).clamp(0, 255).to(torch.uint8)


def pred_uni_16(window, xfrac, yfrac, taps: int = 8) -> torch.Tensor:
    """Uni-prediction 8to16, the bi-prediction intermediate: the H pass,
    then the V pass shifted by 6, stored to int16 by two's-complement wrap
    without clipping.  Fractions as in pred_uni."""
    acc = _hv(as_tensor(window), xfrac, yfrac, taps)
    return _wrap16(acc >> 6).to(torch.int16)


def pred_bi(window0, window1, xfrac0, yfrac0, xfrac1, yfrac1,
            taps: int = 8) -> torch.Tensor:
    """Bi-prediction 8to8: two 8to16 uni paths combined as
    Clip3(0, 255, (r0 + r1 + 64) >> 7)."""
    r0 = pred_uni_16(window0, xfrac0, yfrac0, taps).to(torch.int32)
    r1 = pred_uni_16(window1, xfrac1, yfrac1, taps).to(torch.int32)
    return ((r0 + r1 + 64) >> 7).clamp(0, 255).to(torch.uint8)


def qpel_score(acc: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The quarter-pel candidate metric shared by every refinement tier:

        score = sum_px |acc - (src << 12)| >> 4

    on the pre-shift vertical accumulator ``acc`` (..., b, b) int32.  Each
    term is below 2^18, so a 64x64 sum stays below 2^30.  Returns (...,)
    int32."""
    d = (acc - (src.to(torch.int32) << 12)).abs() >> 4
    return d.sum(dim=(-2, -1), dtype=torch.int32)


def _qpel_accs(windows: torch.Tensor, b: int):
    """The 16 pre-shift vertical accumulators (..., b, b) int32 of the
    quarter-pel sweep, in yf*4 + xf order, from windows (..., >= b+7,
    >= b+7) anchored at the integer MV: 4 horizontal passes wrapped to
    int16, each shared by the 4 vertical fractions."""
    win32 = windows[..., : b + 7, : b + 7].to(torch.int32)
    h_pass = [_wrap16(_fir(win32, KERNEL8[xf], axis=-1, out_len=b))
              for xf in range(4)]
    for yf in range(4):
        for xf in range(4):
            yield _fir(h_pass[xf], KERNEL8[yf], axis=-2, out_len=b)


def qpel_costmap(src, windows) -> torch.Tensor:
    """QPEL_SCORE of all 16 quarter-pel candidates, no selection.

    src (n, b, b) uint8; windows (n, >= b+7, >= b+7) uint8 anchored at the
    integer MV (only the top-left (b+7, b+7) is read).  Returns (n, 4, 4)
    int32 indexed [yf, xf]."""
    src = as_tensor(src)
    windows = as_tensor(windows, src.device)
    n, b = src.shape[0], src.shape[-1]
    costs = [qpel_score(acc, src) for acc in _qpel_accs(windows, b)]
    return torch.stack(costs, dim=-1).reshape(n, 4, 4)


def refine_qpel_costmap_mxu(src, windows):
    """The 16-candidate sweep with every prediction, the counterpart of
    ``hevcasm_tpu.kernels.interp_xla.refine_qpel_costmap_mxu`` (XLA there;
    its banded matmuls are a TPU layout device).  src (n, b, b) uint8,
    windows (n, b+7, b+7) uint8.  Returns (preds (n, 16, b, b) uint8,
    costs (n, 16) int32), both in yf*4 + xf order."""
    src = as_tensor(src)
    windows = as_tensor(windows, src.device)
    accs = list(_qpel_accs(windows, src.shape[-1]))
    preds = [((acc + 2048) >> 12).clamp(0, 255).to(torch.uint8) for acc in accs]
    costs = [qpel_score(acc, src) for acc in accs]
    return torch.stack(preds, dim=1), torch.stack(costs, dim=1)


def refine_qpel(src_ctus, windows):
    """Quarter-pel candidate sweep: score the 16 (yf, xf) luma fractions
    by qpel_costmap, keep the first minimum in yf*4 + xf order, and
    interpolate the winner alone (pred_uni at per-block fractions).

    src_ctus (n, b, b) uint8; windows (n, b+7, b+7) uint8 anchored at the
    integer MV.  Returns (pred (n, b, b) uint8, frac (n,) int32 = yf*4+xf,
    cost (n,) int32).
    """
    src_ctus = as_tensor(src_ctus)
    windows = as_tensor(windows, src_ctus.device)
    n = src_ctus.shape[0]
    frac, cost = first_min(qpel_costmap(src_ctus, windows).reshape(n, 16))
    pred = pred_uni(windows, frac % 4, frac // 4)
    return pred, frac, cost
