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

import numpy as np
import torch

from ..utils.tensor import as_tensor, first_min

__all__ = ["KERNEL8", "KERNEL4", "pred_uni", "qpel_score", "refine_qpel"]

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
    """Valid FIR along ``axis`` (-1 or -2): sum_k coef[k] * x[shifted k],
    int32.  ``coef`` is a sequence of ints shared by the whole batch."""
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


def _hv(window: torch.Tensor, xfrac: int, yfrac: int, taps: int) -> torch.Tensor:
    """Pre-shift vertical accumulation (int32) of shape (..., h, w)."""
    kern = KERNEL8 if taps == 8 else KERNEL4
    h = window.shape[-2] - taps + 1
    w = window.shape[-1] - taps + 1
    x = window.to(torch.int32)
    inter = _wrap16(_fir(x, kern[xfrac], axis=-1, out_len=w))
    return _fir(inter, kern[yfrac], axis=-2, out_len=h)


def pred_uni(window, xfrac: int, yfrac: int, taps: int = 8) -> torch.Tensor:
    """Uni-prediction 8to8: (..., h+t-1, w+t-1) uint8 -> (..., h, w) uint8,
    for one (xfrac, yfrac) shared by the batch."""
    acc = _hv(as_tensor(window), xfrac, yfrac, taps)
    return ((acc + 2048) >> 12).clamp(0, 255).to(torch.uint8)


def qpel_score(acc: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The quarter-pel candidate metric shared by every refinement tier:

        score = sum_px |acc - (src << 12)| >> 4

    on the pre-shift vertical accumulator ``acc`` (..., b, b) int32.  Each
    term is below 2^18, so a 64x64 sum stays below 2^30.  Returns (...,)
    int32."""
    d = (acc - (src.to(torch.int32) << 12)).abs() >> 4
    return d.sum(dim=(-2, -1), dtype=torch.int32)


def refine_qpel(src_ctus, windows):
    """Quarter-pel candidate sweep: interpolate all 16 (yf, xf) luma
    fractions from the extended windows, score each by qpel_score on the
    pre-shift accumulator, and keep the first minimum in yf*4 + xf order.

    src_ctus (n, b, b) uint8; windows (n, b+7, b+7) uint8 anchored at the
    integer MV.  Returns (pred (n, b, b) uint8, frac (n,) int32 = yf*4+xf,
    cost (n,) int32).
    """
    src_ctus = as_tensor(src_ctus)
    windows = as_tensor(windows, src_ctus.device)
    b = src_ctus.shape[-1]
    win32 = windows.to(torch.int32)
    # 4 H passes shared by the 4 vertical fractions.
    h_pass = [_wrap16(_fir(win32, KERNEL8[xf], axis=-1, out_len=b))
              for xf in range(4)]
    accs = torch.stack(
        [_fir(h_pass[xf], KERNEL8[yf], axis=-2, out_len=b)
         for yf in range(4) for xf in range(4)], dim=1)      # (n, 16, b, b)
    frac, cost = first_min(qpel_score(accs, src_ctus[:, None]))
    acc = torch.take_along_dim(accs, frac.long()[:, None, None, None], dim=1)[:, 0]
    pred = ((acc + 2048) >> 12).clamp(0, 255).to(torch.uint8)
    return pred, frac, cost
