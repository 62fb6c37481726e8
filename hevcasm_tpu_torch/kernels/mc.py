"""Kernels B5 and B6: uni- and bi-prediction of blocks at given fractions.

``pred_uni_batched`` / ``pred_uni`` replace the TPU kernels
``hevcasm_tpu/kernels/mc_pallas.py`` ``pred_uni_pallas_batched`` /
``pred_uni_pallas`` (body ``_uni_kernel``), and ``pred_bi_batched`` /
``pred_bi`` the TPU kernels ``pred_bi_pallas_batched`` / ``pred_bi_pallas``
(``_bi_kernel``).  They are the two C entries of ``csrc/mc.cu``, both FIR
passes on the u8/s8 tensor cores (``csrc/mc_tc.cuh``, whose header gives
the tiling; mc.cu's says what bounds them on the card).  Beside each
stands its plain PyTorch version (``*_ref``, over ``ops.pred_inter``).

Contracts (taps 8: the luma quarter-pel KERNEL8, fractions 0-3; taps 4: the
chroma eighth-pel KERNEL4, fractions 0-7):

* ``pred_uni_batched(windows, xfrac, yfrac, h, w, taps=8)``: windows (n, >=
  h + taps - 1, >= w + taps - 1) uint8 (only the top-left of that size is
  read) -> (n, h, w) uint8, ``ops.pred_inter.pred_uni`` of each block.
* ``pred_uni(window, xfrac, yfrac, taps=8)``: window (..., h + taps - 1, w
  + taps - 1) uint8 -> (..., h, w) uint8; the leading axes are flattened
  into blocks and restored.
* ``pred_bi_batched(w0, w1, xf0, yf0, xf1, yf1, h, w, taps=8)`` and
  ``pred_bi(window0, window1, xf0, yf0, xf1, yf1, taps=8)``: the same
  shapes, ``ops.pred_inter.pred_bi`` of each pair of blocks.

A fraction is a Python int, checked on the host (ValueError outside the
family's range), or an integer tensor or array with one value per block (n
values, or one for all), which is read on the card (an int32 tensor there
as it is, anything else after one copy): a device value out of range is
taken modulo the phase count (4 or 8) by the kernel, where the plain
version fails on it.  The kernel takes any h, w >= 1 whose staged windows
fit in one CTA's shared memory (227 KB: 16 (ceil(h / 16) + 1) rows of
about w + 32 bytes a window, so blocks of 128 x 128 and more); the TPU
kernels' w + taps - 1 <= 128 was a lane-layout limit.  They are the KERNEL
tiers of the registry's ``pred_uni`` and ``pred_bi``.
"""

from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from .. import registry
from ..config import Tier
# The plain versions of pred_uni and pred_bi are the REF ops themselves.
from ..ops.pred_inter import pred_bi as pred_bi_ref
from ..ops.pred_inter import pred_uni as pred_uni_ref
from ..utils.tensor import as_tensor
from . import build

__all__ = ["pred_uni", "pred_uni_ref", "pred_uni_batched", "pred_uni_batched_ref",
           "pred_bi", "pred_bi_ref", "pred_bi_batched", "pred_bi_batched_ref", "MAX_SMEM"]

PHASES = {8: 4, 4: 8}                # fractions per filter family
MAX_SMEM = 232448                    # shared memory one block may opt in to (227 KB)


def _check_taps(taps: int) -> int:
    if taps not in PHASES:
        raise ValueError(f"taps={taps}: the filters have 8 (luma) or 4 (chroma) taps")
    return PHASES[taps]


def _crop(windows: torch.Tensor, h: int, w: int, taps: int, what: str) -> torch.Tensor:
    if windows.dim() != 3 or h < 1 or w < 1 or windows.shape[1] < h + taps - 1 \
            or windows.shape[2] < w + taps - 1:
        raise ValueError(f"{what}: windows must be (n, >= {h + taps - 1}, >= {w + taps - 1}) "
                         f"for {h}x{w} blocks at {taps} taps, got {tuple(windows.shape)}")
    return windows[:, :h + taps - 1, :w + taps - 1]


def _plain_frac(frac, device):
    """A fraction as the plain version takes it: the int, or an integer
    tensor of one value per block (n,) or one for all."""
    if isinstance(frac, (int, np.integer)):
        return int(frac)
    return as_tensor(frac, device).reshape(-1)


def pred_uni_batched_ref(windows, xfrac, yfrac, h: int, w: int, taps: int = 8):
    """Plain version: ops.pred_inter.pred_uni on each block's window."""
    windows = as_tensor(windows)
    _check_taps(taps)
    win = _crop(windows, h, w, taps, "pred_uni_batched")
    return pred_uni_ref(win, _plain_frac(xfrac, win.device), _plain_frac(yfrac, win.device),
                        taps)


def pred_bi_batched_ref(w0, w1, xf0, yf0, xf1, yf1, h: int, w: int, taps: int = 8):
    """Plain version: ops.pred_inter.pred_bi on each pair of windows."""
    w0 = as_tensor(w0)
    w1 = as_tensor(w1, w0.device)
    _check_taps(taps)
    fr = [_plain_frac(f, w0.device) for f in (xf0, yf0, xf1, yf1)]
    return pred_bi_ref(_crop(w0, h, w, taps, "pred_bi_batched"),
                       _crop(w1, h, w, taps, "pred_bi_batched"), *fr, taps)


_ARGS = struct.Struct("25q")         # csrc/mc_tc.cuh McArgs
_U8, _I32 = torch.uint8, torch.int32


@functools.lru_cache(maxsize=None)
def _smem(bi: bool, h: int, w: int) -> int:
    """Shared bytes of one CTA of csrc/mc.cu (mctc::geometry): the block's
    staged windows, 16 (steps + 1) rows of 16 x an odd number >= strips + 2
    bytes each."""
    strips, steps = -(-w // 16), -(-h // 16)
    return (2 if bi else 1) * 16 * (steps + 1) * 16 * ((strips + 2) | 1)


def _card_frac(frac, n: int, phases: int, dev: torch.device, what: str):
    """(pointer, stride, value, tensor) of a fraction for the C entry: an
    int is checked here and passed by value; anything else goes to the
    card as int32 (one value for all blocks at stride 0)."""
    if isinstance(frac, (int, np.integer)):
        if not 0 <= int(frac) < phases:
            raise ValueError(f"{what}: fraction {int(frac)} outside [0, {phases})")
        return 0, 0, int(frac), None
    t = as_tensor(frac, dev).reshape(-1)
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise TypeError(f"{what}: fractions must be integers, got {t.dtype}")
    if t.numel() not in (1, n):
        raise ValueError(f"{what}: {t.numel()} fractions for {n} blocks")
    t = t.to(_I32).contiguous()
    return t.data_ptr(), int(t.numel() > 1), 0, t


def _frac(frac, n: int, phases: int, card: int):
    """A fraction the launch path takes as it is, as _card_frac gives it:
    an int in range, or an int32 tensor on card ``card`` of n values (or
    one); None for anything else."""
    if type(frac) is int:
        return (0, 0, frac, None) if 0 <= frac < phases else None
    if type(frac) is torch.Tensor and frac.dtype is _I32 and frac.is_cuda \
            and frac.get_device() == card:
        m = frac.numel()
        if m == 1:
            return frac.data_ptr(), 0, 0, frac
        if m == n and frac.dim() == 1:
            return frac.data_ptr(), frac.stride(0), 0, frac
    return None


def _operand(what: str, windows: torch.Tensor, h: int, w: int, taps: int) -> torch.Tensor:
    if windows.dtype != torch.uint8:
        raise TypeError(f"{what}: windows must be uint8, got {windows.dtype}")
    win = _crop(windows, h, w, taps, what)
    return win if win.stride(-1) == 1 else win.contiguous()


def _enqueue(what: str, bi: bool, card: int, wins, fr, n: int, h: int, w: int,
             taps: int) -> torch.Tensor:
    """Launch B5 or B6 on card ``card`` (its index) on checked operands: (n,
    >= h + taps - 1, >= w + taps - 1) uint8 windows with contiguous rows,
    fractions as _card_frac gives them (2 for B5, 4 for B6)."""
    out = torch.empty((n, h, w), dtype=_U8, device=card)
    w0, w1 = wins[0], wins[-1]
    s0, s1 = w0.stride(), w1.stride()
    f = fr if bi else (*fr, (0, 0, 0, None), (0, 0, 0, None))
    lib = build.load()
    err = (lib.hevc_pred_bi if bi else lib.hevc_pred_uni)(_ARGS.pack(
        w0.data_ptr(), w1.data_ptr(), s0[0], s1[0], s0[1], s1[1],
        f[0][0], f[1][0], f[2][0], f[3][0], f[0][1], f[1][1], f[2][1], f[3][1],
        f[0][2], f[1][2], f[2][2], f[3][2],
        out.data_ptr(), n, h, w, taps, card, build.raw_stream(card)))
    build.check(err, what)
    return out


# B5's and B6's calls are host-bound at the frame shapes (the kernel takes a
# few microseconds), so, as B10's, the launch path does per call only what
# it must: for (n, H, W) uint8 windows with contiguous rows on one card and
# fractions that are ints in range or int32 tensors there, it reads shapes,
# strides and pointers inline and hands the C entry one packed block (no
# fraction is copied: one value for all blocks goes at stride 0).  Every
# other layout, and every error, goes through _launch's checks.
def _fast(what: str, bi: bool, wins, fracs, h: int, w: int, taps: int):
    phases = PHASES.get(taps)
    w0 = wins[0]
    if phases is None or not w0.is_cuda or h < 1 or w < 1:
        return None
    shape, card = w0.shape, w0.get_device()
    if len(shape) != 3:
        return None
    n = shape[0]
    for x in wins:
        s = x.shape
        if x.dtype is not _U8 or len(s) != 3 or s[0] != n or s[1] < h + taps - 1 \
                or s[2] < w + taps - 1 or x.stride(2) != 1 or not x.is_cuda \
                or x.get_device() != card:
            return None
    if _smem(bi, h, w) > MAX_SMEM:
        return None
    fr = [_frac(f, n, phases, card) for f in fracs]
    if None in fr:
        return None
    return _enqueue(what, bi, card, wins, fr, n, h, w, taps)


def _launch(what: str, bi: bool, wins, fracs, h: int, w: int, taps: int) -> torch.Tensor:
    """Check the operands of B5 (one window stack) or B6 (two) and launch
    the C entry; fracs are (xf, yf) per window stack."""
    out = _fast(what, bi, wins, fracs, h, w, taps)
    if out is not None:
        return out
    phases = _check_taps(taps)
    dev = build.on_card(what, *wins)
    wins = [_operand(what, x, h, w, taps) for x in wins]
    n = wins[0].shape[0]
    if any(x.shape[0] != n for x in wins):
        raise ValueError(f"{what}: window stacks of {[x.shape[0] for x in wins]} blocks")
    if _smem(bi, h, w) > MAX_SMEM:
        raise ValueError(f"{what}: {h}x{w} blocks at {taps} taps need more than "
                         f"{MAX_SMEM} bytes of shared memory")
    fr = [_card_frac(f, n, phases, dev, what) for f in fracs]
    return _enqueue(what, bi, dev.index, wins, fr, n, h, w, taps)


def pred_uni_batched(windows, xfrac, yfrac, h: int, w: int, taps: int = 8) -> torch.Tensor:
    """(n, h, w) uint8 uni-prediction of each block.  CPU tensors run the
    plain version; CUDA tensors launch B5 (and raise if it cannot be built
    or launched, or the shape is one it does not take)."""
    windows = as_tensor(windows)
    if windows.is_cpu:
        return pred_uni_batched_ref(windows, xfrac, yfrac, h, w, taps)
    out = _launch("pred_uni_batched", False, [windows], [xfrac, yfrac], h, w, taps)
    pred_uni_batched.launches += 1
    return out


def _flat(window: torch.Tensor, taps: int, what: str):
    """(n, H, W) view (or copy) of (..., H, W) windows (the tensor itself
    when it has three axes), the leading axes, and the block size (h, w)."""
    if window.dim() < 2:
        raise ValueError(f"{what}: windows must be (..., h + {taps - 1}, w + {taps - 1}), "
                         f"got {tuple(window.shape)}")
    *lead, hh, ww = window.shape
    flat = window if len(lead) == 1 else window.reshape(-1, hh, ww)
    return flat, lead, hh - taps + 1, ww - taps + 1


def pred_uni(window, xfrac, yfrac, taps: int = 8) -> torch.Tensor:
    """Uni-prediction (..., h + taps - 1, w + taps - 1) -> (..., h, w)
    uint8, fractions as ints or one per block of the flattened leading
    axes.  CPU tensors run the plain version on the flattened blocks; CUDA
    tensors launch B5 (and raise if it cannot be built or launched, or the
    shape is one it does not take)."""
    window = as_tensor(window)
    _check_taps(taps)
    flat, lead, h, w = _flat(window, taps, "pred_uni")
    if window.is_cpu:
        out = pred_uni_batched_ref(flat, xfrac, yfrac, h, w, taps)
    else:
        out = _launch("pred_uni", False, [flat], [xfrac, yfrac], h, w, taps)
        pred_uni.launches += 1
    return out if flat is window else out.reshape(*lead, h, w)


def pred_bi_batched(w0, w1, xf0, yf0, xf1, yf1, h: int, w: int, taps: int = 8) -> torch.Tensor:
    """(n, h, w) uint8 bi-prediction of each pair of blocks.  CPU tensors
    run the plain version; CUDA tensors launch B6 (and raise if it cannot
    be built or launched, or the shape is one it does not take)."""
    w0 = as_tensor(w0)
    w1 = as_tensor(w1, w0.device)
    if w0.is_cpu:
        return pred_bi_batched_ref(w0, w1, xf0, yf0, xf1, yf1, h, w, taps)
    out = _launch("pred_bi_batched", True, [w0, w1], [xf0, yf0, xf1, yf1], h, w, taps)
    pred_bi_batched.launches += 1
    return out


def pred_bi(window0, window1, xfrac0, yfrac0, xfrac1, yfrac1, taps: int = 8) -> torch.Tensor:
    """Bi-prediction of two (..., h + taps - 1, w + taps - 1) windows ->
    (..., h, w) uint8, fractions as in pred_uni.  CPU tensors run the plain
    version on the flattened blocks; CUDA tensors launch B6 (and raise if it
    cannot be built or launched, or the shape is one it does not take)."""
    window0 = as_tensor(window0)
    window1 = as_tensor(window1, window0.device)
    _check_taps(taps)
    flat0, lead, h, w = _flat(window0, taps, "pred_bi")
    if window1.shape != window0.shape:
        raise ValueError(f"pred_bi: windows {tuple(window0.shape)} and "
                         f"{tuple(window1.shape)} differ")
    flat1 = window1 if flat0 is window0 else window1.reshape(flat0.shape)
    fracs = (xfrac0, yfrac0, xfrac1, yfrac1)
    if window0.is_cpu:
        out = pred_bi_batched_ref(flat0, flat1, *fracs, h, w, taps)
    else:
        out = _launch("pred_bi", True, [flat0, flat1], fracs, h, w, taps)
        pred_bi.launches += 1
    return out if flat0 is window0 else out.reshape(*lead, h, w)


pred_uni_batched.launches = 0
pred_uni.launches = 0
pred_bi_batched.launches = 0
pred_bi.launches = 0

registry.register("pred_uni", Tier.KERNEL, pred_uni)
registry.register("pred_bi", Tier.KERNEL, pred_bi)
