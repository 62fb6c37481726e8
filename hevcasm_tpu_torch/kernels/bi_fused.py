"""Kernel B3: bi-prediction refine + combine fused with the 8x8 residual.

``bi_ctu_fused_dma`` replaces the TPU kernel
``hevcasm_tpu/kernels/interp_pallas.py`` ``bi_ctu_fused_dma``
(``_bi_kernel_dma`` -> ``_refine_core`` per reference ->
``residual_pallas.residual_core_stacked``).  The CUDA source is
``csrc/bi_fused.cu``; its header says what bounds it on the card.  Beside
it stands the plain PyTorch version, ``bi_ctu_fused_dma_ref``.

Contract, for n CTUs of 64x64 and 8x8 TUs: src_ctus (n, 64, 64) uint8;
ref_plane (Hp, Wp) uint8, usually two padded reference planes stacked by
rows (the caller adds the lower plane's row offset to offsets1); offsets0
and offsets1 (n, 2) int32, the [y, x] top-left of each CTU's 71x71 refine
window per reference (a start past the plane's end is clamped so the
window fits); the quantizer parameters are ints inside the ranges the HEVC
reference asserts, or 0-d integer tensors on the frame's device with an
optional ``range_flag``, as for K2 (kernels.inter_fused: the device-q C
entry ``hevc_bi_fused_q``).  Each reference is refined on its own (QPEL_SCORE, first
minimum in yf*4 + xf order); the winners' int16 (acc >> 6) intermediates
are combined as Clip3(0, 255, (p0 + p1 + 64) >> 7) and coded.  Returns
(rec (n, 64, 64) uint8, frac0 (n,) int32, frac1 (n,) int32, nnz (n, 8, 8)
int32, bits (n, 8, 8) int32).
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.pred_inter import pred_uni_16, refine_qpel
from ..utils.tensor import TAPS, as_tensor, extract_windows
from . import build
from .inter_fused import CTU, TU, WIN, _check, _check_quant, _launch_fused, residual_8x8

__all__ = ["bi_ctu_fused_dma", "bi_ctu_fused_dma_ref"]


def _check_bi(src, plane, offsets0, offsets1) -> None:
    _check(src, plane, offsets0)
    if offsets1.shape != offsets0.shape:
        raise ValueError(f"offsets1 must be ({src.shape[0]}, 2), got {tuple(offsets1.shape)}")


def bi_ctu_fused_dma_ref(src_ctus, ref_plane, offsets0, offsets1, qscale,
                         qshift, qoffset, dscale, dshift, group: int = 6, range_flag=None):
    """Plain version, the staged composition the TPU kernel is exact with:
    gather both windows, refine each (ops.pred_inter.refine_qpel), take
    pred_uni_16 at each winner, combine (p0 + p1 + 64) >> 7, then the REF
    residual pipeline with nnz and Exp-Golomb bits per 8x8 TU.  ``group``
    is accepted for signature parity and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets0 = as_tensor(offsets0, src.device)
    offsets1 = as_tensor(offsets1, src.device)
    _check_bi(src, plane, offsets0, offsets1)
    _check_quant(qscale, qshift, qoffset, dshift, range_flag)
    preds16, fracs = [], []
    for offsets in (offsets0, offsets1):
        win = extract_windows(plane, offsets, WIN)
        _, frac, _ = refine_qpel(src, win)
        preds16.append(pred_uni_16(win, frac % 4, frac // 4, TAPS).to(torch.int32))
        fracs.append(frac)
    pred = ((preds16[0] + preds16[1] + 64) >> 7).clamp(0, 255).to(torch.uint8)
    rec, nnz, bits = residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift,
                                  range_flag)
    return rec, fracs[0], fracs[1], nnz, bits


def bi_ctu_fused_dma(src_ctus, ref_plane, offsets0, offsets1, qscale, qshift,
                     qoffset, dscale, dshift, group: int = 6, range_flag=None):
    """Fused bi refine + combine + residual.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot be
    built or launched).  ``group`` is accepted and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets0 = as_tensor(offsets0, src.device)
    offsets1 = as_tensor(offsets1, src.device)
    qargs = (qscale, qshift, qoffset, dscale, dshift)
    if src.device.type == "cpu":
        return bi_ctu_fused_dma_ref(src, plane, offsets0, offsets1, *qargs,
                                    range_flag=range_flag)
    tensors = (src, plane, offsets0, offsets1)
    if src.device.type != "cuda" or {t.device for t in tensors} != {src.device}:
        raise ValueError("bi_ctu_fused_dma: tensors on "
                         f"{', '.join(str(t.device) for t in tensors)}; need one CUDA device")
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8 \
            or offsets0.dtype != torch.int32 or offsets1.dtype != torch.int32:
        raise TypeError("bi_ctu_fused_dma: src_ctus and ref_plane must be uint8 "
                        "and the offsets int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bi_ctu_fused_dma: inputs must be contiguous")
    _check_bi(src, plane, offsets0, offsets1)
    n = src.shape[0]
    dev = src.device
    k = CTU // TU
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    frac0 = torch.empty((n,), dtype=torch.int32, device=dev)
    frac1 = torch.empty((n,), dtype=torch.int32, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    bits = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    _launch_fused(bi_ctu_fused_dma, "hevc_bi_fused",
                  (src.data_ptr(), plane.data_ptr(), offsets0.data_ptr(), offsets1.data_ptr(),
                   rec.data_ptr(), frac0.data_ptr(), frac1.data_ptr(), nnz.data_ptr(),
                   bits.data_ptr(), n, plane.shape[0], plane.shape[1]), qargs, range_flag, dev)
    return rec, frac0, frac1, nnz, bits


bi_ctu_fused_dma.launches = bi_ctu_fused_dma.device_q_launches = 0

registry.register("bi_ctu_fused_dma", Tier.REF, bi_ctu_fused_dma_ref)
registry.register("bi_ctu_fused_dma", Tier.KERNEL, bi_ctu_fused_dma)
