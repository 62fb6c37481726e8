"""Kernel K2: quarter-pel refinement fused with the 8x8 residual pipeline.

``inter_ctu_fused_dma`` replaces the TPU kernel
``hevcasm_tpu/kernels/interp_pallas.py`` ``inter_ctu_fused_dma``
(``_inter_kernel_dma`` -> ``_group_body`` ->
``residual_pallas.residual_core_stacked``).  The CUDA source is
``csrc/inter_fused.cu``; its header says what bounds it on the card.
Beside it stands the plain PyTorch version, ``inter_ctu_fused_dma_ref``.

Contract, for n CTUs of 64x64 and 8x8 TUs: src_ctus (n, 64, 64) uint8;
ref_plane (Hp, Wp) uint8; offsets (n, 2) int32, the [y, x] top-left of each
CTU's 71x71 refine window in the plane (a start past the plane's end is
clamped so the window fits); the quantizer parameters are ints inside the
ranges the HEVC reference asserts.  Returns (rec (n, 64, 64) uint8,
frac (n,) int32 = yf*4 + xf, cost (n,) int32 QPEL_SCORE of the winner,
nnz (n, 8, 8) int32 coded coefficients per TU, bits (n, 8, 8) int32
Exp-Golomb bit costs per TU).
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..encode.motion import TAPS, extract_windows
from ..ops.pred_inter import refine_qpel
from ..ops.quantize import check_quant_params
from ..ops.residual import bits_egk, residual_levels
from ..utils.tensor import as_tensor
from . import build

__all__ = ["inter_ctu_fused_dma", "inter_ctu_fused_dma_ref"]

CTU = 64
TU = 8
WIN = CTU + TAPS - 1


def _check(src: torch.Tensor, plane: torch.Tensor, offsets: torch.Tensor,
           qscale, qshift, qoffset, dscale, dshift) -> None:
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"src_ctus must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    if plane.dim() != 2 or min(plane.shape) < WIN:
        raise ValueError(f"ref_plane must be 2-D and at least {WIN}x{WIN}, "
                         f"got {tuple(plane.shape)}")
    if offsets.shape != (src.shape[0], 2):
        raise ValueError(f"offsets must be ({src.shape[0]}, 2), got {tuple(offsets.shape)}")
    check_quant_params(qscale, qshift, qoffset)
    if not 1 <= int(dshift) <= 31:
        raise ValueError(f"dshift={dshift} outside [1, 31]")


def residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift):
    """The fused kernels' residual stage, plain: the REF pipeline over 8x8
    TUs of (n, 64, 64) stacks.  Returns (rec (n, 64, 64) uint8, nnz and
    Exp-Golomb bits per TU, each (n, 8, 8) int32)."""
    rec, levels, _ = residual_levels(src, pred, qscale, qshift, qoffset,
                                     dscale, dshift, tu=TU)
    k = CTU // TU
    levels = levels.reshape(src.shape[0], k, k, TU, TU)
    nnz = (levels != 0).sum(dim=(-2, -1), dtype=torch.int32)
    bits = bits_egk(levels).sum(dim=(-2, -1), dtype=torch.int32)
    return rec, nnz, bits


def inter_ctu_fused_dma_ref(src_ctus, ref_plane, offsets, qscale, qshift,
                            qoffset, dscale, dshift, group: int = 6):
    """Plain version, equal to the TPU kernel's ``_group_body``: gather the
    71x71 windows, refine (ops.pred_inter.refine_qpel), then run the REF
    residual pipeline and count nnz and Exp-Golomb bits per 8x8 TU.
    ``group`` is accepted for signature parity and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets = as_tensor(offsets, src.device)
    _check(src, plane, offsets, qscale, qshift, qoffset, dscale, dshift)
    win = extract_windows(plane, offsets, WIN)
    pred, frac, cost = refine_qpel(src, win)
    rec, nnz, bits = residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift)
    return rec, frac, cost, nnz, bits


def inter_ctu_fused_dma(src_ctus, ref_plane, offsets, qscale, qshift,
                        qoffset, dscale, dshift, group: int = 6):
    """Fused refine + residual.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched).  ``group`` is accepted and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets = as_tensor(offsets, src.device)
    if src.device.type == "cpu":
        return inter_ctu_fused_dma_ref(src, plane, offsets, qscale, qshift,
                                       qoffset, dscale, dshift)
    if src.device.type != "cuda" or {plane.device, offsets.device} != {src.device}:
        raise ValueError(f"inter_ctu_fused_dma: tensors on {src.device}, "
                         f"{plane.device} and {offsets.device}; need one CUDA device")
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8 \
            or offsets.dtype != torch.int32:
        raise TypeError("inter_ctu_fused_dma: src_ctus and ref_plane must be "
                        "uint8 and offsets int32")
    if not (src.is_contiguous() and plane.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("inter_ctu_fused_dma: inputs must be contiguous")
    _check(src, plane, offsets, qscale, qshift, qoffset, dscale, dshift)
    n = src.shape[0]
    dev = src.device
    k = CTU // TU
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    cost = torch.empty((n,), dtype=torch.int32, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    bits = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.hevc_inter_fused(
        src.data_ptr(), plane.data_ptr(), offsets.data_ptr(), rec.data_ptr(),
        frac.data_ptr(), cost.data_ptr(), nnz.data_ptr(), bits.data_ptr(), n,
        plane.shape[0], plane.shape[1], int(qscale), int(qshift), int(qoffset),
        int(dscale), int(dshift), dev.index or 0, stream)
    build.check(err, "inter_ctu_fused_dma")
    inter_ctu_fused_dma.launches += 1
    return rec, frac, cost, nnz, bits


inter_ctu_fused_dma.launches = 0

registry.register("inter_ctu_fused_dma", Tier.REF, inter_ctu_fused_dma_ref)
registry.register("inter_ctu_fused_dma", Tier.KERNEL, inter_ctu_fused_dma)
