"""Kernels K2, B16 and B11: the quarter-pel refinement, fused with the 8x8
residual pipeline (K2, B16) or alone (B11).

``inter_ctu_fused_dma`` replaces the TPU kernel
``hevcasm_tpu/kernels/interp_pallas.py`` ``inter_ctu_fused_dma``
(``_inter_kernel_dma`` -> ``_group_body`` ->
``residual_pallas.residual_core_stacked``); ``inter_ctu_fused`` and
``inter_ctu_fused_batched`` the TPU kernels of those names
(``_inter_kernel``, ``_inter_kernel_group``); ``refine_quarter_pel_fused``
the TPU kernel of that name (``_kernel`` -> ``_refine_core``).  The CUDA
sources are ``csrc/inter_fused.cu`` (K2, and B16, which launches K2's kernel
on the gathered windows) and ``csrc/refine_fused.cu`` (B11); their headers
say what bounds them on the card.  Beside each stands its plain PyTorch
version (``*_ref``).

Contracts, for n CTUs of 64x64 and 8x8 TUs:

* ``inter_ctu_fused_dma(src_ctus, ref_plane, offsets, qscale, qshift,
  qoffset, dscale, dshift)``: src_ctus (n, 64, 64) uint8; ref_plane (Hp,
  Wp) uint8; offsets (n, 2) int32, the [y, x] top-left of each CTU's 71x71
  refine window in the plane (a start past the plane's end is clamped so
  the window fits); the quantizer parameters are ints inside the ranges the
  HEVC reference asserts, or 0-d integer tensors on the frame's device (the
  rate controller's qp kept on the card; below).  Returns (rec (n, 64, 64)
  uint8, frac (n,) int32 = yf*4 + xf, cost (n,) int32 QPEL_SCORE of the
  winner, nnz (n, 8, 8) int32 coded coefficients per TU, bits (n, 8, 8)
  int32 Exp-Golomb bit costs per TU).
* ``inter_ctu_fused(src_ctus, windows, ...)``: the same outputs from
  gathered windows (n, >= 71, >= 71) uint8 at the integer MV, of which the
  top-left 71x71 is read.  ``inter_ctu_fused_batched(..., group)`` is the
  same function (the TPU kernel's CTU groups are a grid-step device; the
  port ignores ``group``).  The TPU kernels take (72, 128) slabs; only
  their top-left 71x71 is ever used, so the port takes any window of at
  least that size.
* ``refine_quarter_pel_fused(src, windows)``: src (n, b, b) uint8 with b in
  {8, 16, 32, 64}, windows (n, >= b+7, >= b+7) uint8 at the integer MV (the
  top-left (b+7)^2 is read).  Returns (pred (n, b, b) uint8, frac (n,)
  int32 = yf*4 + xf, cost (n,) int32).  It is also the KERNEL tier of the
  registry's ``refine_qpel`` op, as JAX registers it as that op's PALLAS
  tier.

Quantizer parameters as tensors (K2, B16, and B3 in ``bi_fused``): a CUDA
call stacks them into one int32[5] on the card and launches the kernel's
device-q C entry (``hevc_inter_fused_q``, ``hevc_bi_fused_q``), which reads
them there; a block whose parameters leave their ranges sets their bits
(ops.quantize.QUANT_RANGES) in a 0-d int32 ``range_flag`` and codes
nothing.  Nothing reads the card from the host when the caller passes the
flag, which it reads once later (ops.quantize.raise_on_flag, as the rate
controller does after a GOP); with no flag the call reads its own and
raises ValueError.  The plain versions take the same tensors and flag
(ops.quantize.flag_quant_params).  Each wrapper counts its launches in
``launches``, and those through the device-q entry also in
``device_q_launches``.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.pred_inter import refine_qpel
from ..ops.quantize import check_quant_params, flag_quant_params, raise_on_flag, range_flag
from ..ops.residual import bits_egk, residual_levels
from ..utils.tensor import TAPS, as_tensor, extract_windows, stack_offsets
from . import build

__all__ = ["inter_ctu_fused_dma", "inter_ctu_fused_dma_ref", "inter_ctu_fused",
           "inter_ctu_fused_ref", "inter_ctu_fused_batched", "inter_ctu_fused_batched_ref",
           "refine_quarter_pel_fused", "refine_quarter_pel_fused_ref", "REFINE_BLOCKS"]

CTU = 64
TU = 8
WIN = CTU + TAPS - 1
REFINE_BLOCKS = (8, 16, 32, 64)       # block sides B11 takes


def _check(src: torch.Tensor, plane: torch.Tensor, offsets: torch.Tensor) -> None:
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"src_ctus must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    if plane.dim() != 2 or min(plane.shape) < WIN:
        raise ValueError(f"ref_plane must be 2-D and at least {WIN}x{WIN}, "
                         f"got {tuple(plane.shape)}")
    if offsets.shape != (src.shape[0], 2):
        raise ValueError(f"offsets must be ({src.shape[0]}, 2), got {tuple(offsets.shape)}")


def _check_quant(qscale, qshift, qoffset, dshift, range_flag=None) -> None:
    """The quantizer's asserted ranges and 1 <= dshift <= 31: on the host
    (a tensor is read there), or with ``range_flag`` dshift alone, into the
    flag, since ops.quantize.quantize flags the forward three."""
    if range_flag is not None:
        flag_quant_params(range_flag, dshift=dshift)
        return
    check_quant_params(qscale, qshift, qoffset)
    if not 1 <= int(dshift) <= 31:
        raise ValueError(f"dshift={dshift} outside [1, 31]")


def _launch_fused(wrapper, entry: str, args: tuple, qargs: tuple, flag, dev) -> None:
    """Launch K2's or B3's kernel through C entry ``entry`` with ``args``
    (its pointers and sizes) and the five quantizer parameters: host ints,
    checked here, or tensors, stacked into an int32[5] on ``dev`` for the
    device-q entry ``entry + "_q"`` with the range flag (a new one, read
    here, when ``flag`` is None).  Counts the launch on ``wrapper``."""
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    what = wrapper.__name__
    if not any(isinstance(q, torch.Tensor) for q in qargs):
        _check_quant(*qargs[:3], qargs[4])
        build.check(getattr(lib, entry)(*args, *(int(q) for q in qargs), dev.index or 0,
                                        stream), what)
        wrapper.launches += 1
        return
    for q in qargs:
        if isinstance(q, torch.Tensor) and (q.device != dev or q.numel() != 1
                                            or q.is_floating_point()):
            raise ValueError(f"{what}: a quantizer parameter tensor must hold one "
                             f"integer on {dev}, got {q.dtype} {tuple(q.shape)} on {q.device}")
    qvec = torch.stack([(q if q.dtype == torch.int32 else q.to(torch.int32)).reshape(())
                        if isinstance(q, torch.Tensor)
                        else torch.full((), q, dtype=torch.int32, device=dev)
                        for q in qargs])
    own = flag is None
    if own:
        flag = range_flag(dev)
    elif flag.dtype != torch.int32 or flag.device != dev or flag.dim() != 0:
        raise ValueError(f"{what}: range_flag must be a 0-d int32 tensor on {dev}")
    build.check(getattr(lib, entry + "_q")(*args, qvec.data_ptr(), flag.data_ptr(),
                                           dev.index or 0, stream), what)
    wrapper.launches += 1
    wrapper.device_q_launches += 1
    if own:
        raise_on_flag(flag)


def _check_windows(src: torch.Tensor, windows: torch.Tensor, sizes: tuple[int, ...],
                   what: str) -> int:
    if src.dim() != 3 or src.shape[1] != src.shape[2] or src.shape[1] not in sizes:
        raise ValueError(f"{what}: src must be (n, b, b) with b in {sizes}, "
                         f"got {tuple(src.shape)}")
    b = src.shape[1]
    if windows.dim() != 3 or windows.shape[0] != src.shape[0] \
            or min(windows.shape[1:]) < b + TAPS - 1:
        raise ValueError(f"{what}: windows must be ({src.shape[0]}, >= {b + TAPS - 1}, "
                         f">= {b + TAPS - 1}), got {tuple(windows.shape)}")
    return b


def residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift, range_flag=None):
    """The fused kernels' residual stage, plain: the REF pipeline over 8x8
    TUs of (n, 64, 64) stacks.  Returns (rec (n, 64, 64) uint8, nnz and
    Exp-Golomb bits per TU, each (n, 8, 8) int32)."""
    rec, levels, _ = residual_levels(src, pred, qscale, qshift, qoffset,
                                     dscale, dshift, tu=TU, range_flag=range_flag)
    k = CTU // TU
    levels = levels.reshape(src.shape[0], k, k, TU, TU)
    nnz = (levels != 0).sum(dim=(-2, -1), dtype=torch.int32)
    bits = bits_egk(levels).sum(dim=(-2, -1), dtype=torch.int32)
    return rec, nnz, bits


def inter_ctu_fused_dma_ref(src_ctus, ref_plane, offsets, qscale, qshift,
                            qoffset, dscale, dshift, group: int = 6, range_flag=None):
    """Plain version, equal to the TPU kernel's ``_group_body``: gather the
    71x71 windows, refine (ops.pred_inter.refine_qpel), then run the REF
    residual pipeline and count nnz and Exp-Golomb bits per 8x8 TU.
    ``group`` is accepted for signature parity and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets = as_tensor(offsets, src.device)
    _check(src, plane, offsets)
    _check_quant(qscale, qshift, qoffset, dshift, range_flag)
    win = extract_windows(plane, offsets, WIN)
    pred, frac, cost = refine_qpel(src, win)
    rec, nnz, bits = residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift,
                                  range_flag)
    return rec, frac, cost, nnz, bits


def inter_ctu_fused_dma(src_ctus, ref_plane, offsets, qscale, qshift,
                        qoffset, dscale, dshift, group: int = 6, range_flag=None):
    """Fused refine + residual.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (and raise if it cannot be built or
    launched).  ``group`` is accepted and ignored."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_plane, src.device)
    offsets = as_tensor(offsets, src.device)
    qargs = (qscale, qshift, qoffset, dscale, dshift)
    if src.device.type == "cpu":
        return inter_ctu_fused_dma_ref(src, plane, offsets, *qargs, range_flag=range_flag)
    if src.device.type != "cuda" or {plane.device, offsets.device} != {src.device}:
        raise ValueError(f"inter_ctu_fused_dma: tensors on {src.device}, "
                         f"{plane.device} and {offsets.device}; need one CUDA device")
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8 \
            or offsets.dtype != torch.int32:
        raise TypeError("inter_ctu_fused_dma: src_ctus and ref_plane must be "
                        "uint8 and offsets int32")
    if not (src.is_contiguous() and plane.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("inter_ctu_fused_dma: inputs must be contiguous")
    _check(src, plane, offsets)
    n = src.shape[0]
    dev = src.device
    k = CTU // TU
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    cost = torch.empty((n,), dtype=torch.int32, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    bits = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    _launch_fused(inter_ctu_fused_dma, "hevc_inter_fused",
                  (src.data_ptr(), plane.data_ptr(), offsets.data_ptr(), rec.data_ptr(),
                   frac.data_ptr(), cost.data_ptr(), nnz.data_ptr(), bits.data_ptr(), n,
                   plane.shape[0], plane.shape[1]), qargs, range_flag, dev)
    return rec, frac, cost, nnz, bits


def inter_ctu_fused_ref(src_ctus, windows, qscale, qshift, qoffset, dscale, dshift,
                        range_flag=None):
    """Plain version: ops.pred_inter.refine_qpel on each window's top-left
    71x71, then the REF residual pipeline with nnz and Exp-Golomb bits per
    8x8 TU."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    _check_windows(src, windows, (CTU,), "inter_ctu_fused")
    _check_quant(qscale, qshift, qoffset, dshift, range_flag)
    pred, frac, cost = refine_qpel(src, windows[:, :WIN, :WIN])
    rec, nnz, bits = residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift,
                                  range_flag)
    return rec, frac, cost, nnz, bits


def inter_ctu_fused(src_ctus, windows, qscale, qshift, qoffset, dscale, dshift,
                    range_flag=None):
    """Fused refine + residual on gathered windows.  CPU tensors run the
    plain version; CUDA tensors launch K2's kernel with the contiguous
    window stack viewed as a plane of n * Wh rows, CTU i's window at offset
    (i * Wh, 0) (and raise if it cannot be built or launched)."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    qargs = (qscale, qshift, qoffset, dscale, dshift)
    if src.device.type == "cpu":
        return inter_ctu_fused_ref(src, windows, *qargs, range_flag=range_flag)
    dev = build.on_card("inter_ctu_fused", src, windows)
    if src.dtype != torch.uint8 or windows.dtype != torch.uint8:
        raise TypeError("inter_ctu_fused: src_ctus and windows must be uint8")
    if not (src.is_contiguous() and windows.is_contiguous()):
        raise ValueError("inter_ctu_fused: inputs must be contiguous")
    _check_windows(src, windows, (CTU,), "inter_ctu_fused")
    n, wh, ww = windows.shape
    if n * wh >= 2 ** 31:
        raise ValueError(f"inter_ctu_fused: {n} windows of {wh} rows pass 2^31 rows")
    offsets = stack_offsets(n, wh, dev)
    k = CTU // TU
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    cost = torch.empty((n,), dtype=torch.int32, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    bits = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    _launch_fused(inter_ctu_fused, "hevc_inter_fused",
                  (src.data_ptr(), windows.data_ptr(), offsets.data_ptr(), rec.data_ptr(),
                   frac.data_ptr(), cost.data_ptr(), nnz.data_ptr(), bits.data_ptr(), n,
                   n * wh, ww), qargs, range_flag, dev)
    return rec, frac, cost, nnz, bits


def inter_ctu_fused_batched_ref(src_ctus, windows, qscale, qshift, qoffset, dscale,
                                dshift, group: int = 6, range_flag=None):
    """Plain version: inter_ctu_fused_ref; ``group`` is accepted and ignored."""
    return inter_ctu_fused_ref(src_ctus, windows, qscale, qshift, qoffset, dscale, dshift,
                               range_flag)


def inter_ctu_fused_batched(src_ctus, windows, qscale, qshift, qoffset, dscale, dshift,
                            group: int = 6, range_flag=None):
    """inter_ctu_fused, for any n and ``group`` (accepted and ignored): the
    launch is inter_ctu_fused's and is counted there."""
    return inter_ctu_fused(src_ctus, windows, qscale, qshift, qoffset, dscale, dshift,
                           range_flag)


def refine_quarter_pel_fused_ref(src, windows):
    """Plain version: ops.pred_inter.refine_qpel on each window's top-left
    (b+7)^2."""
    src = as_tensor(src)
    windows = as_tensor(windows, src.device)
    b = _check_windows(src, windows, REFINE_BLOCKS, "refine_quarter_pel_fused")
    return refine_qpel(src, windows[:, :b + TAPS - 1, :b + TAPS - 1])


def refine_quarter_pel_fused(src, windows):
    """(pred, frac, cost).  CPU tensors run the plain version; CUDA tensors
    launch the kernel (and raise if it cannot be built or launched)."""
    src = as_tensor(src)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return refine_quarter_pel_fused_ref(src, windows)
    dev = build.on_card("refine_quarter_pel_fused", src, windows)
    if src.dtype != torch.uint8 or windows.dtype != torch.uint8:
        raise TypeError("refine_quarter_pel_fused: src and windows must be uint8")
    if not src.is_contiguous() or windows.stride(2) != 1 or windows.stride(1) >= 2 ** 31:
        raise ValueError("refine_quarter_pel_fused: src must be contiguous and "
                         "windows rows contiguous")
    b = _check_windows(src, windows, REFINE_BLOCKS, "refine_quarter_pel_fused")
    n = src.shape[0]
    pred = torch.empty((n, b, b), dtype=torch.uint8, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    cost = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.hevc_refine_fused(
        src.data_ptr(), windows.data_ptr(), windows.stride(0), windows.stride(1),
        pred.data_ptr(), frac.data_ptr(), cost.data_ptr(), n, b, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "refine_quarter_pel_fused")
    refine_quarter_pel_fused.launches += 1
    return pred, frac, cost


inter_ctu_fused_dma.launches = inter_ctu_fused_dma.device_q_launches = 0
inter_ctu_fused.launches = inter_ctu_fused.device_q_launches = 0
refine_quarter_pel_fused.launches = 0

registry.register("inter_ctu_fused_dma", Tier.REF, inter_ctu_fused_dma_ref)
registry.register("inter_ctu_fused_dma", Tier.KERNEL, inter_ctu_fused_dma)
registry.register("inter_ctu_fused", Tier.REF, inter_ctu_fused_ref)
registry.register("inter_ctu_fused", Tier.KERNEL, inter_ctu_fused)
registry.register("refine_quarter_pel_fused", Tier.REF, refine_quarter_pel_fused_ref)
registry.register("refine_quarter_pel_fused", Tier.KERNEL, refine_quarter_pel_fused)
registry.register("refine_qpel", Tier.KERNEL, refine_quarter_pel_fused)
