"""Kernel B19: the whole inter inner loop of every 64x64 CTU in one launch:
the exhaustive SSD search with its first minimum, the quarter-pel
refinement at the winner and the 8x8 residual pipeline.

``encode_ctu_mega`` replaces the TPU kernel
``hevcasm_tpu/kernels/mega_pallas.py`` ``encode_ctu_mega`` (body
``_mega_kernel``).  Its CUDA source is ``csrc/mega.cu`` (over
``csrc/ssd_tc_core.cuh``, K1's u8 tensor-core search with B17's keyed
first minimum, then ``refine_core.cuh`` and ``residual_core.cuh``); the
header says what bounds it on the card and which design it takes.
Beside it stands its plain PyTorch version, ``encode_ctu_mega_ref``.

Contract: ``encode_ctu_mega(src_ctus, ref_padded, positions, r, qscale,
qshift, qoffset, dscale, dshift)``: src_ctus (n, 64, 64) uint8;
ref_padded the reference plane padded by r + 3 top/left and r + 4
bottom/right, as the loop pads it (the TPU kernel takes its own plane
padded by r + 8); positions (n, 2) int32 CTU [y, x] in the unpadded frame;
r in {8, 16, 24, 32}, the TPU kernel's range; the quantizer parameters
ints inside the ranges the HEVC reference asserts.  Returns (rec (n, 64,
64) uint8, mv (n, 2) int32 integer-pel [dy, dx], frac (n,) int32 = yf*4 +
xf, best (n,) int32 SSD of the integer winner, nnz (n, 8, 8) int32 coded
coefficients per TU): the outputs of the exhaustive search
(motion.full_search), the refinement and the residual of
``inter_impl="stages"``.  The TPU kernel's ``group`` (its CTU groups) has
no counterpart.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.pred_inter import refine_qpel
from ..utils.tensor import TAPS, as_tensor, extract_windows
from . import build
from .inter_fused import _check_quant, residual_8x8
from .search import search_mv_dma_ref

__all__ = ["encode_ctu_mega", "encode_ctu_mega_ref", "MEGA_RADII"]

CTU = 64
TU = 8
MEGA_RADII = (8, 16, 24, 32)      # the search ranges the TPU kernel takes


def _check(src: torch.Tensor, plane: torch.Tensor, positions: torch.Tensor, r: int,
           qscale, qshift, qoffset, dshift) -> None:
    if r not in MEGA_RADII:
        raise ValueError(f"encode_ctu_mega covers search_range in {MEGA_RADII}, got {r}")
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"src_ctus must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    if plane.dim() != 2 or min(plane.shape) < CTU + 2 * r:
        raise ValueError(f"ref_padded must be 2-D and at least {CTU + 2 * r} square, "
                         f"got {tuple(plane.shape)}")
    if positions.shape != (src.shape[0], 2):
        raise ValueError(f"positions must be ({src.shape[0]}, 2), got {tuple(positions.shape)}")
    _check_quant(qscale, qshift, qoffset, dshift)


def encode_ctu_mega_ref(src_ctus, ref_padded, positions, r: int, qscale, qshift, qoffset,
                        dscale, dshift):
    """Plain version: the exhaustive search and its first minimum
    (kernels.search.search_mv_dma_ref), the refinement
    (ops.pred_inter.refine_qpel) of the 71x71 window at the integer MV, and
    the REF 8x8 residual pipeline."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_padded, src.device)
    positions = as_tensor(positions, src.device)
    _check(src, plane, positions, r, qscale, qshift, qoffset, dshift)
    mv, best = search_mv_dma_ref(src, plane, positions, r)
    win = extract_windows(plane, positions + mv + r, CTU + TAPS - 1)
    pred, frac, _ = refine_qpel(src, win)
    rec, nnz, _ = residual_8x8(src, pred, qscale, qshift, qoffset, dscale, dshift)
    return rec, mv, frac, best, nnz


def encode_ctu_mega(src_ctus, ref_padded, positions, r: int, qscale, qshift, qoffset,
                    dscale, dshift):
    """Search + refine + residual of every CTU.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot be
    built or launched)."""
    src = as_tensor(src_ctus)
    plane = as_tensor(ref_padded, src.device)
    positions = as_tensor(positions, src.device)
    if src.device.type == "cpu":
        return encode_ctu_mega_ref(src, plane, positions, r, qscale, qshift, qoffset,
                                   dscale, dshift)
    dev = build.on_card("encode_ctu_mega", src, plane, positions)
    if src.dtype != torch.uint8 or plane.dtype != torch.uint8 \
            or positions.dtype != torch.int32:
        raise TypeError("encode_ctu_mega: src_ctus and ref_padded must be uint8 and "
                        "positions int32")
    if not (src.is_contiguous() and plane.is_contiguous() and positions.is_contiguous()):
        raise ValueError("encode_ctu_mega: inputs must be contiguous")
    _check(src, plane, positions, r, qscale, qshift, qoffset, dshift)
    n = src.shape[0]
    k = CTU // TU
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    mv = torch.empty((n, 2), dtype=torch.int32, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.int32, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    err = build.load().hevc_mega(
        src.data_ptr(), plane.data_ptr(), positions.data_ptr(), rec.data_ptr(),
        mv.data_ptr(), frac.data_ptr(), best.data_ptr(), nnz.data_ptr(), n,
        plane.shape[0], plane.shape[1], r, int(qscale), int(qshift), int(qoffset),
        int(dscale), int(dshift), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "encode_ctu_mega")
    encode_ctu_mega.launches += 1
    return rec, mv, frac, best, nnz


encode_ctu_mega.launches = 0

registry.register("encode_ctu_mega", Tier.REF, encode_ctu_mega_ref)
registry.register("encode_ctu_mega", Tier.KERNEL, encode_ctu_mega)
