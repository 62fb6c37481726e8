"""Kernel B4: the TU residual pipeline of 64x64 CTUs.

``residual_pipeline_ctu`` replaces the TPU kernel
``hevcasm_tpu/kernels/residual_pallas.py`` ``residual_pipeline_ctu``
(``_kernel`` -> ``residual_core``).  The CUDA source is
``csrc/residual_ctu.cu`` over ``csrc/residual_core.cuh``, whose residual
stage K2 and B3 run at 8x8 TUs; its header says what bounds it on the card.
Beside it stands the plain PyTorch version, ``residual_pipeline_ctu_ref``.

Contract: src and pred (n, 64, 64) uint8; the quantizer parameters are ints
inside the ranges the HEVC reference asserts; tu in {4, 8, 16, 32};
tr_type 1 selects the 4x4 DST-VII and is valid at tu = 4 only.  Returns
(rec (n, 64, 64) uint8, nnz_tu (n, 64/tu, 64/tu) int32 coded coefficients
per TU in the CTU's TU-grid order).

``residual_pipeline_kernel`` is the KERNEL tier of the registry's
``residual_pipeline`` op, as JAX registers its kernel as the PALLAS tier of
that op: B4 on (n, 64, 64) stacks.
"""

from __future__ import annotations

import torch

from .. import registry
from ..config import Tier
from ..ops.quantize import check_quant_params
from ..ops.residual import residual_levels, residual_pipeline
from ..utils.tensor import as_tensor
from . import build

__all__ = ["residual_pipeline_ctu", "residual_pipeline_ctu_ref", "residual_pipeline_kernel",
           "TU_SIZES"]

CTU = 64
TU_SIZES = (4, 8, 16, 32)


def _check(src: torch.Tensor, pred: torch.Tensor, qscale, qshift, qoffset, dshift,
           tu: int, tr_type: int) -> None:
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU) or pred.shape != src.shape:
        raise ValueError(f"src and pred must be (n, {CTU}, {CTU}), got "
                         f"{tuple(src.shape)} and {tuple(pred.shape)}")
    if tu not in TU_SIZES:
        raise ValueError(f"tu={tu} (valid: {', '.join(map(str, TU_SIZES))})")
    if tr_type not in (0, 1) or (tr_type and tu != 4):
        raise ValueError(f"tr_type={tr_type} at tu={tu}: the DST-VII (tr_type 1) is 4x4 only")
    check_quant_params(qscale, qshift, qoffset)
    if not 1 <= int(dshift) <= 31:
        raise ValueError(f"dshift={dshift} outside [1, 31]")


def residual_pipeline_ctu_ref(src_ctus, pred_ctus, qscale, qshift, qoffset, dscale,
                              dshift, tu: int = 8, tr_type: int = 0):
    """Plain version: ops.residual.residual_levels with the nnz of each TU."""
    src = as_tensor(src_ctus)
    pred = as_tensor(pred_ctus, src.device)
    _check(src, pred, qscale, qshift, qoffset, dshift, tu, tr_type)
    rec, levels, _ = residual_levels(src, pred, qscale, qshift, qoffset, dscale, dshift,
                                     tu=tu, tr_type=tr_type)
    k = CTU // tu
    nnz = (levels != 0).sum(dim=(-2, -1), dtype=torch.int32).reshape(src.shape[0], k, k)
    return rec, nnz


def residual_pipeline_ctu(src_ctus, pred_ctus, qscale, qshift, qoffset, dscale,
                          dshift, tu: int = 8, tr_type: int = 0):
    """(rec, nnz_tu).  CPU tensors run the plain version; CUDA tensors
    launch the kernel (and raise if it cannot be built or launched)."""
    src = as_tensor(src_ctus)
    pred = as_tensor(pred_ctus, src.device)
    if src.device.type == "cpu":
        return residual_pipeline_ctu_ref(src, pred, qscale, qshift, qoffset, dscale,
                                         dshift, tu, tr_type)
    if src.device.type != "cuda" or pred.device != src.device:
        raise ValueError(f"residual_pipeline_ctu: tensors on {src.device} and "
                         f"{pred.device}; need one CUDA device")
    if src.dtype != torch.uint8 or pred.dtype != torch.uint8:
        raise TypeError("residual_pipeline_ctu: src_ctus and pred_ctus must be uint8")
    if not (src.is_contiguous() and pred.is_contiguous()) \
            or src.data_ptr() % 4 or pred.data_ptr() % 4:
        raise ValueError("residual_pipeline_ctu: inputs must be contiguous and 4-byte aligned")
    _check(src, pred, qscale, qshift, qoffset, dshift, tu, tr_type)
    n, k, dev = src.shape[0], CTU // tu, src.device
    rec = torch.empty((n, CTU, CTU), dtype=torch.uint8, device=dev)
    nnz = torch.empty((n, k, k), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.hevc_residual_ctu(
        src.data_ptr(), pred.data_ptr(), rec.data_ptr(), nnz.data_ptr(), n, tu, tr_type,
        int(qscale), int(qshift), int(qoffset), int(dscale), int(dshift), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "residual_pipeline_ctu")
    residual_pipeline_ctu.launches += 1
    return rec, nnz


def residual_pipeline_kernel(src_blocks, pred_blocks, qscale, qshift, qoffset,
                             dscale, dshift, tu: int = 8, tr_type: int = 0):
    """The registry's residual_pipeline contract, (recon, nnz () int32, cbf
    (n*(B/tu)^2,) bool), through B4.  CPU tensors run ops.residual's plain
    pipeline at any block size; CUDA tensors need (n, 64, 64) stacks."""
    src = as_tensor(src_blocks)
    if src.device.type == "cpu":
        return residual_pipeline(src, pred_blocks, qscale, qshift, qoffset, dscale, dshift,
                                 tu=tu, tr_type=tr_type)
    rec, nnz_tu = residual_pipeline_ctu(src, pred_blocks, qscale, qshift, qoffset, dscale,
                                        dshift, tu=tu, tr_type=tr_type)
    return rec, nnz_tu.sum(dtype=torch.int32), (nnz_tu > 0).reshape(-1)


residual_pipeline_ctu.launches = 0

registry.register("residual_pipeline_ctu", Tier.REF, residual_pipeline_ctu_ref)
registry.register("residual_pipeline_ctu", Tier.KERNEL, residual_pipeline_ctu)
registry.register("residual_pipeline", Tier.KERNEL, residual_pipeline_kernel)
