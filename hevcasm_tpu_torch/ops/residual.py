"""The residual pipeline (REF tier), the counterpart of
``hevcasm_tpu.ops.residual``: residual -> forward transform per TU ->
quantize -> dequantize -> inverse transform + add + clip, composed from the
individually exact ops.

  recon (n, B, B) uint8; nnz () int32 total coded coefficients;
  cbf (n*(B/tu)^2,) bool per-TU coded-block flags in raster TU order.
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor
from .quantize import quantize, quantize_inverse
from .transform import forward_transform, inverse_transform_add

__all__ = ["residual_pipeline", "residual_levels", "bits_egk"]


def _split(blocks: torch.Tensor, sub: int) -> torch.Tensor:
    """(n, B, B) -> (n*(B/sub)^2, sub, sub), raster TU order per block."""
    n, big, _ = blocks.shape
    k = big // sub
    x = blocks.reshape(n, k, sub, k, sub).transpose(2, 3)
    return x.reshape(n * k * k, sub, sub)


def _merge(tus: torch.Tensor, big: int) -> torch.Tensor:
    sub = tus.shape[-1]
    k = big // sub
    n = tus.shape[0] // (k * k)
    x = tus.reshape(n, k, k, sub, sub).transpose(2, 3)
    return x.reshape(n, big, big)


def residual_levels(src_blocks, pred_blocks, qscale, qshift, qoffset,
                    dscale, dshift, tu: int = 8, tr_type: int = 0):
    """The pipeline returning the quantized levels themselves:
    (recon (n, B, B) uint8, levels (n*(B/tu)^2, tu, tu) int16 in
    raster TU order, cbf (n*(B/tu)^2,) bool)."""
    src_blocks = as_tensor(src_blocks)
    pred_blocks = as_tensor(pred_blocks, src_blocks.device)
    big = src_blocks.shape[-1]
    res = src_blocks.to(torch.int16) - pred_blocks.to(torch.int16)
    coeffs = forward_transform(_split(res, tu), tr_type)
    levels, cbf = quantize(coeffs, qscale, qshift, qoffset)
    rcoeffs = quantize_inverse(levels, dscale, dshift)
    rec_tus = inverse_transform_add(rcoeffs, _split(pred_blocks, tu), tr_type)
    return _merge(rec_tus, big), levels, cbf


def residual_pipeline(src_blocks, pred_blocks, qscale, qshift, qoffset,
                      dscale, dshift, tu: int = 8, tr_type: int = 0):
    """REF residual pipeline over (n, B, B) uint8 block stacks.  Returns
    (recon (n, B, B) uint8, nnz () int32, cbf (n*(B/tu)^2,) bool)."""
    rec, levels, cbf = residual_levels(src_blocks, pred_blocks, qscale, qshift,
                                       qoffset, dscale, dshift, tu, tr_type)
    nnz = (levels != 0).sum(dtype=torch.int32)
    return rec, nnz, cbf.reshape(-1)


def bits_egk(q: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb bit cost per quantized level, elementwise int32: 0 for
    q == 0, else 2 * floor(log2 |q|) + 3.  floor(log2 a) is the index of
    the top set bit, found exactly by comparison against powers of two."""
    a = q.to(torch.int32).abs()
    pow2 = torch.tensor([1 << k for k in range(1, 31)], dtype=torch.int32,
                        device=a.device)
    fl = (a[..., None] >= pow2).sum(dim=-1, dtype=torch.int32)
    return torch.where(a > 0, 2 * fl + 3, 0).to(torch.int32)
