"""Quantization family (REF tier), the counterpart of
``hevcasm_tpu.ops.quantize``:

* quantize          - HM-style forward quantization with sign/abs split and
                      a coded-block flag per block.
* quantize_inverse  - inverse quantization ("scaling").
* reconstruct       - rec = Clip3(0, 255, pred + res).

All arithmetic is int32; products wrap as two's-complement int32, as they
do in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = ["check_quant_params", "quantize", "quantize_inverse", "reconstruct"]


def _require(name, val, lo, hi):
    """Raise ValueError when a forward-quantizer parameter leaves the range
    the HEVC reference asserts (scale < 0x8000, 16 <= shift <= 27,
    offset < 0x8000)."""
    v = val.cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
    if not np.all((v >= lo) & (v <= hi)):
        raise ValueError(f"quantize: {name}={val} outside [{lo}, {hi}] "
                         "(the HEVC reference asserts this range)")


def check_quant_params(scale, shift, offset) -> None:
    """The forward quantizer's asserted parameter ranges; fused kernels call
    this before they take the parameters."""
    _require("scale", scale, 1, 0x7FFF)
    _require("shift", shift, 16, 27)
    _require("offset", offset, 0, 0x7FFF)


def quantize(src, scale, shift, offset) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward quantization over the trailing two axes.

    src: (..., n, n) int16 transform coefficients.  scale/shift/offset are
    ints or broadcastable tensors inside the asserted ranges (else
    ValueError).  Returns (dst int16 levels, cbf bool per block: any level
    non-zero).
    """
    check_quant_params(scale, shift, offset)
    src = as_tensor(src)
    x = src.to(torch.int32)
    scale = as_tensor(scale, x.device).to(torch.int32)
    shift = as_tensor(shift, x.device).to(torch.int32)
    offset = as_tensor(offset, x.device).to(torch.int32) << (shift - 16)
    sign = torch.where(x < 0, -1, 1).to(torch.int32)
    q = ((x.abs() * scale + offset) >> shift) * sign
    q = q.clamp(-32768, 32767)
    cbf = (q != 0).any(dim=-1).any(dim=-1)
    return q.to(torch.int16), cbf


def quantize_inverse(src, scale, shift) -> torch.Tensor:
    """dst = Clip3(-32768, 32767, (src*scale + (1 << (shift-1))) >> shift),
    any shape; returns int16."""
    src = as_tensor(src)
    x = src.to(torch.int32)
    scale = as_tensor(scale, x.device).to(torch.int32)
    shift = as_tensor(shift, x.device).to(torch.int32)
    y = (x * scale + (1 << (shift - 1))) >> shift
    return y.clamp(-32768, 32767).to(torch.int16)


def reconstruct(pred, res, bit_depth: int = 8) -> torch.Tensor:
    """rec = Clip3(0, (1 << bit_depth) - 1, pred + res) as uint8."""
    rec = as_tensor(pred).to(torch.int32) + as_tensor(res).to(torch.int32)
    return rec.clamp(0, (1 << bit_depth) - 1).to(torch.uint8)
