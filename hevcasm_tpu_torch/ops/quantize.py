"""Quantization family (REF tier), the counterpart of
``hevcasm_tpu.ops.quantize``:

* quantize          - HM-style forward quantization with sign/abs split and
                      a coded-block flag per block.
* quantize_inverse  - inverse quantization ("scaling").
* reconstruct       - rec = Clip3(0, 255, pred + res).
* range_flag, flag_quant_params, raise_on_flag - the parameters' range
                      checks on the device, read once by the caller (the
                      counterpart of the JAX package's checkify checks).
* quantize_checked, check_params_traced - the JAX package's checkify pair,
                      as thin forms over the range flag: the flag plays
                      checkify's error, and reading it raises ValueError.

All arithmetic is int32; products wrap as two's-complement int32, as they
do in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = ["QUANT_RANGES", "check_quant_params", "range_flag", "flag_quant_params",
           "raise_on_flag", "quantize", "quantize_inverse", "reconstruct",
           "QuantError", "quantize_checked", "check_params_traced"]

#: The quantizer parameters' asserted ranges [lo, hi], and each one's bit in
#: a range flag.  The HEVC reference asserts the forward three (scale <
#: 0x8000, 16 <= shift <= 27, offset < 0x8000); the inverse shift must be a
#: valid shift with a rounding term.
QUANT_RANGES = {"scale": (1, 1, 0x7FFF), "shift": (2, 16, 27),
                "offset": (4, 0, 0x7FFF), "dshift": (8, 1, 31)}


def _require(name, val, lo, hi):
    """Raise ValueError when a quantizer parameter leaves its asserted
    range.  A tensor is read on the host."""
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


def range_flag(device) -> torch.Tensor:
    """A 0-d int32 range flag on ``device``, all bits clear: the parameters
    checked against it set their QUANT_RANGES bits in it on the device."""
    return torch.zeros((), dtype=torch.int32, device=device)


def flag_quant_params(flag: torch.Tensor, **params) -> None:
    """Check quantizer parameters (keywords of QUANT_RANGES) without a host
    synchronisation: a tensor out of its range sets its bit in ``flag`` (a
    0-d int32 tensor, updated in place on its device), read later by
    raise_on_flag; a number is checked on the host at once (ValueError)."""
    for name, val in params.items():
        bit, lo, hi = QUANT_RANGES[name]
        if not isinstance(val, torch.Tensor):
            _require(name, val, lo, hi)
            continue
        bad = ((val < lo) | (val > hi)).any().to(torch.int32)
        flag.bitwise_or_(bad.to(flag.device) * bit)


def raise_on_flag(flag: torch.Tensor) -> None:
    """Read a range flag (one host read) and raise ValueError naming every
    parameter whose bit is set."""
    bits = int(flag)
    bad = [f"{name} outside [{lo}, {hi}]" for name, (bit, lo, hi) in QUANT_RANGES.items()
           if bits & bit]
    if bad:
        raise ValueError(f"quantize: {', '.join(bad)} (the HEVC reference asserts "
                         "these ranges)")


def _param(v, device):
    """A parameter as the arithmetic takes it: a Python int stays one (an
    int32 tensor times an int is int32, and no copy to the card is made,
    which would synchronise the host), anything else an int32 tensor."""
    return v if isinstance(v, int) else as_tensor(v, device).to(torch.int32)


def quantize(src, scale, shift, offset, range_flag=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward quantization over the trailing two axes.

    src: (..., n, n) int16 transform coefficients.  scale/shift/offset are
    ints or broadcastable tensors inside the asserted ranges: with no
    ``range_flag`` a value outside raises ValueError (a tensor is read on
    the host); with one, tensors are checked on the device into it
    (flag_quant_params).  Returns (dst int16 levels, cbf bool per block:
    any level non-zero).
    """
    if range_flag is None:
        check_quant_params(scale, shift, offset)
    else:
        flag_quant_params(range_flag, scale=scale, shift=shift, offset=offset)
    src = as_tensor(src)
    x = src.to(torch.int32)
    scale, shift, offset = (_param(v, x.device) for v in (scale, shift, offset))
    offset = offset << (shift - 16)
    sign = torch.where(x < 0, -1, 1).to(torch.int32)
    q = ((x.abs() * scale + offset) >> shift) * sign
    q = q.clamp(-32768, 32767)
    cbf = (q != 0).any(dim=-1).any(dim=-1)
    return q.to(torch.int16), cbf


class QuantError:
    """A range flag as checkify's error: ``get()`` reads it (one host read)
    and returns a message or None, ``throw()`` raises ValueError when a
    bit is set."""

    def __init__(self, flag: torch.Tensor):
        self.flag = flag

    def get(self) -> str | None:
        try:
            raise_on_flag(self.flag)
        except ValueError as e:
            return str(e)
        return None

    def throw(self) -> None:
        raise_on_flag(self.flag)


def check_params_traced(scale, shift, offset, flag: torch.Tensor | None = None) -> QuantError:
    """The forward quantizer's asserted ranges on parameters that go to
    the fused kernels without quantize(): tensors are checked on their
    device into ``flag`` (a fresh range flag when none is given), with no
    host read; numbers at once (ValueError).  Returns the flag as a
    QuantError, whose throw() raises ValueError."""
    if flag is None:
        dev = next((v.device for v in (scale, shift, offset) if isinstance(v, torch.Tensor)),
                   torch.device("cpu"))
        flag = range_flag(dev)
    flag_quant_params(flag, scale=scale, shift=shift, offset=offset)
    return QuantError(flag)


def quantize_checked(src, scale, shift, offset):
    """quantize with its parameters checked on the device: returns (error,
    (dst, cbf)), where error.throw() raises ValueError for a parameter
    outside its asserted range (a number outside raises at once)."""
    src = as_tensor(src)
    flag = range_flag(src.device)
    return QuantError(flag), quantize(src, scale, shift, offset, range_flag=flag)


def quantize_inverse(src, scale, shift) -> torch.Tensor:
    """dst = Clip3(-32768, 32767, (src*scale + (1 << (shift-1))) >> shift),
    any shape; returns int16."""
    src = as_tensor(src)
    x = src.to(torch.int32)
    scale, shift = _param(scale, x.device), _param(shift, x.device)
    y = (x * scale + (1 << (shift - 1))) >> shift
    return y.clamp(-32768, 32767).to(torch.int16)


def reconstruct(pred, res, bit_depth: int = 8) -> torch.Tensor:
    """rec = Clip3(0, (1 << bit_depth) - 1, pred + res) as uint8."""
    rec = as_tensor(pred).to(torch.int32) + as_tensor(res).to(torch.int32)
    return rec.clamp(0, (1 << bit_depth) - 1).to(torch.uint8)
