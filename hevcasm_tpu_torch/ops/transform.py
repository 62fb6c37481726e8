"""HEVC core transforms: forward/inverse DCT-II 4/8/16/32 and DST-VII 4x4
(REF tier), the counterpart of ``hevcasm_tpu.ops.transform``.

* Forward pass: dst[k, i] = (sum_j T[k, j] * src[i, j] + (1 << (shift-1)))
  >> shift, stored to int16 by two's-complement wrap; shift pairs
  (log2 - 1, log2 + 6).
* Inverse pass: dst[i, k] = Clip3(-32768, 32767, (sum_j T[j, k] * src[j, i]
  + (1 << (shift-1))) >> shift); shifts (7, 12) for every size.

Contractions run as float64 matrix products: every product and partial
sum is an integer below 2^28, so float64 holds them exactly on any device
(CUDA has no int32 matrix product).  All other arithmetic is int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = ["DCT32", "DST4", "INVERSE_SHIFTS", "dct_matrix", "forward_shifts",
           "forward_transform", "inverse_transform", "add_residual",
           "inverse_transform_add"]

# The 32-point HEVC transform matrix (H.265 section 8.6.4.2), built from its
# first column: T32[k, j] is the integer cosine at angle k*(2j+1)*pi/64,
# read from the first column with the sign of its quadrant.
_T32_FIRST_COL = [
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
]


def _build_dct32() -> np.ndarray:
    c = _T32_FIRST_COL
    t = np.zeros((32, 32), dtype=np.int32)
    for k in range(32):
        for j in range(32):
            phase = (k * (2 * j + 1)) % 128  # angle in units of pi/64
            sign = 1
            if phase >= 64:
                sign, phase = -1, phase - 64
            if phase >= 32:
                val = -c[64 - phase] if phase != 32 else 0
            else:
                val = c[phase]
            t[k, j] = sign * val
    return t


DCT32 = _build_dct32()

# DST-VII 4x4 matrix (H.265 equation 8-318).
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

INVERSE_SHIFTS = (7, 12)


def forward_shifts(log2: int) -> tuple[int, int]:
    return (log2 - 1, log2 + 6)


def dct_matrix(n: int) -> np.ndarray:
    """The n-point HEVC matrix: the even-row subset of DCT32."""
    if n not in (4, 8, 16, 32):
        raise ValueError(f"transform size {n} (valid: 4, 8, 16, 32)")
    return np.ascontiguousarray(DCT32[:: 32 // n, :n])


def _matrix(n: int, tr_type: int) -> np.ndarray:
    if tr_type:
        if n != 4:
            raise ValueError("the DST-VII is defined for 4x4 blocks only")
        return DST4
    return dct_matrix(n)


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b through float64 (operands and sums < 2^53)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _fwd_stage(x: torch.Tensor, t: torch.Tensor, shift: int) -> torch.Tensor:
    """(T @ x^T + add) >> shift, wrapped to int16, held in int32."""
    y = _imatmul(t, x.transpose(-2, -1))
    return _wrap16((y + (1 << (shift - 1))) >> shift)


def _inv_stage(x: torch.Tensor, t: torch.Tensor, shift: int) -> torch.Tensor:
    """clip((x^T @ T + add) >> shift) to int16 range, held in int32."""
    y = _imatmul(x.transpose(-2, -1), t)
    return ((y + (1 << (shift - 1))) >> shift).clamp(-32768, 32767)


def _t(n: int, tr_type: int, device) -> torch.Tensor:
    return torch.as_tensor(_matrix(n, tr_type), device=device)


def forward_transform(res, tr_type: int = 0) -> torch.Tensor:
    """Forward transform of a batch of square residual blocks (..., n, n),
    n in {4, 8, 16, 32}; tr_type=1 selects the 4x4 DST-VII.  Returns int16
    coefficients."""
    res = as_tensor(res)
    n = res.shape[-1]
    t = _t(n, tr_type, res.device)
    s1, s2 = forward_shifts(n.bit_length() - 1)
    x = res.to(torch.int32)
    return _fwd_stage(_fwd_stage(x, t, s1), t, s2).to(torch.int16)


def inverse_transform(coeffs, tr_type: int = 0) -> torch.Tensor:
    """Inverse transform (the residual before add-to-predicted): two
    clipped passes with shifts 7 then 12.  Returns int16 residuals."""
    coeffs = as_tensor(coeffs)
    n = coeffs.shape[-1]
    t = _t(n, tr_type, coeffs.device)
    s1, s2 = INVERSE_SHIFTS
    x = coeffs.to(torch.int32)
    return _inv_stage(_inv_stage(x, t, s1), t, s2).to(torch.int16)


def add_residual(pred, res, bit_depth: int = 8) -> torch.Tensor:
    """rec = Clip3(0, (1 << bit_depth) - 1, pred + res) as uint8."""
    rec = as_tensor(pred).to(torch.int32) + as_tensor(res).to(torch.int32)
    return rec.clamp(0, (1 << bit_depth) - 1).to(torch.uint8)


def inverse_transform_add(coeffs, pred, tr_type: int = 0,
                          bit_depth: int = 8) -> torch.Tensor:
    """Fused inverse transform + add to predicted + clip."""
    return add_residual(pred, inverse_transform(coeffs, tr_type), bit_depth)
