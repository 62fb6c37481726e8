"""PSNR from the mean squared error."""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """PSNR in dB over all elements of a/b (any shape), as a float32 0-d
    tensor on a's device.  The mean is taken in float64."""
    d = a.to(torch.float64) - b.to(torch.float64)
    mse = torch.mean(d * d).clamp_min(1e-10)
    peak = float((1 << bit_depth) - 1)
    return (10.0 * torch.log10(peak * peak / mse)).to(torch.float32)
