"""Hadamard-transformed SAD (SATD, REF tier), the counterpart of
``hevcasm_tpu.ops.satd``.

The 2-D Hadamard transform of the difference block is H @ D @ H with the
Sylvester Hadamard matrix H (entries +-1, symmetric).  The reference's
recursive butterfly gives the same transform up to a row permutation, and
the sum of absolute values does not see the order, so the matrix form is
exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = ["satd", "hadamard_matrix"]


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of order n (n a power of two, n <= 8)."""
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def satd(a, b) -> torch.Tensor:
    """SATD over the trailing two axes; block size n in {2, 4, 8}.

    a, b (..., n, n) uint8 -> (...,) int32, (sum |H (a - b) H| + n/4) //
    (n/2).  Every term is exact in int32: |H D H| <= 64 * 255 for n = 8."""
    a = as_tensor(a)
    b = as_tensor(b, a.device)
    n = a.shape[-1]
    if a.shape[-2] != n or n not in (2, 4, 8):
        raise ValueError(f"satd takes (..., n, n) blocks with n in (2, 4, 8), "
                         f"got {tuple(a.shape)}")
    h = torch.as_tensor(hadamard_matrix(n), device=a.device)
    d = a.to(torch.int32) - b.to(torch.int32)
    # The two products written out: CUDA has no int32 matmul.
    hd = (h[:, :, None] * d[..., None, :, :]).sum(dim=-2)      # H @ D
    t = (hd[..., :, :, None] * h).sum(dim=-2)                 # (H @ D) @ H
    s = t.abs().sum(dim=(-2, -1), dtype=torch.int32) + n // 4
    return s // (n // 2)
