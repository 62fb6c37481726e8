"""Sum of squared differences (REF tier), the counterpart of
``hevcasm_tpu.ops.ssd`` (``ssd``, ``ssd_linear``) plus the exact SSD-grid
contract of ``hevcasm_tpu.kernels.xla_opt.ssd_grid_ref``.

The grid is computed by direct differences, one candidate row (dy) at a
time and in chunks of blocks, so its temporary stays near ``_CHUNK_ELEMS``
int32 elements whatever the frame size.
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor

__all__ = ["ssd", "ssd_linear", "ssd_grid"]

# Upper bound on the elements of one (blocks, h, num_dx, w) difference
# tensor: 2^26 int32 elements = 256 MiB.
_CHUNK_ELEMS = 1 << 26


def ssd(a, b) -> torch.Tensor:
    """SSD over the trailing two axes: (..., h, w) -> (...,) int32."""
    d = as_tensor(a).to(torch.int32) - as_tensor(b).to(torch.int32)
    return (d * d).sum(dim=(-2, -1), dtype=torch.int32)


def ssd_linear(a, b) -> torch.Tensor:
    """SSD over the trailing axis of a contiguous buffer: (..., n) ->
    (...,) int32."""
    d = as_tensor(a).to(torch.int32) - as_tensor(b).to(torch.int32)
    return (d * d).sum(dim=-1, dtype=torch.int32)


def ssd_grid(src, window, num_dy: int, num_dx: int) -> torch.Tensor:
    """Exact SSD of each block against every displacement of a window.

    src (..., h, w) uint8; window (..., >= h + num_dy - 1, >= w + num_dx -
    1) uint8 with the same leading axes.  Returns (..., num_dy, num_dx)
    int32 with out[..., dy, dx] = sum_{y,x} (window[..., dy + y, dx + x] -
    src[..., y, x])^2.  Every sum is below 4096 * 255^2 < 2^31 for blocks up
    to 64x64.
    """
    src = as_tensor(src)
    window = as_tensor(window, src.device)
    *lead, h, w = src.shape
    if len(lead) != 1:
        flat = ssd_grid(src.reshape(-1, h, w), window.reshape(-1, *window.shape[-2:]),
                        num_dy, num_dx)
        return flat.reshape(*lead, num_dy, num_dx)
    n = lead[0]
    out = torch.empty((n, num_dy, num_dx), dtype=torch.int32, device=src.device)
    chunk = max(1, _CHUNK_ELEMS // (h * num_dx * w))
    s32 = src.to(torch.int32)[:, :, None, :]                    # (n, h, 1, w)
    for c0 in range(0, n, chunk):
        win = window[c0 : c0 + chunk].to(torch.int32)
        sc = s32[c0 : c0 + chunk]
        for dy in range(num_dy):
            # (m, h, num_dx, w): the row band at dy, every dx shift of it.
            cand = win[:, dy : dy + h, : num_dx + w - 1].unfold(-1, w, 1)
            d = cand - sc
            out[c0 : c0 + chunk, dy] = (d * d).sum(dim=(1, 3), dtype=torch.int32)
    return out
