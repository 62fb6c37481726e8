"""Kernels B14, B15 and B18: the sub-block SSD grids of every CTU and the
per-PU decision over them.

``base_grids_ctu`` replaces the TPU kernel
``hevcasm_tpu/kernels/search_pallas.py`` ``base_grids_ctu`` and
``base_layout_decide`` the TPU kernel ``base_layout_decide`` (both
``_base_grids_kernel``).  Both are C entries over one device core in
``csrc/base_grids.cu``; its header says what bounds it on the card.
``base_layout_decide_fc`` replaces the TPU kernel of that name
(``_fc_decide_kernel``), which has B15's contract at base 16 and gives its
results bit for bit; its fine/coarse split of dx into 16c + f packs the
TPU's 128 lanes and has no counterpart here, so B18 launches B15's C entry
at base 16 and counts its own launches.  Beside each stands its plain
PyTorch version (``*_ref``).

Contracts, for src (n, 64, 64) uint8 CTUs and windows (n, 64+2R, 64+2R)
uint8 CTU search windows (1 <= R <= 32; the PU decision passes 128 x 128,
R = 32), base in {8, 16, 32} and k = 64 // base:

* ``base_grids_ctu(src, windows, base)`` -> (n, k, k, 2R+1, 2R+1) int32
  exact SSD grids of every (base x base) sub-block, in [dy, dx] order;
* ``base_layout_decide(src, windows, base, pu_lists)`` -> (n, P, 3) int32
  [dy, dx, best] per PU: pu_lists holds P PUs, each a tuple of distinct
  sub-block indices i * k + j; a PU's grid is the sum of its sub-block
  grids, and the PU takes the first minimum in row-major [dy, dx] order,
  reported as an MV in [-R, R].  ``group`` is accepted and ignored.
* ``base_layout_decide_fc(src, windows, pu_lists)``: base_layout_decide at
  base 16 for 128 x 128 windows (R = 32) only, ValueError elsewhere (the
  TPU kernel asserts).
"""

from __future__ import annotations

import functools

import torch

from .. import registry
from ..config import Tier
from ..ops.ssd import ssd_grid as ssd_grid_ref
from ..utils.tensor import as_tensor, first_min
from . import build

__all__ = ["base_grids_ctu", "base_grids_ctu_ref", "base_layout_decide",
           "base_layout_decide_ref", "base_layout_decide_fc", "base_layout_decide_fc_ref",
           "BASES"]

CTU = 64
BASES = (8, 16, 32)
FC_WINDOW = 128                       # B18's windows: R = 32


def _check(src: torch.Tensor, windows: torch.Tensor, base: int, what: str) -> int:
    """Validate the operands; returns the search radius R."""
    if base not in BASES:
        raise ValueError(f"{what}: base={base} (valid: {BASES})")
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU):
        raise ValueError(f"{what}: src_ctus must be (n, {CTU}, {CTU}), got {tuple(src.shape)}")
    size = windows.shape[-1] if windows.dim() == 3 else 0
    r = (size - CTU) // 2
    if windows.dim() != 3 or windows.shape[0] != src.shape[0] \
            or windows.shape[1] != size or size != CTU + 2 * r or not 1 <= r <= 32:
        raise ValueError(f"{what}: windows must be ({src.shape[0]}, 64+2R, 64+2R) with "
                         f"1 <= R <= 32, got {tuple(windows.shape)}")
    return r


def _pu_table(pu_lists, k: int) -> list[tuple[int, ...]]:
    lists = [tuple(int(s) for s in subs) for subs in pu_lists]
    if not lists:
        raise ValueError("pu_lists is empty")
    for subs in lists:
        if not subs or len(set(subs)) != len(subs) or not all(0 <= s < k * k for s in subs):
            raise ValueError(f"PU {subs}: need distinct sub-block indices in [0, {k * k})")
    return lists


def base_grids_ctu_ref(src_ctus, windows, base: int, group: int = 2) -> torch.Tensor:
    """Plain version: partition.base_grid_search with ops.ssd.ssd_grid."""
    from ..encode.partition import base_grid_search

    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    r = _check(src, windows, base, "base_grids_ctu")
    return base_grid_search(src, windows, r, ssd_grid_ref, base)


def base_layout_decide_ref(src_ctus, windows, base: int, pu_lists,
                           group: int = 2) -> torch.Tensor:
    """Plain version: base_grids_ctu_ref, each PU's sub-block grids summed,
    then the first minimum of each PU's grid."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    r = _check(src, windows, base, "base_layout_decide")
    k = CTU // base
    lists = _pu_table(pu_lists, k)
    n, num = src.shape[0], 2 * r + 1
    g = base_grids_ctu_ref(src, windows, base).reshape(n, k * k, num * num)
    out = []
    for subs in lists:
        idx, best = first_min(g[:, list(subs)].sum(dim=1, dtype=torch.int32))
        out.append(torch.stack([idx // num - r, idx % num - r, best], dim=-1))
    return torch.stack(out, dim=1).to(torch.int32)


def _operands(src: torch.Tensor, windows: torch.Tensor, what: str) -> torch.device:
    dev = src.device
    if dev.type != "cuda" or windows.device != dev:
        raise ValueError(f"{what}: tensors on {dev} and {windows.device}; "
                         "need one CUDA device")
    if src.dtype != torch.uint8 or windows.dtype != torch.uint8:
        raise TypeError(f"{what}: src_ctus and windows must be uint8")
    if not src.is_contiguous() or windows.stride(-1) != 1:
        raise ValueError(f"{what}: src_ctus must be contiguous and windows rows contiguous")
    return dev


def base_grids_ctu(src_ctus, windows, base: int, group: int = 2) -> torch.Tensor:
    """(n, k, k, 2R+1, 2R+1) int32 sub-block grids.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (and raise if it cannot
    be built or launched)."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return base_grids_ctu_ref(src, windows, base)
    dev = _operands(src, windows, "base_grids_ctu")
    r = _check(src, windows, base, "base_grids_ctu")
    n, k, num = src.shape[0], CTU // base, 2 * r + 1
    grids = torch.empty((n, k, k, num, num), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.hevc_base_grids(src.data_ptr(), windows.data_ptr(), windows.stride(0),
                              windows.stride(1), grids.data_ptr(), n, base, r,
                              dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "base_grids_ctu")
    base_grids_ctu.launches += 1
    return grids


@functools.lru_cache(maxsize=16)
def _device_table(lists: tuple[tuple[int, ...], ...], dev: torch.device) -> torch.Tensor:
    """The PU lists as one int32 device tensor [offsets (P + 1), indices],
    made once per (lists, device): a host-to-device copy per frame would
    wait for the stream."""
    offsets = [0]
    for subs in lists:
        offsets.append(offsets[-1] + len(subs))
    flat = offsets + [s for subs in lists for s in subs]
    return torch.tensor(flat, dtype=torch.int32, device=dev)


def _decide_launch(src: torch.Tensor, windows: torch.Tensor, base: int, pu_lists,
                   what: str) -> torch.Tensor:
    """Check B15's operands on the card and launch its C entry."""
    dev = _operands(src, windows, what)
    r = _check(src, windows, base, what)
    lists = _pu_table(pu_lists, CTU // base)
    table = _device_table(tuple(lists), dev)
    n, p, k, num = src.shape[0], len(lists), CTU // base, 2 * r + 1
    grids = torch.empty((n, k, k, num, num), dtype=torch.int32, device=dev)   # scratch
    keys = torch.empty((n, p), dtype=torch.int64, device=dev)
    out = torch.empty((n, p, 3), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.hevc_base_decide(src.data_ptr(), windows.data_ptr(), windows.stride(0),
                               windows.stride(1), table.data_ptr(), p, grids.data_ptr(),
                               keys.data_ptr(), out.data_ptr(), n, base, r, dev.index or 0,
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    return out


def base_layout_decide(src_ctus, windows, base: int, pu_lists,
                       group: int = 2) -> torch.Tensor:
    """(n, P, 3) int32 [dy, dx, best] per PU.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot be
    built or launched)."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return base_layout_decide_ref(src, windows, base, pu_lists)
    out = _decide_launch(src, windows, base, pu_lists, "base_layout_decide")
    base_layout_decide.launches += 1
    return out


def _check_fc(src: torch.Tensor, windows: torch.Tensor) -> None:
    """The TPU kernel's geometry: 64x64 CTUs and 128x128 windows (R = 32);
    it stops on an assert elsewhere."""
    if src.dim() != 3 or src.shape[1:] != (CTU, CTU) or windows.dim() != 3 \
            or windows.shape[1:] != (FC_WINDOW, FC_WINDOW):
        raise ValueError(f"base_layout_decide_fc: src_ctus must be (n, {CTU}, {CTU}) and "
                         f"windows (n, {FC_WINDOW}, {FC_WINDOW}), got {tuple(src.shape)} "
                         f"and {tuple(windows.shape)}")


def base_layout_decide_fc_ref(src_ctus, windows, pu_lists, group: int = 2) -> torch.Tensor:
    """Plain version: base_layout_decide_ref at base 16."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    _check_fc(src, windows)
    return base_layout_decide_ref(src, windows, 16, pu_lists)


def base_layout_decide_fc(src_ctus, windows, pu_lists, group: int = 2) -> torch.Tensor:
    """(n, P, 3) int32 [dy, dx, best] per PU at base 16, R = 32.  CPU
    tensors run the plain version; CUDA tensors launch B15's kernel at base
    16 (and raise if it cannot be built or launched)."""
    src = as_tensor(src_ctus)
    windows = as_tensor(windows, src.device)
    if src.device.type == "cpu":
        return base_layout_decide_fc_ref(src, windows, pu_lists)
    _check_fc(src, windows)
    out = _decide_launch(src, windows, 16, pu_lists, "base_layout_decide_fc")
    base_layout_decide_fc.launches += 1
    return out


base_grids_ctu.launches = 0
base_layout_decide.launches = 0
base_layout_decide_fc.launches = 0

registry.register("base_grids_ctu", Tier.REF, base_grids_ctu_ref)
registry.register("base_grids_ctu", Tier.KERNEL, base_grids_ctu)
registry.register("base_layout_decide", Tier.REF, base_layout_decide_ref)
registry.register("base_layout_decide", Tier.KERNEL, base_layout_decide)
