"""Configuration and implementation tiers for hevcasm_tpu_torch.

The counterpart of ``hevcasm_tpu.config``: a ``Tier`` IntFlag mask that
selects which implementation of an op runs, and ``Config`` / ``DEFAULT``,
the framework's global knobs.  There are two tiers:

REF     plain PyTorch, exact integer arithmetic, runs on any device; the
        golden version every kernel is compared against.
KERNEL  a kernel written by hand in CUDA C++ for Hopper (``csrc/``).  It is
        available when ``torch.cuda.is_available()``; its wrapper launches
        the kernel for CUDA tensors and runs the REF version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import enum


class Tier(enum.IntFlag):
    NONE = 0
    REF = 1
    KERNEL = 2
    ALL = REF | KERNEL


#: Tiers in descending selection priority.
TIER_PRIORITY = (Tier.KERNEL, Tier.REF)


def tiers_in(mask: Tier):
    """Yield individual tiers present in ``mask``, highest priority first."""
    for t in TIER_PRIORITY:
        if mask & t:
            yield t


@dataclasses.dataclass(frozen=True)
class Config:
    """Global knobs for the framework, with hevcasm_tpu's fields and
    defaults.

    Attributes:
      tiers:        which implementation tiers the registry may select.
      bit_depth:    sample bit depth (HEVC Main profile, 8-bit).
      ctu_size:     coding-tree-unit size used by the encode loop.
      search_range: full-search motion estimation range in luma pels.
      mesh_frames:  data-parallel axis size for GOP/frame sharding
                    (parallel.make_mesh's ``frames``).
      mesh_rows:    spatial axis size for CTU-row sharding within a frame
                    (parallel.make_mesh's ``rows``).
    """

    tiers: Tier = Tier.ALL
    bit_depth: int = 8
    ctu_size: int = 64
    search_range: int = 32
    mesh_frames: int = 1
    mesh_rows: int = 1


DEFAULT = Config()
