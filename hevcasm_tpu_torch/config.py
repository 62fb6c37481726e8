"""Implementation tiers for hevcasm_tpu_torch.

The counterpart of ``hevcasm_tpu.config``: a ``Tier`` IntFlag mask that
selects which implementation of an op runs.  There are two tiers:

REF     plain PyTorch, exact integer arithmetic, runs on any device; the
        golden version every kernel is compared against.
KERNEL  a kernel written by hand in CUDA C++ for Hopper (``csrc/``).  It is
        available when ``torch.cuda.is_available()``; its wrapper launches
        the kernel for CUDA tensors and runs the REF version for CPU tensors.
"""

from __future__ import annotations

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
