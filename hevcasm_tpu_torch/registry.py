"""Op registry: (op name, tier) -> implementation.

The counterpart of ``hevcasm_tpu.registry``.  ``get`` returns the best
implementation whose tier is enabled in a mask and available; the KERNEL
tier is available iff ``torch.cuda.is_available()``, probed at lookup time
so that importing the package never touches a device.

Dispatch inside a KERNEL implementation follows the tensors it is given:
a CUDA tensor launches the kernel (and raises if the kernel cannot be built
or launched), a CPU tensor runs the REF version.  There is no silent
fallback from a failing kernel to REF.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from .config import Tier, tiers_in

_REGISTRY: Dict[Tuple[str, Tier], Callable] = {}


def register(op: str, tier: Tier, fn: Callable) -> Callable:
    """Register ``fn`` as the implementation of ``op`` at ``tier``."""
    _REGISTRY[(op, tier)] = fn
    return fn


def _usable(tier: Tier) -> bool:
    return tier is not Tier.KERNEL or torch.cuda.is_available()


def get(op: str, mask: Tier = Tier.ALL) -> Callable | None:
    """Best implementation of ``op`` among the usable tiers in ``mask``
    (KERNEL > REF), or None."""
    for tier in tiers_in(mask):
        f = _REGISTRY.get((op, tier))
        if f is not None and _usable(tier):
            return f
    return None


def get_tier(op: str, tier: Tier) -> Callable | None:
    """Exactly the given tier, or None if it is not registered or not
    usable on this machine."""
    return _REGISTRY.get((op, tier)) if _usable(tier) else None


def populate(mask: Tier = Tier.ALL) -> Dict[str, Callable]:
    """A {op: best implementation} table for every registered op."""
    return {op: get(op, mask) for op in ops()}


def ops() -> Iterable[str]:
    return sorted({op for (op, _) in _REGISTRY})


def tiers_of(op: str) -> Tier:
    """Mask of the tiers registered for ``op``."""
    mask = Tier.NONE
    for (name, tier) in _REGISTRY:
        if name == op:
            mask |= tier
    return mask
