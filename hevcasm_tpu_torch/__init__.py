"""hevcasm_tpu_torch — the PyTorch and CUDA port of hevcasm_tpu, an HEVC
Main-profile (8-bit) encode inner-loop engine.

The port keeps hevcasm_tpu's module names, entry points, configuration and
output dicts, and gives the same integers.  Plain PyTorch code (tier REF)
runs on any device; every TPU kernel on a ported path becomes a kernel
written by hand in CUDA C++ for Hopper (tier KERNEL, ``csrc/``), built with
``nvcc`` on first use.  A CUDA tensor goes to the kernel, a CPU tensor to
the plain version.

The port imports torch and numpy only, never jax.
"""

from .config import Config, Tier, DEFAULT
from . import registry
from . import ops  # registers the REF tier of the plain ops
from . import encode  # registers the kernels' REF and KERNEL tiers
from .kernels import mc  # noqa: F401  B5 and B6, which no encode path runs

__version__ = "0.1.0"

__all__ = ["Config", "Tier", "DEFAULT", "registry", "ops", "encode"]
