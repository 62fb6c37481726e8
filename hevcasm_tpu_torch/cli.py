"""Command-line entry point: ``python -m hevcasm_tpu_torch info`` reports the
device and the implementation tiers registered for every op.

``encode`` (a whole GOP) needs the intra path and is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config import Tier


def _cmd_info(_args) -> int:
    from . import registry

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"  device cuda:{i}: {torch.cuda.get_device_name(i)}")
    else:
        print("  device: cpu (no CUDA device; the KERNEL tier is unavailable)")
    print("\nop families and registered tiers (* = usable here):")
    for op in registry.ops():
        tiers = registry.tiers_of(op)
        names = [t.name + ("*" if registry.get_tier(op, t) else "")
                 for t in (Tier.REF, Tier.KERNEL) if tiers & t]
        print(f"  {op:24s} {' '.join(names)}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hevcasm_tpu_torch")
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="device + implementation-tier report")
    args = p.parse_args(argv)
    if args.cmd == "info":
        return _cmd_info(args)
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
