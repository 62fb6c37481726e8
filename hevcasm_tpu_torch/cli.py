"""Command-line entry point: ``python -m hevcasm_tpu_torch`` runs the
self-test on the CUDA card (the role of the reference's hevcasm
executable), as ``python -m hevcasm_tpu`` does; ``selftest`` takes its
options, and ``info`` reports the device and the implementation tiers
registered for every op.

``encode`` (a whole GOP) needs the intra path and is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config import Tier

_TIERS = (Tier.REF, Tier.KERNEL)


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
                 for t in _TIERS if tiers & t]
        print(f"  {op:24s} {' '.join(names)}")
    return 0


def _cmd_selftest(args) -> int:
    from . import selftest

    mask = Tier.ALL
    if args.tiers:
        mask = Tier.NONE
        for t in args.tiers.split(","):
            try:
                mask |= Tier[t.strip().upper()]
            except KeyError:
                valid = ", ".join(m.name.lower() for m in _TIERS)
                print(f"error: unknown tier '{t}' (valid: {valid})", file=sys.stderr)
                return 2
    return selftest.main(
        mask=mask,
        time_it=not args.no_time,
        suites=args.suites.split(",") if args.suites else None,
        json_path=args.json,
        converged=args.converged,
        device=args.device,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hevcasm_tpu_torch")
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="device + implementation-tier report")
    st = sub.add_parser("selftest", help="kernel self-test + micro-benchmarks")
    st.add_argument("--tiers", help="comma list: ref,kernel (default both)")
    st.add_argument("--suites", help="comma list of suite names (default all)")
    st.add_argument("--no-time", action="store_true")
    st.add_argument("--converged", action="store_true",
                    help="converging-averager timing (reference hevcasm_test.c "
                         "semantics) instead of best-of-k")
    st.add_argument("--json", help="write structured results to this path ('-' = stdout)")
    st.add_argument("--device", help="device to run on (default: the CUDA card; 'cpu' "
                                     "runs the REF tier only)")
    args = p.parse_args(argv)
    if args.cmd == "info":
        return _cmd_info(args)
    if args.cmd is None:
        args = st.parse_args([])
    return _cmd_selftest(args)


if __name__ == "__main__":
    sys.exit(main())
