"""Command-line entry point: ``python -m hevcasm_tpu_torch`` runs the
self-test on the CUDA card (the role of the reference's hevcasm
executable), as ``python -m hevcasm_tpu`` does; ``selftest`` takes its
options, ``encode`` codes a GOP (a synthetic clip, or a .y4m / raw .yuv
file, writing the reconstruction as .y4m) and prints one JSON line, and
``info`` reports the device and the implementation tiers registered for
every op.  ``selftest`` and ``encode`` run on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
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


def _cmd_encode(args) -> int:
    from .encode import EncodeConfig, encode_gop

    cfg = EncodeConfig(qp=args.qp, search_range=args.search_range,
                       me_strategy="pyramid" if args.pyramid else "full")
    if args.input:
        return _encode_file(args, cfg)
    frames = _synthetic_video(np.random.default_rng(0), args.frames, args.height, args.width)
    out = encode_gop(frames, cfg, device=args.device)
    print(json.dumps({"frames": args.frames, "size": f"{args.width}x{args.height}",
                      "qp": args.qp, "psnr_db": float(out["psnr_db"]),
                      "nnz": int(out["nnz"])}))
    return 0


def _encode_file(args, cfg) -> int:
    """Encode a .y4m / raw .yuv clip (4:2:0), cropped to whole 64x64 CTUs,
    as an IPPP (or with --b-frames IBPBP) GOP, and write the reconstruction
    as .y4m when --output is given."""
    from . import io as yio
    from .encode.video import YuvFrame, encode_gop_yuv

    frames = list(yio.iter_frames(args.input, width=args.width, height=args.height))
    if args.frames:
        frames = frames[:args.frames]
    if not frames:
        print("error: no frames read", file=sys.stderr)
        return 1
    h, w = frames[0].y.shape
    h64, w64 = h // 64 * 64, w // 64 * 64
    gop = YuvFrame(np.stack([f.y[:h64, :w64] for f in frames]),
                   np.stack([f.cb[:h64 // 2, :w64 // 2] for f in frames]),
                   np.stack([f.cr[:h64 // 2, :w64 // 2] for f in frames]))
    out = encode_gop_yuv(gop, cfg, b_frames=args.b_frames, device=args.device)
    if args.output:
        rec = YuvFrame(*(p.cpu().numpy() for p in out["recon"]))
        yio.write_y4m(args.output, [yio.YuvArrays(*(p[t] for p in rec))
                                    for t in range(rec.y.shape[0])], w64, h64)
    print(json.dumps({"input": args.input, "frames": len(frames), "size": f"{w64}x{h64}",
                      "qp": cfg.qp, "psnr_y_db": float(out["psnr_y"]),
                      "nnz": int(out["nnz"]), "output": args.output or None}))
    return 0


def _synthetic_video(rng, t, h, w) -> np.ndarray:
    """A moving-texture clip, (t, h, w) uint8: noise panned (2, 3) pixels a
    frame plus +-2 of noise, so the motion search has real structure."""
    base = rng.integers(0, 256, (h + 2 * t + 64, w + 2 * t + 64), dtype=np.uint8)
    frames = np.empty((t, h, w), dtype=np.uint8)
    for i in range(t):
        frames[i] = base[2 * i:2 * i + h, 3 * i:3 * i + w]
    noise = rng.integers(-2, 3, frames.shape)
    return np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)


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
    enc = sub.add_parser("encode", help="encode a .y4m/.yuv clip or a synthetic GOP")
    enc.add_argument("--input", help=".y4m or raw .yuv file (default: synthetic)")
    enc.add_argument("--output", help="write the reconstruction as .y4m")
    enc.add_argument("--frames", type=int, default=4)
    enc.add_argument("--width", type=int, default=640)
    enc.add_argument("--height", type=int, default=384)
    enc.add_argument("--qp", type=int, default=32)
    enc.add_argument("--search-range", type=int, default=16)
    enc.add_argument("--pyramid", action="store_true", help="hierarchical ME")
    enc.add_argument("--b-frames", action="store_true", help="IBPB GOP structure")
    enc.add_argument("--device", help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.cmd == "info":
        return _cmd_info(args)
    if args.cmd == "encode":
        return _cmd_encode(args)
    if args.cmd is None:
        args = st.parse_args([])
    return _cmd_selftest(args)


if __name__ == "__main__":
    sys.exit(main())
