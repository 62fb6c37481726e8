#!/usr/bin/env python3
"""Time hevcasm_tpu_torch's 1080p frames on one CUDA card, to compare two
checkouts in turns on the same card.

    python3 tools/time_port_frames.py [--root DIR] [--reps 20]

Imports hevcasm_tpu_torch from DIR (default: this checkout; its kernels are
built into DIR/build on first use) and times, with chip_smoke.py's content
and EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma"), the luma P
frame, the 4:2:0 P frame and the 4:2:0 B frame, each synchronised per
frame (CUDA events, after warm-up).  Prints the card's name and power limit,
then one JSON line {"root": DIR, "frames": {name: {"median_ms", "min_ms",
"max_ms"}}}.  Run it for two checkouts in turns (A, B, B, A) in one call:
frames whose host work dominates move between processes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_port_frames: no CUDA device", file=sys.stderr)
        return 1
    from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
    from hevcasm_tpu_torch.encode.video import (YuvFrame, encode_b_frame_yuv,
                                                encode_inter_frame_yuv)

    # This checkout's chip_smoke.py gives the content and the timer, whichever
    # checkout the package comes from.
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda", 0)
    cfg = EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma")
    cur, ref = (torch.as_tensor(f, device=dev) for f in smoke.bench_frames(smoke.H, smoke.W))
    yuv = [YuvFrame(*(torch.as_tensor(p, device=dev) for p in f))
           for f in smoke.structured_pan(smoke.H, smoke.W)]
    frames = {
        "luma P": lambda: encode_inter_frame(cur, ref, cfg),
        "yuv P": lambda: encode_inter_frame_yuv(yuv[0], yuv[1], cfg),
        "yuv B": lambda: encode_b_frame_yuv(yuv[0], yuv[1], yuv[2], cfg),
    }
    out = {}
    for name, fn in frames.items():
        s = smoke.samples_ms(fn, reps=args.reps)
        out[name] = {"median_ms": statistics.median(s), "min_ms": s[0], "max_ms": s[-1]}
    print(smoke.card_line())
    print(json.dumps({"root": args.root, "frames": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
