#!/usr/bin/env python3
"""Capture a torch.profiler trace of hevcasm_tpu_torch's 1080p fused_dma
frame on one CUDA card, the counterpart of tools/trace_frame.py.

    python3 tools/trace_frame_torch.py [--frames 20] [--out build/trace_frame_torch]

Encodes bench content (seed 0, a (2, 3) shift; EncodeConfig(search_range=32,
qp=32, inter_impl="fused_dma")) --frames times back to back after a warm-up,
each frame predicted from the previous reconstruction, under torch.profiler
(CPU and CUDA activities).  Writes the Chrome trace (trace.json) under --out
and prints the card's name and power limit, the device's busy time and share
of the window (the card's own events only), and the profiler's table of the
operations with the most device time.  Diagnostics only; exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def device_busy_ms(prof) -> float:
    """The device time (ms) of the card's own events in a profiler run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=str(HERE / "build" / "trace_frame_torch"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_frame_torch: no CUDA device", file=sys.stderr)
        return 1
    from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    h, w = 1088, 1920
    cfg = EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8)
    dev = torch.device("cuda", 0)
    cur = torch.as_tensor(base[2:2 + h, 3:3 + w].copy(), device=dev)
    ref = torch.as_tensor(base[:h, :w].copy(), device=dev)

    def chain():
        r = ref
        for _ in range(args.frames):
            r = encode_inter_frame(cur, r, cfg)["recon"]
        return int(r.to(torch.int64).sum())

    chain()                     # builds the kernels and warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    busy = device_busy_ms(prof)
    print(f"{args.frames} frames: {wall_ms / args.frames:.4f} ms a frame on the host clock, "
          f"device busy {busy / args.frames:.4f} ms a frame ({busy / wall_ms:.3f} of the "
          f"window); trace written to {out / 'trace.json'}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
