#!/usr/bin/env python3
"""How far the host-bound B5/B6 calls drift within one checkout, on one card.

    python3 tools/mc_call_probe.py BEFORE_DIR AFTER_DIR

Runs each checkout's package in a fresh process, in the order before,
after, after, before, before, after, after, before.  Each process prints
one JSON line: the median CUDA-event time of a call (10 calls a sample,
20 samples; chip_smoke.samples_ms) of B5 and B6 (mc.pred_uni, mc.pred_bi)
on 510 71x71 luma and 1020 35x35 chroma windows with random per-block
fractions, three times: fresh, after five RDO P frames (pu_decision, all
six layouts, R = 32, on chip_smoke's structured pan), and after ten
torch.profiler sessions of K2.  The spread between the runs of one
checkout says how far a difference between checkouts must reach before it
means anything.  Exits non-zero when there is no CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys


def probe(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
    from hevcasm_tpu_torch.kernels import build, mc
    from hevcasm_tpu_torch.kernels.inter_fused import inter_ctu_fused_dma

    if not torch.cuda.is_available():
        raise SystemExit("mc_call_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    build.load()
    rng = np.random.default_rng(0)

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)

    def fracs(n, phases):
        return [torch.as_tensor(rng.integers(0, phases, n), dtype=torch.int32, device=dev)
                for _ in range(4)]

    wl, wc = [u8((510, 71, 71)) for _ in range(2)], [u8((1020, 35, 35)) for _ in range(2)]
    fl, fc = fracs(510, 4), fracs(1020, 8)
    calls = {"b5_luma": lambda: mc.pred_uni(wl[0], fl[0], fl[1]),
             "b6_luma": lambda: mc.pred_bi(*wl, *fl),
             "b5_chroma": lambda: mc.pred_uni(wc[0], fc[0], fc[1], 4),
             "b6_chroma": lambda: mc.pred_bi(*wc, *fc, 4)}

    def sample():
        return {k: statistics.median(cs.samples_ms(f, calls=10)) for k, f in calls.items()}

    out = {"root": root, "card": cs.card_line(), "fresh": sample()}
    pan_cur, pan_ref = (torch.as_tensor(f[0], device=dev)
                        for f in cs.structured_pan(cs.H, cs.W)[:2])
    rdo = EncodeConfig(search_range=32, qp=32, pu_decision=True,
                       pu_layouts=("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter", "eighth"))
    for _ in range(5):
        encode_inter_frame(pan_cur, pan_ref, rdo)
    torch.cuda.synchronize()
    out["after_rdo"] = sample()
    src, plane = u8((510, 64, 64)), u8((1160, 1992))
    offsets = torch.as_tensor(rng.integers(0, 1000, (510, 2)), dtype=torch.int32, device=dev)
    for _ in range(10):
        cs.device_ms(lambda: inter_ctu_fused_dma(src, plane, offsets, 16384, 22, 10880, 64, 2))
    out["after_profiler"] = sample()
    return out


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--probe"] and len(args) == 2:
        print(json.dumps(probe(args[1])))
        return 0
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    before, after = args
    for root in (before, after, after, before) * 2:
        run = subprocess.run([sys.executable, __file__, "--probe", root],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-2000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
