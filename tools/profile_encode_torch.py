#!/usr/bin/env python3
"""Per-stage times of hevcasm_tpu_torch's inter-frame inner loop on one
CUDA card, the counterpart of tools/profile_encode.py.

    python3 tools/profile_encode_torch.py [--height 1088 --width 1920 --range 32]

Times each stage of encode_inter_frame alone at bench.py's 1080p shapes
(bench content, seed 0, a (2, 3) shift), then the composed frame under
inter_impl "stages" and "fused_dma": the aligned window gather, B8 (the grid
search's ssd_grid on the gathered windows), K1 (full_search_slab: the plane
grids and the first minimum), the quarter-pel refinement (the plain sweep
that the staged path runs), the residual pipeline, and K2.  A stage's time
is the CUDA-event time of --iters calls back to back over their count, after
a warm-up.  Beside each: its operations (2 a multiply-add) and bytes over
the H100's published int8 rate (1,979 TOP/s) and HBM rate (3.35 TB/s).
Prints the card's name and power limit first.  Diagnostics only; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PEAK_OPS = 1979e12   # H100 SXM int8 tensor-core rate, dense
HBM_BPS = 3.35e12    # H100 SXM HBM3


def line(name, ms, ops=None, nbytes=None):
    s = f"{name:40s} {ms:9.4f} ms"
    if ops:
        s += f"  {ops / ms / 1e9:9.2f} TOP/s ({ops / ms / 1e9 / (PEAK_OPS / 1e12) * 100:5.1f}% " \
             "of the int8 peak)"
    if nbytes:
        s += f"  {nbytes / ms / 1e6:8.1f} GB/s ({nbytes / ms / 1e9 / (HBM_BPS / 1e12) * 100:5.1f}%" \
             " of HBM)"
    print(s, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--range", type=int, default=32, dest="srange")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_encode_torch: no CUDA device", file=sys.stderr)
        return 1
    from hevcasm_tpu_torch import registry
    from hevcasm_tpu_torch.encode import ctu as ctu_mod
    from hevcasm_tpu_torch.encode import motion
    from hevcasm_tpu_torch.encode.loop import (EncodeConfig, _pad_reference, _residual_pipeline,
                                               encode_inter_frame)
    from hevcasm_tpu_torch.kernels.inter_fused import inter_ctu_fused_dma

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    h, w, r, b = args.height, args.width, args.srange, 64
    gr, gc = h // b, w // b
    n, num = gr * gc, 2 * r + 1
    cfg = EncodeConfig(search_range=r, qp=32)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8)
    cur = torch.as_tensor(base[2:2 + h, 3:3 + w].copy(), device=dev)
    ref = torch.as_tensor(base[:h, :w].copy(), device=dev)
    src = ctu_mod.tile_frame(cur, b).contiguous()
    pos = motion.ctu_positions(gr, gc, b, dev)
    ref_padded = _pad_reference(ref, r)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    def windows():
        return motion.extract_aligned_windows(ref_padded, (motion.PAD_L, motion.PAD_L),
                                              (gr, gc), b, b + 2 * r)

    win = windows()
    line("extract_aligned_windows", timed(windows), nbytes=2 * win.numel())
    corr_ops = 2 * n * num * num * b * b
    ssd_grid = registry.get("ssd_grid")
    line(f"ssd_grid B8 ({n} CTUs, +-{r})", timed(lambda: ssd_grid(src, win, num, num)),
         ops=corr_ops)
    grid_plane = registry.get("ssd_grid_plane")
    line("full_search_slab K1 (grids + first minimum)",
         timed(lambda: motion.full_search_slab(src, ref_padded, r, (gr, gc),
                                               grid_plane_fn=grid_plane)), ops=corr_ops)
    mv, _ = motion.full_search_slab(src, ref_padded, r, (gr, gc), grid_plane_fn=grid_plane)
    start = (pos + mv + r).to(torch.int32).contiguous()
    refine = registry.get("refine_qpel")

    def refine_stage():
        return refine(src, motion.extract_windows(ref_padded, start, b + motion.TAPS - 1))

    # 4 horizontal passes of (B+7) rows and 16 vertical of B rows, 8 taps.
    refine_ops = 2 * n * 8 * (4 * (b + 7) * b + 16 * b * b)
    line("refine_qpel (plain sweep)", timed(refine_stage), ops=refine_ops)
    pred = refine_stage()[0]
    line("residual pipeline (plain)",
         timed(lambda: _residual_pipeline(src, pred, cfg, intra=False)),
         ops=2 * 4 * n * b * b * 8)
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    line("inter_ctu_fused_dma K2", timed(lambda: inter_ctu_fused_dma(src, ref_padded, start,
                                                                       *qargs)),
         ops=refine_ops + 2 * 4 * n * b * b * 8)
    for impl in ("stages", "fused_dma"):
        icfg = EncodeConfig(search_range=r, qp=32, inter_impl=impl)
        ms = timed(lambda icfg=icfg: encode_inter_frame(cur, ref, icfg))
        line(f"encode_inter_frame TOTAL ({impl})", ms)
        print(f"-> {n / ms * 1e3:,.0f} CTU/s   {1e3 / ms:.1f} fps {w}x{h}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
