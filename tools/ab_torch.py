#!/usr/bin/env python3
"""Time hevcasm_tpu_torch of two checkouts in turns on one CUDA card.

    python3 tools/ab_torch.py BEFORE_DIR [AFTER_DIR]

AFTER_DIR defaults to this checkout.  Each run imports one checkout's
package in a process of its own (which builds that checkout's kernels into
its own build/), in the order before, after, after, before, so that drift on
the card shows as the spread between the two runs of one checkout.  A run
prints one JSON line: the card's name and power limit, and medians (with
min and max) of 20 samples of

* the luma P frame, encode_inter_frame on chip_smoke's bench content at
  1920x1088, EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma"),
  synchronised per frame;
* the multi-reference P frame, encode_inter_frame_multiref on chip_smoke's
  multiref pan with k = 4 and the same config;
* K1 (510 CTUs, R = 32), B7 (the same, k = 4), B10 sad (510 64x64 blocks)
  and sad_multiref (k = 4), a sample being 10 launches between CUDA events,
  and torch.cdist(p=1) on float32 copies of B10's operands.

Exits non-zero, with no result, when there is no CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def measure() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode import ctu as ctu_mod, motion
    from hevcasm_tpu_torch.encode.loop import (EncodeConfig, encode_inter_frame,
                                               encode_inter_frame_multiref)
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.kernels.sad import sad, sad_multiref
    from hevcasm_tpu_torch.kernels.search import ssd_grid_plane, ssd_grid_plane_multi

    if not torch.cuda.is_available():
        raise SystemExit("ab_torch: no CUDA device")
    dev = torch.device("cuda", 0)
    build.load()
    h, w, r = cs.H, cs.W, cs.SEARCH_RANGE
    cfg = EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma")
    cur, ref = (torch.as_tensor(p, device=dev) for p in cs.bench_frames(h, w))
    mr_cur, mr_refs = (torch.as_tensor(p, device=dev) for p in cs.multiref_pan(h, w))
    grid = ctu_mod.grid_shape(h, w, 64)
    src = ctu_mod.tile_frame(cur, 64).contiguous()
    pl, pr = r + motion.PAD_L, r + motion.PAD_R
    plane = ctu_mod.pad_frame(ref, pl, pr, pl, pr)[motion.PAD_L:motion.PAD_L + h + 2 * r,
                                                   motion.PAD_L:motion.PAD_L + w + 2 * r]
    plane = plane.contiguous()
    planes = torch.stack([ctu_mod.pad_frame(p, pl, pr, pl, pr) for p in mr_refs])
    view = planes[:, motion.PAD_L:motion.PAD_L + h + 2 * r, motion.PAD_L:motion.PAD_L + w + 2 * r]
    b_ref = ctu_mod.tile_frame(ref, 64).contiguous()
    b_refs = ctu_mod.tile_frame(mr_refs, 64).transpose(0, 1).contiguous()
    n, num = src.shape[0], 2 * r + 1
    cd_src, cd_ref = src.reshape(n, 1, 4096).float(), b_ref.reshape(n, 1, 4096).float()
    cd_refs = b_refs.reshape(n, 4, 4096).float()

    def stats(samples):
        return {"median": statistics.median(samples), "min": samples[0], "max": samples[-1]}

    return {
        "card": cs.card_line(),
        "luma_p_frame_ms": stats(cs.samples_ms(lambda: encode_inter_frame(cur, ref, cfg))),
        "multiref_k4_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame_multiref(mr_cur, mr_refs, cfg))),
        "k1_ms": stats(cs.samples_ms(lambda: ssd_grid_plane(src, plane, grid, num), calls=10)),
        "b7_k4_ms": stats(cs.samples_ms(lambda: ssd_grid_plane_multi(src, view, grid, num),
                                        calls=10)),
        "b10_sad_ms": stats(cs.samples_ms(lambda: sad(src, b_ref), calls=10)),
        "b10_sad_multiref_ms": stats(cs.samples_ms(lambda: sad_multiref(src, b_refs),
                                                   calls=10)),
        "cdist_sad_ms": stats(cs.samples_ms(lambda: torch.cdist(cd_src, cd_ref, p=1), calls=10)),
        "cdist_sad_multiref_ms": stats(cs.samples_ms(
            lambda: torch.cdist(cd_src, cd_refs, p=1), calls=10)),
    }


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        sys.path[:0] = [sys.argv[2]]
        print(json.dumps(measure()), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    before = Path(sys.argv[1]).resolve()
    after = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else HERE
    for label, root in (("before", before), ("after", after), ("after", after),
                        ("before", before)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure",
                              str(root)], cwd=root, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        print(json.dumps({"run": label, "root": str(root),
                          **json.loads(out.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
