#!/usr/bin/env python3
"""What each phase of kernels K1/B7 (hevcasm_tpu_torch/csrc/ssd_grid_plane.cu)
costs on a CUDA card, and the rate of the tensor-core instruction they use.

    python3 tools/k1_phase_costs.py

The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this ablates: it compiles copies of the kernel with one phase
taken out (the products, E, the window staging, the fifth m tile's warp)
and times each beside the kernel at chip_smoke's 1080p shapes (510 CTUs, R
= 32; B7 at k = 4), a sample being 10 launches between CUDA events, median
of 20.  The copies give wrong results and serve only as timings.  It also
times a kernel that issues only independent mma.sync m16n8k32 u8 products,
which gives the instruction's own rate on this card (the published 1,979
TOP/s is wgmma's; tools/b9_b15_phase_costs.py's instruction_rates).  Prints one JSON line with the card's name and power
limit.  The copies are built under build/k1_phase_costs/.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

# name -> (text in the kernel's source, its replacement)
ABLATIONS = {
    "kernel": [],
    "without the products": [("if (warp < mt_count) {\n      uint2 zn",
                              "if (false) {\n      uint2 zn")],
    "without E": [("if (tid < wide) {\n        int cs", "if (false) {\n        int cs"),
                  ("if (tid < rows) {\n        int32_t* row",
                   "if (false) {\n        int32_t* row")],
    "without the window staging": [("i0 < words; i0 +=", "i0 < 0; i0 +=")],
    "without the fifth m tile": [("const int mt_count = (num + 15) / 16,",
                                  "const int mt_count = min(4, (num + 15) / 16),")],
}

def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.kernels import build
    from tools.b9_b15_phase_costs import instruction_rates

    if not torch.cuda.is_available():
        print("k1_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "k1_phase_costs"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ssd_grid_plane.cu").read_text()
    cmds, libs = [], {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"{name}: the kernel no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        libs[name] = out_dir / f"v{i}.so"
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(cu)])
    build._run_all(cmds)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, gr, gc, r = 510, 17, 30, cs.SEARCH_RANGE
    src = torch.as_tensor(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8), device=dev)
    planes = torch.as_tensor(rng.integers(0, 256, (4, 64 * gr + 2 * r, 64 * gc + 2 * r),
                                          dtype=np.uint8), device=dev)
    out = torch.empty((n, 4, 2 * r + 1, 2 * r + 1), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": cs.card_line(), "shapes": "510 CTUs, R = 32; B7 at k = 4"}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.hevc_ssd_grid_plane_multi
        fn.argtypes = build._ENTRIES["hevc_ssd_grid_plane_multi"]
        fn.restype = ctypes.c_int

        def launch(k, fn=fn):
            err = fn(src.data_ptr(), planes.data_ptr(), out.data_ptr(), n, k, gc,
                     planes.stride(0), planes.stride(1), r, 0, stream)
            build.check(err, name)

        result[name] = {"k1_ms": cs.median_ms(lambda: launch(1), calls=10),
                        "b7_k4_ms": cs.median_ms(lambda: launch(4), calls=10)}
    result["mma.sync m16n8k32 u8"] = instruction_rates()["mma.sync m16n8k32 u8"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
