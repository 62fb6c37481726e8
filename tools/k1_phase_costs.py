#!/usr/bin/env python3
"""What each phase of the kernels on K1's u8 tensor-core core costs on a CUDA
card: K1/B7 (hevcasm_tpu_torch/csrc/ssd_grid_plane.cu), B17
(csrc/search_mv.cu) and B19 (csrc/mega.cu), all over csrc/ssd_tc_core.cuh;
and the rate of the tensor-core instruction they use.

    python3 tools/k1_phase_costs.py

The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this ablates: it compiles copies of each kernel with one phase
taken out, or one design choice changed, and times each beside the kernel
at chip_smoke's 1080p shapes (510 CTUs, R = 32; B7 at k = 4), a sample
being 10 launches between CUDA events, median of 20.  An edit names the
file it applies to: the kernel's source or the shared header, which the
copy then carries beside it.  The copies that drop a phase give wrong
results and serve only as timings.  It also times a kernel that issues
only independent mma.sync m16n8k32 u8 products, which gives the
instruction's own rate on this card (the published 1,979 TOP/s is
wgmma's; tools/b9_b15_phase_costs.py's instruction_rates).  Prints one
JSON line with the card's name and power limit.  The copies are built
under build/k1_phase_costs/.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path[:0] = [str(ROOT)]

CORE = "ssd_tc_core.cuh"
# B19 with E after the products, by all 256 threads in one part (no overlap).
_B19_OVERLAP = """  } else {
    hevc_tc::window_energy(m.search.win, m.search.e, 0, num, wide, num, t - E_FIRST,
                           NT - E_FIRST, hevc_tc::NamedSync<1, NT - E_FIRST>());
  }
  __syncthreads();"""
_B19_AFTER = """  }
  __syncthreads();
  hevc_tc::window_energy(m.search.win, m.search.e, 0, num, wide, num, t, NT,
                         hevc_tc::BlockSync());
  __syncthreads();"""
_NO_PRODUCTS = ("#pragma unroll 2\n  for (int y = 0; y < CTU; ++y) {",
                "#pragma unroll 2\n  for (int y = 0; y < 0; ++y) {")
_NO_E = [("for (int c = t; c < wide; c += nth) {", "for (int c = t; c < 0; c += nth) {"),
         ("for (int r = t; r < rows; r += nth) {", "for (int r = t; r < 0; r += nth) {")]
_NO_STAGING = ("i0 < words; i0 +=", "i0 < 0; i0 +=")

# kernel -> (source, C entry, {variant: [(file, text in it, its replacement)]})
ABLATIONS = {
    "K1": ("ssd_grid_plane.cu", "hevc_ssd_grid_plane_multi", {
        "kernel": [],
        "without the products": [(CORE, *_NO_PRODUCTS)],
        "without E": [(CORE, *edit) for edit in _NO_E],
        "without the window staging": [(CORE, *_NO_STAGING)],
        "without the fifth m tile": [("ssd_grid_plane.cu",
                                      "const int mt_count = (num + 15) / 16,",
                                      "const int mt_count = min(4, (num + 15) / 16),")],
    }),
    "B17": ("search_mv.cu", "hevc_search_mv", {
        "kernel": [],
        "without the products": [(CORE, *_NO_PRODUCTS)],
        "without E": [(CORE, *edit) for edit in _NO_E],
        "without the window staging": [(CORE, *_NO_STAGING)],
        "without the keyed epilogue": [("search_mv.cu",
                                        "if (warp < mt_count && (warp >= 2) == (part == 1))",
                                        "if (false)")],
    }),
    "B19": ("mega.cu", "hevc_mega", {
        "kernel": [],
        "without the products": [(CORE, *_NO_PRODUCTS)],
        "without E": [(CORE, *edit) for edit in _NO_E],
        "E after the products, 256 threads": [("mega.cu", _B19_OVERLAP, _B19_AFTER)],
        "without the refinement and residual": [(
            "mega.cu", "  // ---- 2. refine at the integer MV",
            "  return;\n  // ---- 2. refine at the integer MV")],
        "three blocks an SM (at most 80 registers)": [(
            "mega.cu", "__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 3)")],
    }),
}


def edited_sources(kernel: str, edits, csrc: Path) -> dict:
    """{file name: text} of the kernel's source and of every file an edit
    names, with the edits made; raises if a text is missing."""
    source = ABLATIONS[kernel][0]
    texts = {source: (csrc / source).read_text()}
    for name, old, new in edits:
        texts.setdefault(name, (csrc / name).read_text())
        if old not in texts[name]:
            raise AssertionError(f"{kernel}: {name} no longer holds {old!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode.loop import EncodeConfig
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.utils.tensor import PAD_L
    from tools.b9_b15_phase_costs import instruction_rates

    if not torch.cuda.is_available():
        print("k1_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "k1_phase_costs"
    cmds, libs = [], {}
    for kernel, (source, _, variants) in ABLATIONS.items():
        for i, (name, edits) in enumerate(variants.items()):
            vdir = out_dir / f"{kernel}_v{i}"
            vdir.mkdir(parents=True, exist_ok=True)
            for fname, text in edited_sources(kernel, edits, build.CSRC).items():
                (vdir / fname).write_text(text)
            libs[(kernel, name)] = vdir / "lib.so"
            # The copy's own directory comes first, so an edited header beside
            # it is the one its #include finds.
            cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(vdir), "-I",
                         str(build.CSRC), "-shared", "-o", str(libs[(kernel, name)]),
                         str(vdir / source)])
    build._run_all(cmds)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, gr, gc, r = 510, 17, 30, cs.SEARCH_RANGE
    src = torch.as_tensor(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8), device=dev)
    planes = torch.as_tensor(rng.integers(0, 256, (4, 64 * gr + 2 * r + 7, 64 * gc + 2 * r + 7),
                                          dtype=np.uint8), device=dev)
    plane = planes[0].contiguous()
    out = torch.empty((n, 4, 2 * r + 1, 2 * r + 1), dtype=torch.int32, device=dev)
    pos = torch.as_tensor([[64 * (i // gc), 64 * (i % gc)] for i in range(n)],
                          dtype=torch.int32, device=dev)
    mv = torch.empty((n, 2), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.int32, device=dev)
    frac = torch.empty((n,), dtype=torch.int32, device=dev)
    rec = torch.empty((n, 64, 64), dtype=torch.uint8, device=dev)
    nnz = torch.empty((n, 8, 8), dtype=torch.int32, device=dev)
    cfg = EncodeConfig(search_range=r, qp=32)
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": cs.card_line(),
              "shapes": "510 CTUs, R = 32; B7 at k = 4; B17 and B19 on one padded plane"}
    for (kernel, name), path in libs.items():
        entry = ABLATIONS[kernel][1]
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = build._ENTRIES[entry]
        fn.restype = ctypes.c_int

        def call(*args, fn=fn, name=name):
            build.check(fn(*args), name)

        if kernel == "K1":
            def launch(k):
                call(src.data_ptr(), planes.data_ptr(), out.data_ptr(), n, k, gc,
                     planes.stride(0), planes.stride(1), r, 0, stream)

            row = {"k1_ms": cs.median_ms(lambda: launch(1), calls=10),
                   "b7_k4_ms": cs.median_ms(lambda: launch(4), calls=10)}
        elif kernel == "B17":
            row = {"b17_ms": cs.median_ms(lambda: call(
                src.data_ptr(), plane.data_ptr(), pos.data_ptr(), PAD_L, mv.data_ptr(),
                best.data_ptr(), n, plane.shape[0], plane.shape[1], r, 0, stream), calls=10)}
        else:
            row = {"b19_ms": cs.median_ms(lambda: call(
                src.data_ptr(), plane.data_ptr(), pos.data_ptr(), rec.data_ptr(),
                mv.data_ptr(), frac.data_ptr(), best.data_ptr(), nnz.data_ptr(), n,
                plane.shape[0], plane.shape[1], r, *qargs, 0, stream), calls=10)}
        result[f"{kernel} {name}"] = row
    result["mma.sync m16n8k32 u8"] = instruction_rates()["mma.sync m16n8k32 u8"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
