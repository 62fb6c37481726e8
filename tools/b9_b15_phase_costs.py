#!/usr/bin/env python3
"""What each phase of kernels B9 (hevcasm_tpu_torch/csrc/sad_grid.cu), B15
and B14 (csrc/base_grids.cu) and B8 (csrc/ssd_grid.cu) costs on a CUDA
card, and the rates of the two instructions their designs rest on.

    python3 tools/b9_b15_phase_costs.py

The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this ablates: it compiles copies of each kernel's source with
one phase taken out, or one constant changed (B15's n tiles a block, B8's
warps a block), and times each beside the kernel at chip_smoke's 1080p
shapes, a sample being 10 launches between CUDA events, median of 20.  The copies that drop a phase give wrong
results and serve only as timings.  It also times two kernels that issue
only independent instructions: vabsdiff4 with .add (B9's packed term, four
absolute differences added to a sum), mma.sync m16n8k32 u8 (B15's
product) and mma.sync m16n8k16 s8 (the vertical pass of K2's and B3's
refinement), which give each instruction's own rate on this card; chip_smoke
takes its design floors from ``instruction_rates``.  Prints one JSON line
with the card's name and power limit.  The copies are built under
build/b9_b15_phase_costs/.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path[:0] = [str(ROOT)]

# B14's copy of a slab row from the warp's tile.
_B14_COPY = ("if (lane + 32 * k < num) out[r * num + lane + 32 * k] = "
             "tile[r * TW + lane + 32 * k];")

# kernel -> (source, C entry, {variant: [(text in the source, its replacement)]})
ABLATIONS = {
    "B9": ("sad_grid.cu", "hevc_sad_grid", {
        "kernel": [],
        "without the packed terms": [("for (int y = 0; y < B; ++y) {",
                                      "for (int y = 0; y < 0; ++y) {")],
        "without the window staging": [("for (int r = t >> 5; r < wrows;",
                                        "for (int r = t >> 5; r < 0;")],
        "J = 8 at every shape": [("for (int j : {8, 4, 2}) {", "for (int j : {8}) {")],
    }),
    "B15": ("base_grids.cu", "hevc_base_decide", {
        "kernel": [],
        "without the products": [("dispatch_products<BASE, NG>(warp % K,",
                                  "if (false) dispatch_products<BASE, NG>(warp % K,")],
        "without S and E": [("for (int p = 0; p < K; ++p) {\n    for (int x = tid;",
                             "for (int p = 0; p < 0; ++p) {\n    for (int x = tid;")],
        "without the decision": [("for (int pu = 0; pu < num_pu; ++pu) {",
                                  "for (int pu = 0; pu < 0; ++pu) {")],
        "5 n tiles a block at base 16": [("launch_decide<16, 9>", "launch_decide<16, 5>")],
    }),
    "B14": ("base_grids.cu", "hevc_base_grids", {
        "kernel": [],
        "without the products": [("    narrow_products<G::BW, BASE, G::KS, WS, ZW, true>(",
                                  "    if (false) narrow_products<G::BW, BASE, G::KS, WS, ZW, true>(")],
        "without E": [("for (int item = tid; item < 2 * CTU * SEGS; item += THREADS) {",
                       "for (int item = tid; item < 0; item += THREADS) {")],
        "without the grid stores": [(_B14_COPY, _B14_COPY.replace("out[r * num + lane + 32 * k] =",
                                                                  "if (r == -1) out[0] ="))],
        "without the slab copy": [(_B14_COPY, _B14_COPY.replace("< num)", "< 0)"))],
        "streaming stores (st.global.cs)": [
            (_B14_COPY, "if (lane + 32 * k < num) __stcs(out + r * num + lane + 32 * k, "
                        "tile[r * TW + lane + 32 * k]);")],
        "16 warps a block, 2 blocks an SM (<= 64 registers)": [
            ("static constexpr int WARPS = K * K < 8 ? K * K : 8;",
             "static constexpr int WARPS = K * K < 16 ? K * K : 16;"),
            ("__launch_bounds__(B14Geometry<BASE>::THREADS)",
             "__launch_bounds__(B14Geometry<BASE>::THREADS, 2)")],
        "the setup alone": [("  // The warp's sub-blocks (p, q), q = warp % k:",
                             "  return;\n  // The warp's sub-blocks (p, q), q = warp % k:")],
    }),
    "B8": ("ssd_grid.cu", "hevc_ssd_grid", {
        "kernel": [],
        "without the products": [("if (busy) {\n    const BandLane bl",
                                  "if (false) {\n    const BandLane bl")],
        "without E": [("for (int k = tid; k < plan.sb * wcols; k += nth) {",
                       "for (int k = tid; k < 0; k += nth) {")],
        "without the grid rows": [("      if (lane + 32 * k3 < cols) o[lane",
                                   "      if (lane + 32 * k3 < 0) o[lane")],
        "16 warps a block": [("constexpr int TARGET_WARPS = 8;",
                              "constexpr int TARGET_WARPS = 16;")],
    }),
}

RATES_CU = r"""
#include <stdint.h>
__global__ void mma_rate(int* out, int iters) {
  int acc[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = threadIdx.x * 3u, a2 = threadIdx.x * 5u, a3 = 7u;
  const uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void mma16_rate(int* out, int iters) {
  int acc[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = threadIdx.x * 3u, b0 = threadIdx.x * 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
                   "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                   : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
                   : "r"(a0), "r"(a1), "r"(b0));
  }
  int s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void vabsdiff4_rate(unsigned* out, int iters) {
  unsigned acc[8] = {};
  const unsigned a = threadIdx.x * 0x01010101u, b = blockIdx.x * 0x00FF00FFu + 3u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;\n"
                   : "+r"(acc[j]) : "r"(a + j), "r"(b));
  }
  unsigned s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(int* out, int blocks, int threads, int iters) {
  mma_rate<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int mma16_rate_launch(int* out, int blocks, int threads, int iters) {
  mma16_rate<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int vabsdiff4_rate_launch(unsigned* out, int blocks, int threads, int iters) {
  vabsdiff4_rate<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""


def _out_dir() -> Path:
    out = ROOT / "build" / "b9_b15_phase_costs"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _rates_cmd(build, out_dir: Path) -> tuple[list[str], Path]:
    (out_dir / "rates.cu").write_text(RATES_CU)
    lib = out_dir / "rates.so"
    return [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
            str(out_dir / "rates.cu")], lib


def _rates_of(lib_path: Path) -> dict:
    import torch

    import chip_smoke as cs

    lib = ctypes.CDLL(str(lib_path))
    blocks, threads, iters = 132 * 8, 256, 2000
    buf = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    out = {}
    for name in ("mma_rate_launch", "mma16_rate_launch", "vabsdiff4_rate_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        rates = [blocks * threads * iters * 8 / cs.median_ms(
                     lambda: fn(buf.data_ptr(), blocks, threads, iters), reps=5) * 1e3
                 for _ in range(5)]
        out[name] = statistics.median(rates)        # thread instructions a second
    mma = out["mma_rate_launch"] / 32               # one product a warp instruction
    mma16 = out["mma16_rate_launch"] / 32
    return {"mma.sync m16n8k32 u8": {"products_per_s": mma, "tops": mma * 2 * 16 * 8 * 32 / 1e12},
            "mma.sync m16n8k16 s8": {"products_per_s": mma16,
                                     "tops": mma16 * 2 * 16 * 8 * 16 / 1e12},
            "vabsdiff4.add": {"thread_instr_per_s": out["vabsdiff4_rate_launch"],
                              "terms_per_s": 4 * out["vabsdiff4_rate_launch"]}}


def instruction_rates() -> dict:
    """The card's own rates of mma.sync m16n8k32 u8 and m16n8k16 s8
    (products and TOP/s) and of vabsdiff4 with .add (thread instructions
    and SAD terms a second), each from a kernel of independent
    instructions on every SM."""
    from hevcasm_tpu_torch.kernels import build

    cmd, lib = _rates_cmd(build, _out_dir())
    build._run_all([cmd])
    return _rates_of(lib)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode import partition
    from hevcasm_tpu_torch.encode.loop import EncodeConfig
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.kernels.base_grids import _device_table

    if not torch.cuda.is_available():
        print("b9_b15_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    out_dir = _out_dir()
    cmds, libs = [], {}
    for kernel, (source, _, variants) in ABLATIONS.items():
        text0 = (build.CSRC / source).read_text()
        for i, (name, edits) in enumerate(variants.items()):
            text = text0
            for old, new in edits:
                if old not in text:
                    raise AssertionError(f"{kernel} {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            cu = out_dir / f"{kernel}_v{i}.cu"
            cu.write_text(text)
            libs[(kernel, name)] = out_dir / f"{kernel}_v{i}.so"
            cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                         "-o", str(libs[(kernel, name)]), str(cu)])
    rate_cmd, rate_lib = _rates_cmd(build, out_dir)
    build._run_all(cmds + [rate_cmd])

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def u8(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)

    # B9 and B8 at the shapes chip_smoke times: (what, src, windows, num).
    b9_cases = [("510 CTUs, R=32", u8(510, 64, 64), u8(510, 128, 128), 65),
                ("8160 16x16, R=32", u8(8160, 16, 16), u8(8160, 80, 80), 65),
                ("510 16x16, num 17 (pyramid coarse)", u8(510, 16, 16), u8(510, 32, 32), 17),
                ("510 CTUs, num 7 (pyramid fine)", u8(510, 64, 64), u8(510, 70, 70), 7)]
    grid_cases = {"B9": b9_cases,
                  "B8": [("8160 16x16, R=16", u8(8160, 16, 16), u8(8160, 48, 48), 33),
                         ("32640 8x8, R=16", u8(32640, 8, 8), u8(32640, 40, 40), 33),
                         *b9_cases[2:], b9_cases[0]]}
    b15_src, b15_win = u8(510, 64, 64), u8(510, 128, 128)
    layouts = EncodeConfig().pu_layouts
    b15_cases = [("510 CTUs, base 16, 26 PU lists", 16, partition._pu_lists(layouts, 16)),
                 ("510 CTUs, base 32", 32, partition._pu_lists(layouts[:4], 32))]
    result = {"card": cs.card_line()}
    for (kernel, name), path in libs.items():
        lib = ctypes.CDLL(str(path))
        entry = ABLATIONS[kernel][1]
        fn = getattr(lib, entry)
        fn.argtypes = build._ENTRIES[entry]
        fn.restype = ctypes.c_int
        row = {}
        if kernel in grid_cases:
            for what, src, win, num in grid_cases[kernel]:
                n = src.shape[0]
                out = torch.empty((n, num, num), dtype=torch.int32, device=dev)

                def launch(src=src, win=win, num=num, out=out, n=n):
                    build.check(fn(src.data_ptr(), win.data_ptr(), win.stride(0), win.stride(1),
                                   win.shape[1], win.shape[2], out.data_ptr(), n,
                                   src.shape[1], num, num, 0, stream), name)

                row[what] = cs.median_ms(launch, calls=10)
        elif kernel == "B14":
            for base in (8, 16, 32):
                grids = torch.empty((510, 64 // base, 64 // base, 65, 65), dtype=torch.int32,
                                    device=dev)

                def launch(base=base, grids=grids):
                    build.check(fn(b15_src.data_ptr(), b15_win.data_ptr(), b15_win.stride(0),
                                   b15_win.stride(1), grids.data_ptr(), 510, base, 32, 0,
                                   stream), name)

                row[f"510 CTUs, base {base}"] = cs.median_ms(launch, calls=10)
                del grids
        else:
            for what, base, lists in b15_cases:
                table = _device_table(tuple(lists), dev)
                keys = torch.empty((510, len(lists)), dtype=torch.int64, device=dev)
                out = torch.empty((510, len(lists), 3), dtype=torch.int32, device=dev)

                def launch(base=base, lists=lists, table=table, keys=keys, out=out):
                    build.check(fn(b15_src.data_ptr(), b15_win.data_ptr(), b15_win.stride(0),
                                   b15_win.stride(1), table.data_ptr(), len(lists),
                                   table.numel(), keys.data_ptr(), out.data_ptr(), 510, base,
                                   32, 0, stream), name)

                row[what] = cs.median_ms(launch, calls=10)
        result[f"{kernel} {name}"] = row
    result.update(_rates_of(rate_lib))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
