#!/usr/bin/env python3
"""What each phase of B5 and B6 costs on a CUDA card
(hevcasm_tpu_torch/csrc/mc.cu over csrc/mc_tc.cuh), and what a few design
choices of the tiling cost.

    python3 tools/mc_phase_costs.py

The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this compiles copies of mc.cu with one phase of mc_tc.cuh taken
out at a time, or one design choice changed, and times each, a sample
being 10 launches between CUDA events (median of 20) and as device time
(torch.profiler, the kernel's self time a call, median of 3).  The phases:
the staging of the windows (their loads from device memory; the shared
stores stay); the horizontal pass (its products); the vertical pass (its
products); the stores of the output; everything after the staging; and
everything (an empty kernel launched on the same grid).  An ablated copy keeps every value a
later phase reads alive, gives wrong results and serves only as a timing;
a design variant gives right results.  Shapes: 510 64x64 luma blocks
(8-tap) and 1020 32x32 chroma blocks (4-tap) of random windows at random
per-block fractions, uni- and bi-prediction.  Prints the ptxas report
(registers, spills) of every copy, the unablated kernels' device time on
an idle card and right after a second of float32 products (with the SM
clock nvidia-smi reads), and one JSON line with the card's name and power
limit.  The copies are built under build/mc_phase_costs/.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path[:0] = [str(HERE)]

HEADER = "mc_tc.cuh"
SOURCE = "mc.cu"

# variant -> [(text in the header, its replacement)]
VARIANTS = {
    "kernel": [],
    "without the window loads": [(
        "      cp_async16(win + r * ws + 16 * q,\n"
        "                 reinterpret_cast<const uint8_t*>((a & ~uintptr_t(15)) + 16 * q));",
        "      *reinterpret_cast<uint32_t*>(win + r * ws + 16 * q) = static_cast<uint32_t>(a);")],
    "without the horizontal products": [(
        "  mma_s8u8(d0, a, __funnelshift_r(lds32(p), lds32(p + 4), sh),\n"
        "           __funnelshift_r(lds32(p + 16), lds32(p + 20), sh));",
        "  d0[0] = __funnelshift_r(lds32(p), lds32(p + 4), sh) ^ a[0];\n"
        "  d0[1] = __funnelshift_r(lds32(p + 16), lds32(p + 20), sh);\n"
        "  d0[2] = d0[0] + a[3];\n  d0[3] = d0[1] ^ a[1];"), (
        "  mma_s8u8(d1, a, __funnelshift_r(lds32(p), lds32(p + 4), sh),\n"
        "           __funnelshift_r(lds32(p + 16), lds32(p + 20), sh));",
        "  d1[0] = __funnelshift_r(lds32(p), lds32(p + 4), sh);\n"
        "  d1[1] = __funnelshift_r(lds32(p + 16), lds32(p + 20), sh) ^ a[0];\n"
        "  d1[2] = d1[0] + 7;\n  d1[3] = d1[1] + 1;")],
    "without the vertical products": [(
        "  mma_s8s8(d, a, k0.hi[G], k1.hi[G]);\n#pragma unroll\n"
        "  for (int j = 0; j < 4; ++j) d[j] *= 256;\n  mma_s8u8(d, a, k0.lo[G], k1.lo[G]);",
        "  d[0] += k0.hi[G] ^ a[0];\n  d[1] += k1.hi[G];\n  d[2] += k0.lo[G] ^ a[1];\n"
        "  d[3] += k1.lo[G] ^ a[3];")],
    "without the stores": [(
        "    store_rows(o, g.h, g.w, 16 * q, 16 * s, v[0], v[1]);",
        "    if ((v[0][0] ^ v[0][1] ^ v[0][2] ^ v[0][3] ^ v[1][0] ^ v[1][1] ^ v[1][2] ^ v[1][3]) "
        "== 0x12345)\n      o[threadIdx.x] = 1;")],
    "only the staging (no task)": [(
        "  cp_async_wait_all();\n  __syncthreads();\n"
        "  for (int k = threadIdx.x >> 5; k < g.tasks; k += nthreads >> 5) {",
        "  cp_async_wait_all();\n  __syncthreads();\n"
        "  if (f[0] == 0x7fffffff) o[0] = smem[threadIdx.x];\n"
        "  for (int k = threadIdx.x >> 5; k < 0; k += nthreads >> 5) {")],
    "nothing (an empty kernel of the same grid)": [(
        "  constexpr int PHASES = T == 8 ? 4 : 8;\n  int f[4];",
        "  if (a.n >= 0) return;\n  constexpr int PHASES = T == 8 ? 4 : 8;\n  int f[4];")],
    # design variants (right results)
    "one step a warp (SPW 1)": [("constexpr int SPW = 4;", "constexpr int SPW = 1;")],
    "two steps a warp (SPW 2)": [("constexpr int SPW = 4;", "constexpr int SPW = 2;")],
    "at most 64 registers (4 CTAs an SM)": [("constexpr int MIN_CTAS = 1;",
                                             "constexpr int MIN_CTAS = 4;")],
    "two steps a warp, at most 64 registers": [
        ("constexpr int SPW = 4;", "constexpr int SPW = 2;"),
        ("constexpr int MIN_CTAS = 1;", "constexpr int MIN_CTAS = 4;")],
    "up to 16 warps a CTA": [("constexpr int MAX_WARPS = 8;", "constexpr int MAX_WARPS = 16;")],
    "full runs without the step check": [
        ("template <bool BI>\n__device__ __forceinline__ void strip_task(",
         "template <bool BI, bool FULL>\n__device__ __forceinline__ void strip_task("),
        ("    if (q >= q1) break;", "    if (!FULL && q >= q1) break;"),
        ("    strip_task<BI>(g, w0, w1, s, q0, q1, b0, b1, o);",
         "    if (q1 - q0 == SPW) strip_task<BI, true>(g, w0, w1, s, q0, q1, b0, b1, o);\n"
         "    else strip_task<BI, false>(g, w0, w1, s, q0, q1, b0, b1, o);")],
}


# The variants above whose results are wrong (timings only).
ABLATED = ("without", "only", "nothing")


def edited_header(edits, csrc: Path) -> str:
    """The header's text with the edits made; raises if a text is missing."""
    text = (csrc / HEADER).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{HEADER} holds {old!r} {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.kernels import build, mc

    if not torch.cuda.is_available():
        print("mc_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    csrc = Path(build.CSRC)
    out_dir = HERE / "build" / "mc_phase_costs"
    procs, libs = [], {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / HEADER).write_text(edited_header(edits, csrc))
        (vdir / SOURCE).write_text((csrc / SOURCE).read_text())
        libs[name] = vdir / "mc.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(vdir), "-shared",
               "-o", str(libs[name]), str(vdir / SOURCE)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {name}")
        regs = [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]
        print(f"{name} ptxas: {' | '.join(regs)}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    shapes = {"luma 510 64x64": (510, 64, 8), "chroma 1020 32x32": (1020, 32, 4)}
    cases = {}
    for what, (n, b, taps) in shapes.items():
        wins = [torch.as_tensor(rng.integers(0, 256, (n, b + taps - 1, b + taps - 1),
                                             dtype=np.uint8), device=dev) for _ in range(2)]
        fr = [torch.as_tensor(rng.integers(0, mc.PHASES[taps], (n,)), dtype=torch.int32,
                              device=dev) for _ in range(4)]
        out = torch.empty((n, b, b), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = mc._ARGS.pack(
            wins[0].data_ptr(), wins[1].data_ptr(), wins[0].stride(0), wins[1].stride(0),
            wins[0].stride(1), wins[1].stride(1), *(f.data_ptr() for f in fr), 1, 1, 1, 1,
            0, 0, 0, 0, out.data_ptr(), n, b, b, taps, 0, stream)
        want = {"uni": mc.pred_uni_ref(wins[0], fr[0], fr[1], taps),
                "bi": mc.pred_bi_ref(wins[0], wins[1], *fr, taps)}
        cases[what] = (args, out, want, wins, fr)

    result = {"card": cs.card_line(),
              "shapes": "510 64x64 luma (8-tap) and 1020 32x32 chroma (4-tap) blocks, random "
                        "windows, random per-block fractions"}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for op in ("uni", "bi"):
            fn = getattr(lib, f"hevc_pred_{op}")
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
            for what, (args, out, want, _, _) in cases.items():
                def run(fn=fn, args=args):
                    build.check(fn(args), name)
                run()
                torch.cuda.synchronize()
                if not name.startswith(ABLATED) and not torch.equal(out, want[op]):
                    raise AssertionError(f"{name} {op} {what}: differs from the plain version")
                key = f"B{5 if op == 'uni' else 6} {what} {name}"
                result[key] = cs.median_ms(run, calls=10)
                result[f"{key} (device)"] = statistics.median(cs.device_ms(run) for _ in range(3))
                print(f"{key}: {result[key]:.4f} ms, device {result[key + ' (device)']:.4f}"
                      f"{'' if name.startswith(ABLATED) else ', right'}", flush=True)
    # The unablated kernels' device time on an idle card (2 s after the last
    # launch) and on a busy one (right after 1 s of back-to-back float32
    # products), with the SM clock nvidia-smi reads beside each.
    lib = ctypes.CDLL(str(libs["kernel"]))
    big = torch.ones((4096, 4096), device=dev)

    def busy():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:
            for _ in range(8):
                big @ big
            torch.cuda.synchronize()

    def sm_clock():
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()

    for op in ("uni", "bi"):
        fn = getattr(lib, f"hevc_pred_{op}")
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        for what, (args, *_) in cases.items():
            def run(fn=fn, args=args):
                build.check(fn(args), "kernel")
            key = f"B{5 if op == 'uni' else 6} {what} kernel"
            time.sleep(2)
            clock = sm_clock()
            result[f"{key} (device, idle card)"] = cs.device_ms(run)
            busy()
            result[f"{key} (device, busy card)"] = cs.device_ms(run)
            print(f"{key}: device {result[key + ' (device, idle card)']:.4f} ms on an idle card "
                  f"(SM clock before: {clock}), {result[key + ' (device, busy card)']:.4f} right "
                  f"after 1 s of products (SM clock after: {sm_clock()})", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
