#!/usr/bin/env python3
"""What each phase of the residual stage costs on a CUDA card: B4
(hevcasm_tpu_torch/csrc/residual_ctu.cu) at 4x4 DST-VII, 4x4, 8x8, 16x16
and 32x32 TUs, and the residual of K2 (csrc/inter_fused.cu, which runs the
stage at 8x8 after its refinement).

    python3 tools/residual_phase_costs.py [ROOT]

ROOT is a checkout (default: this one); its csrc/ is ablated, so the tool
also reads a parent's design: unpack it first with
``mkdir -p build/parent && git archive HEAD | tar -x -C build/parent``.
The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this compiles copies of both kernels with one phase of
csrc/residual_core.cuh taken out at a time and times each beside the
kernel, a sample being 10 launches between CUDA events, median of 20, and
as device time (torch.profiler, the kernels' self time a call).  The
phases: the forward rows; the forward columns with the quantizer and the
per-TU counts; the inverse columns; the inverse rows with the add, the
clip and the store.  The edits are those of ROOT's design: the CUDA-core
stage (one TU-long row or column a thread, shared int32 planes between the
passes, per-TU counts by shared atomics) or the tensor-core stage that
replaced it (a warp a tile, the four passes on mma.sync chained in
registers, counts by shuffles).  The CUDA-core design also gets two design
variants, wrong in their results and kept as timings only: its shared
atomics as plain stores, and its row passes' shared accesses skewed so
that the 32 lanes of a warp hit 32 banks at 8x8 TUs.  An ablated copy
keeps every value a later phase reads alive, gives wrong results and
serves only as a timing.  Inputs: 510 CTUs (a 1920x1088 frame) of random
source and random prediction (the most nonzero levels), qp 32; K2's
refinement windows at random MVs in [-32, 32] of a random plane.  The
unablated B4 at 8x8 is also timed, three times in turns, on random source
over random prediction, over the structured pan's luma, and on the pan's
picture over its reference (the kernel has no branch on the data).
Prints the ptxas report (registers, spills, shared memory) of the
unablated kernels and one JSON line with the card's name and power limit.
The copies are built under build/residual_phase_costs/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path[:0] = [str(HERE)]

HEADER = "residual_core.cuh"
# B4's variants: (tu, tr_type).
VARIANTS = ((4, 1), (4, 0), (8, 0), (16, 0), (32, 0))

# design -> {phase: [(text in the header, its replacement)]}
DESIGNS = {
    "CUDA cores": {
        "kernel": [],
        "without the forward rows": [(
            "  for (int item = t; item < B * K; item += NT) {\n"
            "    const int b = item % K, p = item / K;\n    int res[TU];",
            "  for (int item = t; item < 0; item += NT) {\n"
            "    const int b = item % K, p = item / K;\n    int res[TU];")],
        "without the columns, quantizer and counts": [
            ("      int v = 0;\n#pragma unroll\n"
             "      for (int r = 0; r < TU; ++r) v += tmat<TU, DST>(m, r) * in[r];\n"
             "      const int q = quantize(wrap16((v + (1 << (S2 - 1))) >> S2), qscale, qshift, "
             "qoffset);\n      cnt += q != 0;\n      bits += egk_bits(q);",
             "      const int q = in[m];"),
            ("    atomicAdd(&s_nnz[a * K + col / TU], cnt);\n"
             "    atomicAdd(&s_bits[a * K + col / TU], bits);", "")],
        "without the inverse columns": [
            ("    if constexpr (FUSED) {\n#pragma unroll\n      for (int k = 0; k < TU; ++k) {",
             "    if constexpr (FUSED) {\n#pragma unroll\n      for (int k = 0; k < 0; ++k) {"),
            ("  if constexpr (!FUSED) {\n    for (int item = t; item < B * K; item += NT) {",
             "  if constexpr (!FUSED) {\n    for (int item = t; item < 0; item += NT) {")],
        "without the inverse rows, add and clip": [(
            "  for (int item = t; item < B * K; item += NT) {\n"
            "    const int b = item % K, p = item / K;\n    int in[TU];",
            "  for (int item = t; item < 0; item += NT) {\n"
            "    const int b = item % K, p = item / K;\n    int in[TU];")],
        # design variants, not phases
        "atomics as plain stores": [(
            "    atomicAdd(&s_nnz[a * K + col / TU], cnt);\n"
            "    atomicAdd(&s_bits[a * K + col / TU], bits);",
            "    s_nnz[a * K + col / TU] = cnt;\n    s_bits[a * K + col / TU] = bits;")],
        "row passes skewed over 32 banks": [
            ("      s_a[p * B + TU * b + k] = wrap16(",
             "      s_a[p * B + ((TU * b + k + 2 * p + b / 4) & (B - 1))] = wrap16("),
            ("    for (int c = 0; c < TU; ++c) in[c] = s_inv[p * B + TU * b + c];",
             "    for (int c = 0; c < TU; ++c) in[c] = s_inv[p * B + ((TU * b + c + 2 * p + b / 4) "
             "& (B - 1))];")],
    },
    "tensor cores": {
        "kernel": [],
        "without the forward rows": [(
            "    restc::forward_rows<S>(src, pred, mt, s1);",
            "#pragma unroll\n    for (int j = 0; j < S::NTL; ++j)\n#pragma unroll\n"
            "      for (int r = 0; r < 4; ++r) s1[j][r] = src[8 * j + r] - pred[8 * j + r];")],
        "without the columns, quantizer and counts": [(
            "    restc::forward_columns<S>(s1, mt, qp, dqh, dql, counts);",
            "#pragma unroll\n    for (int h = 0; h < 2; ++h)\n#pragma unroll\n"
            "      for (int s = 0; s < S::BR; ++s) {\n"
            "        dqh[2 * mt + h][s] = s1[2 * s][2 * h];\n"
            "        dql[2 * mt + h][s] = s1[2 * s + 1][2 * h + 1];\n      }")],
        "without the inverse columns": [(
            "    restc::inverse_columns<S>(dqh, dql, mt, r1);",
            "#pragma unroll\n    for (int n = 0; n < S::NTL; ++n)\n#pragma unroll\n"
            "      for (int r = 0; r < 4; ++r)\n"
            "        r1[n][r] = static_cast<int>((dqh[n][0] ^ dql[n][S::BR - 1]) >> (8 * r));")],
        "without the inverse rows, add and clip": [(
            "    restc::inverse_rows<S>(r1, pred, out, mt);",
            "    {\n      int x = 0;\n#pragma unroll\n      for (int n = 0; n < S::NTL; ++n)\n"
            "#pragma unroll\n        for (int r = 0; r < 4; ++r) x ^= r1[n][r];\n"
            "      if (x == 0x7fffffff) out[threadIdx.x & 31] = 1;\n    }")],
    },
}
KERNELS = {"B4": ("residual_ctu.cu", "hevc_residual_ctu"),
           "K2": ("inter_fused.cu", "hevc_inter_fused")}


def design_of(csrc: Path) -> str:
    return "CUDA cores" if "tmat<TU, DST>" in (csrc / HEADER).read_text() else "tensor cores"


def edited_header(edits, csrc: Path) -> str:
    """The header's text with the edits made; raises if a text is missing."""
    text = (csrc / HEADER).read_text()
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{HEADER} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode.loop import EncodeConfig
    from hevcasm_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("residual_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    csrc = root / "hevcasm_tpu_torch" / "csrc"
    design = design_of(csrc)
    out_dir = HERE / "build" / "residual_phase_costs"
    procs, libs = [], {}
    for i, (phase, edits) in enumerate(DESIGNS[design].items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / HEADER).write_text(edited_header(edits, csrc))
        for kernel, (source, _) in KERNELS.items():
            (vdir / source).write_text((csrc / source).read_text())
            libs[(kernel, phase)] = vdir / f"{kernel}.so"
            # The copy's own directory comes first, so the edited header beside
            # it is the one its #include finds.
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(vdir), "-I",
                   str(csrc), "-shared", "-o", str(libs[(kernel, phase)]), str(vdir / source)]
            procs.append(((kernel, phase), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for (kernel, phase), proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {kernel} {phase}")
        if phase == "kernel":
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"{kernel} ptxas: {line.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, gr, gc, r = 510, 17, 30, cs.SEARCH_RANGE
    hp, wp = 64 * gr + 2 * r + 7, 64 * gc + 2 * r + 7
    src = torch.as_tensor(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8), device=dev)
    pred = torch.as_tensor(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8), device=dev)
    plane = torch.as_tensor(rng.integers(0, 256, (hp, wp), dtype=np.uint8), device=dev)
    pos = np.array([[64 * (i // gc), 64 * (i % gc)] for i in range(n)])
    mv = np.random.default_rng(1).integers(-r, r + 1, (n, 2))
    offsets = torch.as_tensor(pos + mv + r, dtype=torch.int32, device=dev)
    rec = torch.empty((n, 64, 64), dtype=torch.uint8, device=dev)
    ints = [torch.empty((n, 64), dtype=torch.int32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def qargs(tu, tr_type):
        cfg = EncodeConfig(search_range=r, qp=32, tu=tu)
        return (*cfg.quant_params(bool(tr_type)), *cfg.dequant_params())

    def timings(kernel, call):
        if kernel == "B4":
            for tu, tr_type in VARIANTS:
                yield f" tu={tu} {'DST' if tr_type else 'DCT'}", \
                    lambda tu=tu, tr_type=tr_type, q=qargs(tu, tr_type): call(
                        src.data_ptr(), pred.data_ptr(), rec.data_ptr(), ints[0].data_ptr(), n,
                        tu, tr_type, *q, 0, stream)
        else:
            yield "", lambda q=qargs(8, 0): call(
                src.data_ptr(), plane.data_ptr(), offsets.data_ptr(), rec.data_ptr(),
                ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(), ints[3].data_ptr(),
                n, hp, wp, *q, 0, stream)

    result = {"card": cs.card_line(), "root": str(root), "design": design,
              "shapes": "510 CTUs, random source and prediction, qp 32; K2's windows at "
                        "random MVs in [-32, 32]"}
    for (kernel, phase), path in libs.items():
        entry = KERNELS[kernel][1]
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = build._ENTRIES[entry]
        fn.restype = ctypes.c_int

        def call(*args, fn=fn, phase=phase):
            build.check(fn(*args), phase)

        for shape, run in timings(kernel, call):
            result[f"{kernel}{shape} {phase}"] = cs.median_ms(run, calls=10)
            result[f"{kernel}{shape} {phase} (device)"] = cs.device_ms(run)
    # The unablated B4 at 8x8 on other content, in turns: a smooth picture
    # (the structured pan's luma) as prediction, and as both operands.
    fn = getattr(ctypes.CDLL(str(libs[("B4", "kernel")])), KERNELS["B4"][1])
    fn.argtypes = build._ENTRIES[KERNELS["B4"][1]]
    pan_cur, pan_ref = (torch.as_tensor(f[0][:64 * gr, :64 * gc], device=dev).reshape(
        gr, 64, gc, 64).transpose(1, 2).reshape(n, 64, 64).contiguous()
        for f in cs.structured_pan(64 * gr, 64 * gc)[:2])
    q8 = qargs(8, 0)
    contents = {"random over random": (src, pred), "random over the pan": (src, pan_ref),
                "the pan over the pan": (pan_cur, pan_ref)}
    for _ in range(3):
        for what, (s, pr) in contents.items():
            ms = cs.device_ms(lambda s=s, pr=pr: build.check(fn(
                s.data_ptr(), pr.data_ptr(), rec.data_ptr(), ints[0].data_ptr(), n, 8, 0, *q8,
                0, stream), "B4"))
            result.setdefault(f"B4 tu=8 DCT kernel, {what} (device)", []).append(ms)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
