#!/usr/bin/env python3
"""What each phase of the quarter-pel refinement kernels costs on a CUDA
card: K2 (hevcasm_tpu_torch/csrc/inter_fused.cu, which B16 also launches),
B3 (csrc/bi_fused.cu) and, in a checkout that has the small-tile core
(csrc/refine_tile_tc.cuh), B11 (csrc/refine_fused.cu) and B13
(csrc/costmap.cu).

    python3 tools/refine_phase_costs.py [ROOT]

ROOT is a checkout (default: this one); its csrc/ is ablated, so the tool
also reads a parent's design: unpack it first with
``mkdir -p build/parent && git archive HEAD | tar -x -C build/parent``.
The card has no profiler that reads a kernel's stalls (ncu does not run
there), so this compiles copies of each kernel with one phase taken out at
a time and times each beside the kernel, a sample being 10 launches between
CUDA events, median of 20.  K2 and B3: the window staging, the horizontal
pass, the vertical pass with the score, the reduction to the first minimum,
the winner's recomputation, the residual; at chip_smoke's 1080p shapes, 510
CTUs, random content, refine windows at random MVs in [-32, 32] (B3 in two
stacked planes), qp = 32; the edits are those of ROOT's design, the
tensor-core refinement (csrc/refine_tc_core.cuh) or the CUDA-core one it
replaced (csrc/refine_core.cuh).  B11 and B13: the window, the horizontal
pass, the vertical pass with the score, the warp's reduction, B11's winner
and its prediction's store, B13's window store; each edit takes the phase
out of both the small-tile core and (B11 at 64) K2's block core; B11 at 510
64x64 and 8160 16x16 gathered windows, B13 at 8160 16x16 and 32640 8x8
tiles, random content at random offsets.  An ablated copy keeps every value
a later phase reads alive, gives wrong results and serves only as a timing.
B11 and B13 are also timed with the register budget of three blocks an SM
(a design choice; the kernels take four).  Each time is given also as device time (torch.profiler,
the kernels' self time a call), since a launch from Python can take longer
than these kernels.
Prints the ptxas report (registers, spills, shared memory) of the
unablated kernels and one JSON line with the card's name and power limit.
The copies are built under build/refine_phase_costs/.
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

_RESIDUAL_TC = "  residual_ctu8(sm.src, sm.win, rec + static_cast<size_t>(i) * B * B,"
_RESIDUAL_CC = "  residual_core<8>(s_src, s_pred, reinterpret_cast<int*>(sm.hp), s_nnz, s_bits,"


def _no_residual(call: str, pred: str) -> tuple[str, str]:
    """The residual call replaced by a copy of the prediction to rec."""
    return (call, "  for (int k = threadIdx.x; k < B * B; k += NT)\n"
                  f"    rec[static_cast<size_t>(i) * B * B + k] = {pred}[k];\n"
                  f"  if (false)\n{call}")


# design -> (header, {phase: [(file, text in it, its replacement)]}); an
# edit of the header applies to both kernels, an edit of "KERNEL" to the
# kernel's own source.
DESIGNS = {
    "tensor cores (refine_tc_core.cuh)": ("refine_tc_core.cuh", {
        "kernel": [],
        "without the window": [(
            "refine_tc_core.cuh", "for (int k = threadIdx.x; k < ROWS * WORDS; k += NT) {",
            "for (int k = threadIdx.x; k < 0; k += NT) {")],
        "without the horizontal pass": [(
            "refine_tc_core.cuh", "for (int p = warp; p < MT * H_NT; p += NWARPS) {",
            "for (int p = warp; p < 0; p += NWARPS) {")],
        "without the vertical pass and score": [(
            "refine_tc_core.cuh",
            "    for (int j = 0; j < TILES; ++j) {\n      const HpFrag f = hp_fragment(hp, xf, j);",
            "    for (int j = 0; j < 0; ++j) {\n      const HpFrag f = hp_fragment(hp, xf, j);")],
        "without the reduction": [
            ("refine_tc_core.cuh", "int warp_sums4(const int (&v)[4]) {",
             "int warp_sums4(const int (&v)[4]) {\n  return v[0] ^ v[1] ^ v[2] ^ v[3];"),
            ("refine_tc_core.cuh", "  const int lane = threadIdx.x & 31;\n  __syncthreads();",
             "  const int lane = threadIdx.x & 31;\n  {\n    best_cost = s_red[lane];\n"
             "    return best_cost & 15;\n  }\n  __syncthreads();")],
        "without the winner": [(
            "refine_tc_core.cuh", "  vertical_acc(d, wy, hp_fragment(hp, best & 3, j));",
            "  d[0] += best;")],
        "without the residual": [("KERNEL", *_no_residual(_RESIDUAL_TC, "sm.win"))],
    }),
    "CUDA cores (refine_core.cuh)": ("refine_core.cuh", {
        "kernel": [],
        "without the window": [(
            "refine_core.cuh", "for (int k = t; k < S::WIN * S::WIN; k += NTH) {",
            "for (int k = t; k < 0; k += NTH) {")],
        "without the horizontal pass": [(
            "refine_core.cuh", "for (int k = t; k < 4 * S::WIN * BB; k += NTH) {",
            "for (int k = t; k < 0; k += NTH) {")],
        "without the vertical pass and score": [(
            "refine_core.cuh", "  for (int xf = 0; xf < 4; ++xf) {\n    int col[ROWS + 7];",
            "  for (int xf = 0; xf < 0; ++xf) {\n    int col[ROWS + 7];")],
        "without the reduction": [(
            "refine_core.cuh",
            "#pragma unroll\n  for (int c = 0; c < 16; ++c) {\n    int v = cost[c];",
            "  {\n    int v = 0;\n    for (int c = 0; c < 16; ++c) v ^= cost[c];\n"
            "    sm.cost[v & 15] = v;\n    return v & 15;\n  }\n"
            "#pragma unroll\n  for (int c = 0; c < 16; ++c) {\n    int v = cost[c];")],
        "without the winner": [(
            "refine_core.cuh",
            "#pragma unroll\n  for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * hp[tap * BB];\n"
            "  return acc;",
            "  return acc + frac + hp[0];")],
        "without the residual": [("KERNEL", *_no_residual(_RESIDUAL_CC, "s_pred"))],
    }),
}
KERNELS = {"K2": ("inter_fused.cu", "hevc_inter_fused"), "B3": ("bi_fused.cu", "hevc_bi_fused")}

# B11 and B13 on the small-tile core (refine_tile_tc.cuh); B11 at 64 runs K2's
# block core on a gathered window, so its edits also take the phase out there.
TILE_HEADER = "refine_tile_tc.cuh"
TILE_KERNELS = {"B11": ("refine_fused.cu", "hevc_refine_fused"),
                "B13": ("costmap.cu", "hevc_costmap_dma")}
_CTU = DESIGNS["tensor cores (refine_tc_core.cuh)"][1]
_TILE = {
    "kernel": [],
    "without the window": [(
        TILE_HEADER, "for (int k = threadIdx.x & 31; k < T::WIN * T::QW; k += 32) {",
        "for (int k = threadIdx.x & 31; k < 0; k += 32) {")],
    "without the horizontal pass": [(
        TILE_HEADER, "    for (int nt = 0; nt < T::H_NT; ++nt) {",
        "    for (int nt = 0; nt < 0; ++nt) {")],
    "without the vertical pass and score": [(
        TILE_HEADER,
        "    for (int f = 0; f < T::FRAGS; ++f) {\n      const HpFrag fr = tile_fragment<S>(hp, xf, f);",
        "    for (int f = 0; f < 0; ++f) {\n      const HpFrag fr = tile_fragment<S>(hp, xf, f);")],
    "without the reduction": [(
        TILE_HEADER, "res[p][xf] = warp_sums4(v[p]);",
        "res[p][xf] = v[p][0] ^ v[p][1] ^ v[p][2] ^ v[p][3];")],
    # a design choice, not a phase: the register budget of three blocks an SM
    "at 3 blocks an SM": [(
        TILE_HEADER, "static constexpr int MIN_BLOCKS = S == 32 ? 2 : 4;",
        "static constexpr int MIN_BLOCKS = S == 32 ? 2 : 3;")],
}
TILE_PHASES = {
    "B11": {
        **_TILE,
        "without the window": [*_TILE["without the window"], (
            "refine_tc_core.cuh", "for (int k = threadIdx.x; k < WIN * WORDS; k += NT) {",
            "for (int k = threadIdx.x; k < 0; k += NT) {")],
        "without the horizontal pass": [*_TILE["without the horizontal pass"],
                                        *_CTU["without the horizontal pass"]],
        "without the vertical pass and score": [*_TILE["without the vertical pass and score"],
                                                *_CTU["without the vertical pass and score"]],
        "without the reduction": [*_TILE["without the reduction"],
                                  *_CTU["without the reduction"]],
        "at 3 blocks an SM": _TILE["at 3 blocks an SM"],
        "without the winner": [(
            TILE_HEADER, "      vertical_acc(d, wy, tile_fragment<S>(hp, best[p] & 3, f));",
            "      d[0] += best[p];"), *_CTU["without the winner"]],
        "without the prediction's store": [
            ("KERNEL", "for (int k = lane; k < count * S * S / 4; k += 32)",
             "for (int k = lane; k < 0; k += 32)"),
            ("KERNEL", "  out[threadIdx.x] = reinterpret_cast<const uint4*>(sm.win)[threadIdx.x];",
             "  if (best < 0) out[threadIdx.x] = reinterpret_cast<const uint4*>(sm.win)[0];")],
    },
    "B13": {
        **_TILE,
        "without the window's store": [(
            "KERNEL", "for (int k = lane; k < T::WIN * T::WIN; k += 32) {",
            "for (int k = lane; k < 0; k += 32) {")],
    },
}


def design_of(csrc: Path) -> str:
    text = (csrc / "inter_fused.cu").read_text()
    for name, (header, _) in DESIGNS.items():
        if f'#include "{header}"' in text:
            return name
    raise AssertionError(f"{csrc}: inter_fused.cu includes neither refinement header")


def edited_sources(source: str, edits, csrc: Path) -> dict:
    """{file name: text} of the kernel's source and of every file an edit
    names, with the edits made; raises if a text is missing."""
    texts = {source: (csrc / source).read_text()}
    for name, old, new in edits:
        name = source if name == "KERNEL" else name
        texts.setdefault(name, (csrc / name).read_text())
        if old not in texts[name]:
            raise AssertionError(f"{source}: {name} no longer holds {old!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def jobs(csrc: Path) -> dict:
    """{kernel: (source, entry, {phase: edits})} of the checkout's design:
    K2 and B3, and B11 and B13 where it has the small-tile core."""
    phases = DESIGNS[design_of(csrc)][1]
    out = {kernel: (source, entry, phases) for kernel, (source, entry) in KERNELS.items()}
    if (csrc / TILE_HEADER).exists():
        out.update({kernel: (source, entry, TILE_PHASES[kernel])
                    for kernel, (source, entry) in TILE_KERNELS.items()})
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hevcasm_tpu_torch.encode.loop import EncodeConfig
    from hevcasm_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("refine_phase_costs: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    csrc = root / "hevcasm_tpu_torch" / "csrc"
    todo = jobs(csrc)
    out_dir = HERE / "build" / "refine_phase_costs"
    procs, libs = [], {}
    for kernel, (source, _, phases) in todo.items():
        for i, (phase, edits) in enumerate(phases.items()):
            vdir = out_dir / f"{kernel}_v{i}"
            vdir.mkdir(parents=True, exist_ok=True)
            for fname, text in edited_sources(source, edits, csrc).items():
                (vdir / fname).write_text(text)
            libs[(kernel, phase)] = vdir / "lib.so"
            # The copy's own directory comes first, so an edited header beside
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
    planes = torch.as_tensor(rng.integers(0, 256, (2 * hp, wp), dtype=np.uint8), device=dev)
    pos = np.array([[64 * (i // gc), 64 * (i % gc)] for i in range(n)])

    def offsets(seed, row0):
        mv = np.random.default_rng(seed).integers(-r, r + 1, (n, 2))
        return torch.as_tensor(pos + mv + r + [row0, 0], dtype=torch.int32, device=dev)

    off0, off1 = offsets(1, 0), offsets(2, hp)
    cfg = EncodeConfig(search_range=r, qp=32)
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    rec = torch.empty((n, 64, 64), dtype=torch.uint8, device=dev)
    outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(2)]
    nnz, bits = (torch.empty((n, 8, 8), dtype=torch.int32, device=dev) for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    # B11 and B13: each tile of side b of the frame, its window at a random
    # offset in the plane (B11's gathered, (b + 7)^2 each).
    def tiles(b):
        k = 64 // b
        t = src.reshape(n, k, b, k, b).transpose(2, 3).reshape(-1, b, b).contiguous()
        o = np.random.default_rng(b).integers(0, [hp - b - 7, wp - b - 7], (t.shape[0], 2))
        o = torch.as_tensor(o, dtype=torch.int32, device=dev)
        rows = o[:, :1, None] + torch.arange(b + 7, device=dev)[None, :, None]
        cols = o[:, 1:, None] + torch.arange(b + 7, device=dev)[None, None, :]
        return t, o, planes[:hp][rows, cols].contiguous()

    shapes = {b: tiles(b) for b in (64, 16, 8)}
    t_out = {b: (torch.empty_like(shapes[b][0]), torch.empty((shapes[b][0].shape[0], 16),
                                                               dtype=torch.int32, device=dev),
                 torch.empty_like(shapes[b][2]))
             for b in shapes}
    result = {"card": cs.card_line(), "root": str(root), "design": design_of(csrc),
              "shapes": "K2/B3: 510 CTUs, random MVs in [-32, 32], qp 32, B3 in two stacked "
                        "planes; B11: 510 64x64 and 8160 16x16 gathered windows; B13: 8160 "
                        "16x16 and 32640 8x8 tiles; random content and offsets"}

    def timings(kernel, call):
        if kernel == "K2":
            yield "", lambda: call(
                src.data_ptr(), planes.data_ptr(), off0.data_ptr(), rec.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), nnz.data_ptr(), bits.data_ptr(), n,
                hp, wp, *qargs, 0, stream)
        elif kernel == "B3":
            yield "", lambda: call(
                src.data_ptr(), planes.data_ptr(), off0.data_ptr(), off1.data_ptr(),
                rec.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), nnz.data_ptr(),
                bits.data_ptr(), n, 2 * hp, wp, *qargs, 0, stream)
        elif kernel == "B11":
            for b in (64, 16):
                s, _, win = shapes[b]
                pred, cost, _ = t_out[b]
                yield f" {s.shape[0]} {b}x{b}", lambda s=s, win=win, pred=pred, cost=cost, b=b: call(
                    s.data_ptr(), win.data_ptr(), win.stride(0), win.stride(1), pred.data_ptr(),
                    cost.data_ptr(), cost.data_ptr() + 4 * s.shape[0], s.shape[0], b, 0, stream)
        else:
            for b in (16, 8):
                s, o, _ = shapes[b]
                _, cost, win = t_out[b]
                yield f" {s.shape[0]} {b}x{b}", lambda s=s, o=o, cost=cost, win=win, b=b: call(
                    s.data_ptr(), planes.data_ptr(), o.data_ptr(), cost.data_ptr(),
                    win.data_ptr(), s.shape[0], b, hp, wp, 0, stream)

    for (kernel, phase), path in libs.items():
        entry = todo[kernel][1]
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = build._ENTRIES[entry]
        fn.restype = ctypes.c_int

        def call(*args, fn=fn, phase=phase):
            build.check(fn(*args), phase)

        for shape, run in timings(kernel, call):
            result[f"{kernel}{shape} {phase}"] = cs.median_ms(run, calls=10)
            result[f"{kernel}{shape} {phase} (device)"] = cs.device_ms(run)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
