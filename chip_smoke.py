#!/usr/bin/env python3
"""Smoke run of hevcasm_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   a CUDA card must be present; prints nvidia-smi's name and power
            limit of card 0.
2. build    compiles hevcasm_tpu_torch/csrc/*.cu with nvcc (sm_90a) into
            build/ and prints the build time.
3. kernels  each kernel against its plain PyTorch version on the card, bit
            for bit on every output: the 1080p shapes (510 CTUs, R = 32), an
            odd grid width (3) at R = 8, refine offsets at 0 and at the
            maximum, and a constant plane on which every candidate ties.
4. main     encode_inter_frame on a 1920x1088 P frame of bench content
            (seed 0, a pure (2, 3) shift) with
            EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma"):
            both kernels' launch counts must rise, the result must equal the
            plain path on the card, and a small frame must equal the plain
            path on the CPU.
5. timing   CUDA-event medians over 20 samples after warm-up: the main path
            per frame, synchronised after each (ms per frame and CTU/s), and
            20 frames back to back; its plain version; each kernel beside its
            plain version at the 1080p shapes, a kernel sample being 10
            launches back to back so that its host overhead is hidden.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 1088, 1920        # 1080p padded to whole 64x64 CTUs: 17 x 30 = 510
SEARCH_RANGE = 32
REPS = 20
WARMUP = 3


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_frames(h: int, w: int, seed: int = 0):
    """bench.py's content: cur is ref shifted by (2, 3) pixels."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8)
    return base[2:2 + h, 3:3 + w].copy(), base[:h, :w].copy()


def max_abs_err(got, want) -> int:
    """Largest |difference| over matching tensors (0 when bit-equal)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.cpu().long() - w.cpu().long()).abs().max()))
    return err


def median_ms(fn, calls: int = 1) -> float:
    """Median over REPS samples of the CUDA-event time of ``calls`` calls
    of fn, per call.  Each sample starts on an idle card."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from hevcasm_tpu_torch.config import Tier
    from hevcasm_tpu_torch.encode import ctu as ctu_mod, motion
    from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.kernels.inter_fused import (
        inter_ctu_fused_dma, inter_ctu_fused_dma_ref)
    from hevcasm_tpu_torch.kernels.search import (
        ssd_grid_plane, ssd_grid_plane_ref)

    # ---- 1. device -----------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    tag = f"[{card}]"

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")

    # ---- 3. each kernel against its plain version ---------------------------
    cfg = EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_dma")
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    err = {"ssd_grid_plane": 0, "inter_ctu_fused_dma": 0}

    def search_inputs(cur, ref, r):
        """K1 operands as full_search_slab builds them."""
        h, w = cur.shape
        grid = ctu_mod.grid_shape(h, w, 64)
        src = ctu_mod.tile_frame(cur, 64).contiguous()
        pl, pr = r + motion.PAD_L, r + motion.PAD_R
        padded = ctu_mod.pad_frame(ref, pl, pr, pl, pr)
        plane = padded[motion.PAD_L:motion.PAD_L + h + 2 * r,
                       motion.PAD_L:motion.PAD_L + w + 2 * r].contiguous()
        return src, plane, grid, padded

    def check_k1(what, src, plane, grid, r):
        got = ssd_grid_plane(src, plane, grid, 2 * r + 1)
        want = ssd_grid_plane_ref(src, plane, grid, 2 * r + 1)
        e = max_abs_err([got], [want])
        log(f"K1 ssd_grid_plane {what}: n={src.shape[0]} grid={grid} R={r} "
            f"max_abs_err={e}")
        err["ssd_grid_plane"] = max(err["ssd_grid_plane"], e)

    def check_k2(what, src, padded, offsets):
        got = inter_ctu_fused_dma(src, padded, offsets, *qargs)
        want = inter_ctu_fused_dma_ref(src, padded, offsets, *qargs)
        e = max_abs_err(got, want)
        log(f"K2 inter_ctu_fused_dma {what}: n={src.shape[0]} "
            f"offsets [{int(offsets.min())}, {int(offsets.max())}] max_abs_err={e}")
        err["inter_ctu_fused_dma"] = max(err["inter_ctu_fused_dma"], e)

    def mv_offsets(grid, r, seed):
        """Refine-window offsets pos + mv + R for random MVs in [-R, R],
        with the first CTU at offset (0, 0) and the last at the maximum."""
        rng = np.random.default_rng(seed)
        n = grid[0] * grid[1]
        mvs = rng.integers(-r, r + 1, (n, 2)).astype(np.int32)
        mvs[0], mvs[-1] = (-r, -r), (r, r)
        pos = motion.ctu_positions(*grid, 64, dev)
        return (pos + torch.as_tensor(mvs, device=dev) + r).to(torch.int32).contiguous()

    cur_np, ref_np = bench_frames(H, W)
    cur, ref = torch.as_tensor(cur_np, device=dev), torch.as_tensor(ref_np, device=dev)
    src, plane, grid, padded = search_inputs(cur, ref, SEARCH_RANGE)
    check_k1("1080p bench content", src, plane, grid, SEARCH_RANGE)
    mv_int, _ = motion.full_search_slab(src, padded, SEARCH_RANGE, grid,
                                        grid_plane_fn=ssd_grid_plane_ref)
    pos = motion.ctu_positions(*grid, 64, dev)
    k2_offsets = (pos + mv_int + SEARCH_RANGE).to(torch.int32).contiguous()
    check_k2("1080p at the searched MVs", src, padded, k2_offsets)
    check_k2("1080p offsets 0..max", src, padded, mv_offsets(grid, SEARCH_RANGE, 1))

    rng = np.random.default_rng(2)
    small = [torch.as_tensor(rng.integers(0, 256, (128, 192), dtype=np.uint8), device=dev)
             for _ in range(2)]
    s_src, s_plane, s_grid, s_padded = search_inputs(small[0], small[1], 8)
    check_k1("odd grid width", s_src, s_plane, s_grid, 8)
    check_k2("odd grid width, offsets 0..max", s_src, s_padded, mv_offsets(s_grid, 8, 3))

    flat = torch.full((128, 192), 97, dtype=torch.uint8, device=dev)
    c_src, c_plane, c_grid, c_padded = search_inputs(small[0], flat, SEARCH_RANGE)
    check_k1("constant plane (all candidates tie)", c_src, c_plane, c_grid, SEARCH_RANGE)
    mv_c, _ = motion.full_search_slab(c_src, c_padded, SEARCH_RANGE, c_grid)
    if not bool((mv_c == -SEARCH_RANGE).all()):
        raise AssertionError("constant plane: the first minimum is not (-R, -R)")
    check_k2("constant plane (all fractions tie)", c_src, c_padded,
             mv_offsets(c_grid, SEARCH_RANGE, 4))
    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the main path ----------------------------------------------------
    torch.cuda.synchronize()
    ssd_grid_plane.launches = 0
    inter_ctu_fused_dma.launches = 0
    out = encode_inter_frame(cur, ref, cfg)
    torch.cuda.synchronize()
    launches = {"ssd_grid_plane": ssd_grid_plane.launches,
                "inter_ctu_fused_dma": inter_ctu_fused_dma.launches}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")

    n = grid[0] * grid[1]
    shapes = {"recon": ((H, W), torch.uint8), "mvs": ((n, 2), torch.int32),
              "sad": ((n,), torch.int32), "nnz": ((), torch.int32),
              "psnr_db": ((), torch.float32)}
    for key, (shape, dtype) in shapes.items():
        if tuple(out[key].shape) != shape or out[key].dtype != dtype:
            raise AssertionError(f"{key}: {tuple(out[key].shape)} {out[key].dtype}")
    psnr = float(out["psnr_db"])
    if not np.isfinite(psnr):
        raise AssertionError(f"psnr_db {psnr} is not finite")
    plain = encode_inter_frame(cur, ref, cfg, tiers=Tier.REF)
    keys = ("recon", "mvs", "sad", "nnz")
    e = max_abs_err([out[k] for k in keys], [plain[k] for k in keys])
    if e:
        raise AssertionError(f"main path differs from the plain path on the card: {e}")
    shift_share = float((out["mvs"] == torch.tensor([8, 12], device=dev))
                        .all(dim=-1).float().mean())
    log(f"main path: psnr_db={psnr:.4f} nnz={int(out['nnz'])} "
        f"share of CTUs at mv (8, 12) qpel={shift_share:.4f}; "
        "equal to the plain path on the card")

    small_cfg = EncodeConfig(search_range=8, qp=32, inter_impl="fused_dma")
    cur_s, ref_s = bench_frames(128, 192, seed=5)
    on_card = encode_inter_frame(torch.as_tensor(cur_s, device=dev),
                                 torch.as_tensor(ref_s, device=dev), small_cfg)
    on_cpu = encode_inter_frame(cur_s, ref_s, small_cfg)
    e = max_abs_err([on_card[k] for k in keys], [on_cpu[k] for k in keys])
    if e or abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) > 1e-3:
        raise AssertionError("128x192 frame: the card differs from the CPU")
    log("128x192 R=8 frame (odd grid width): card equals the plain path on the CPU")

    # ---- 5. timing -----------------------------------------------------------
    ms_main = median_ms(lambda: encode_inter_frame(cur, ref, cfg))
    ms_chain = median_ms(lambda: encode_inter_frame(cur, ref, cfg), calls=REPS)
    ms_plain = median_ms(lambda: encode_inter_frame(cur, ref, cfg, tiers=Tier.REF))
    log(f"{tag} main path: {ms_main:.3f} ms/frame, {n / ms_main * 1e3:.0f} CTU/s "
        f"per frame; {ms_chain:.3f} ms/frame, {n / ms_chain * 1e3:.0f} CTU/s "
        f"with {REPS} frames back to back (plain path: {ms_plain:.3f} ms/frame, "
        f"{n / ms_plain * 1e3:.0f} CTU/s)")
    num = 2 * SEARCH_RANGE + 1
    times = {
        "ssd_grid_plane": (
            median_ms(lambda: ssd_grid_plane(src, plane, grid, num), calls=10),
            median_ms(lambda: ssd_grid_plane_ref(src, plane, grid, num))),
        "inter_ctu_fused_dma": (
            median_ms(lambda: inter_ctu_fused_dma(src, padded, k2_offsets, *qargs),
                      calls=10),
            median_ms(lambda: inter_ctu_fused_dma_ref(src, padded, k2_offsets, *qargs))),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"{tag} {name} at 1080p: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")

    sources = {
        "ssd_grid_plane": ("hevcasm_tpu_torch/csrc/ssd_grid_plane.cu",
                           "hevcasm_tpu/kernels/search_pallas.py:688"),
        "inter_ctu_fused_dma": ("hevcasm_tpu_torch/csrc/inter_fused.cu",
                                "hevcasm_tpu/kernels/interp_pallas.py:846"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src_path,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src_path, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
