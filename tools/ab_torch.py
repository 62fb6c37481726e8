#!/usr/bin/env python3
"""Time hevcasm_tpu_torch of two checkouts in turns on one CUDA card.

    python3 tools/ab_torch.py [--rounds N] BEFORE_DIR [AFTER_DIR]

AFTER_DIR defaults to this checkout.  Each run imports one checkout's
package in a process of its own (which builds that checkout's kernels into
its own build/), in the order before, after, after, before (N times, 1 by
default), so that drift on the card and its host shows as the spread
between the runs of one checkout.  A run
prints one JSON line: the card's name and power limit, and medians (with
min and max) of 20 samples of

* the luma P frame, encode_inter_frame on chip_smoke's bench content at
  1920x1088, EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma"),
  synchronised per frame;
* the multi-reference P frame, encode_inter_frame_multiref on chip_smoke's
  multiref pan with k = 4 and the same config, and with k = 2,
  fused_refine=True and residual_impl="pallas" (B7 + B11 + B4);
* the luma P frame under me_metric="sad" (B9 + K2), under search_impl
  "dma" and "mv" (B17 + K2), under inter_impl "mega" (B19) and under
  me_strategy "pyramid" (B8 twice + K2), and the RDO P frame with
  pu_decision=True on chip_smoke's structured pan, with the SSD (B15 + B13)
  and the SAD (B9 + B13) metric, at R = 16 (B8 + B13) and with all six
  layouts (pu_amp+8x8: B14 at base 8 + B13);
* K1 (510 CTUs, R = 32), B7 (the same, k = 4), B10 sad (510 64x64 blocks)
  and sad_multiref (k = 4), B9 (510 CTUs and 8160 16x16 blocks, R = 32,
  and the pyramid's two levels), B15 (base 16 with the 26 default PU
  lists, base 32, and base 8 with the default lists), B14 (bases 8, 16 and
  32), B8 (8160 16x16 and 32640 8x8 blocks at R = 16, and the pyramid's
  two levels: 510 decimated 16x16 blocks at num 17, 510 CTUs at num 7), B17
  search_mv and search_mv_dma and B19 (510 CTUs, R = 32, bench content; B19
  also as device time), a
  sample being 10 launches between CUDA events, and torch.cdist(p=1) on
  float32 copies of B10's operands;
* the refine + residual kernels at 510 CTUs of bench content, refine
  windows at random MVs in [-32, 32]: K2 (inter_ctu_fused_dma), B16
  (inter_ctu_fused on the gathered windows), B3 (bi_ctu_fused_dma on the
  reference and chip_smoke's multiref reference 0 stacked by rows), B11
  (refine_quarter_pel_fused on the same windows) and B4 (the bench
  content's CTUs against the reference's, qp 32) at 8x8, 4x4 DST-VII, 4x4,
  16x16 and 32x32 TUs, and
  the PU decision's cost maps on the structured pan: B13
  (refine_qpel_costmap_dma) on its 8160 16x16 and 32640 8x8 tiles, B12
  (refine_qpel_costmap) and B11 on the 16x16 tiles' gathered windows, each
  tile's window at a random MV in [-32, 32]; each also as device time
  (torch.profiler's kernel self time a call, over 10 calls, 5 samples),
  since their wrappers' host work can bound a call;
* B5 (pred_uni) and B6 (pred_bi), the registry's MC kernels, which no
  frame launches: 510 64x64 luma blocks (8-tap) on K2's windows (B6's second
  window from chip_smoke's multiref reference 0 at other random MVs) and
  1020 32x32 chroma blocks (4-tap) on the structured pan's cb and cr planes
  at random MVs in [-4, 4], random per-block fractions, a call and device
  time;
* the 4:2:0 P and B frames, encode_inter_frame_yuv and encode_b_frame_yuv
  on chip_smoke's structured pan with the luma P frame's config.

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
    from hevcasm_tpu_torch.encode.video import (YuvFrame, encode_b_frame_yuv,
                                                encode_inter_frame_yuv)
    from hevcasm_tpu_torch.kernels.bi_fused import bi_ctu_fused_dma
    from hevcasm_tpu_torch.kernels.inter_fused import (inter_ctu_fused, inter_ctu_fused_dma,
                                                       refine_quarter_pel_fused)
    from hevcasm_tpu_torch.kernels.residual_ctu import residual_pipeline_ctu
    from hevcasm_tpu_torch.encode import partition
    from hevcasm_tpu_torch.kernels import build, mc
    from hevcasm_tpu_torch.kernels.base_grids import base_grids_ctu, base_layout_decide
    from hevcasm_tpu_torch.kernels.costmap import refine_qpel_costmap, refine_qpel_costmap_dma
    from hevcasm_tpu_torch.kernels.mega import encode_ctu_mega
    from hevcasm_tpu_torch.kernels.sad import sad, sad_grid, sad_multiref
    from hevcasm_tpu_torch.kernels.search import (search_mv, search_mv_dma, ssd_grid,
                                                  ssd_grid_plane, ssd_grid_plane_multi)

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
    padded = ctu_mod.pad_frame(ref, pl, pr, pl, pr)
    pos = motion.ctu_positions(*grid, 64, dev)
    win128 = motion.extract_aligned_windows(padded, (motion.PAD_L, motion.PAD_L), grid, 64,
                                            64 + 2 * r).contiguous()
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    planes = torch.stack([ctu_mod.pad_frame(p, pl, pr, pl, pr) for p in mr_refs])
    view = planes[:, motion.PAD_L:motion.PAD_L + h + 2 * r, motion.PAD_L:motion.PAD_L + w + 2 * r]
    b_ref = ctu_mod.tile_frame(ref, 64).contiguous()
    b_refs = ctu_mod.tile_frame(mr_refs, 64).transpose(0, 1).contiguous()
    n, num = src.shape[0], 2 * r + 1
    cd_src, cd_ref = src.reshape(n, 1, 4096).float(), b_ref.reshape(n, 1, 4096).float()
    cd_refs = b_refs.reshape(n, 4, 4096).float()

    # The structured pan's luma, its CTU windows and sub-block windows, as
    # chip_smoke's phase 3 cuts them.
    pan_cur, pan_ref = (torch.as_tensor(f[0], device=dev) for f in cs.structured_pan(h, w)[:2])
    pan_src = ctu_mod.tile_frame(pan_cur, 64).contiguous()
    p_padded = ctu_mod.pad_frame(pan_ref, pl, pr, pl, pr)
    p_win = motion.extract_aligned_windows(p_padded, (motion.PAD_L, motion.PAD_L), grid, 64,
                                           64 + 2 * r)

    def sub_blocks(base, rr):
        wsub, o = base + 2 * rr, r - rr
        win = p_win[:, o:o + 64 + 2 * rr, o:o + 64 + 2 * rr]
        win = win.unfold(1, wsub, base).unfold(2, wsub, base).reshape(-1, wsub, wsub)
        return ctu_mod.split_blocks(pan_src, base).contiguous(), win.contiguous()

    b9_16, b8_16, b8_8 = sub_blocks(16, r), sub_blocks(16, 16), sub_blocks(8, 16)
    coarse_src = motion._downsample4(pan_src).contiguous()
    coarse_win = motion.extract_aligned_windows(
        ctu_mod.pad_frame(motion._downsample4(pan_ref), 8, 8, 8, 8), (0, 0), grid, 16, 32)
    fine_win = motion.extract_windows(p_padded, motion.ctu_positions(*grid, 64, dev) + r
                                      + motion.PAD_L - 3, 70)
    layouts = EncodeConfig().pu_layouts
    lists8 = partition._pu_lists(layouts, 8)
    lists16 = partition._pu_lists(layouts, 16)
    lists32 = partition._pu_lists(layouts[:4], 32)
    sad_cfg = EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma", me_metric="sad")
    refine_cfg = EncodeConfig(search_range=r, qp=32, fused_refine=True, residual_impl="pallas")
    pu_cfg = EncodeConfig(search_range=r, qp=32, pu_decision=True)
    pu_sad_cfg = EncodeConfig(search_range=r, qp=32, pu_decision=True, me_metric="sad")
    pu_r16_cfg = EncodeConfig(search_range=16, qp=32, pu_decision=True)
    pu_amp_cfg = EncodeConfig(search_range=r, qp=32, pu_decision=True,
                              pu_layouts=tuple(partition.PU_LAYOUTS))
    search_cfgs = {"dma": EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma",
                                       search_impl="dma"),
                   "mv": EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma",
                                      search_impl="mv"),
                   "mega": EncodeConfig(search_range=r, qp=32, inter_impl="mega"),
                   "pyramid": EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma",
                                           me_strategy="pyramid")}

    # K2, B16, B3, B11 and B4: windows at random MVs, B3's second reference
    # stacked below the first.
    mvs = np.random.default_rng(11).integers(-r, r + 1, (n, 2))
    k2_off = (pos + torch.as_tensor(mvs, device=dev) + r).to(torch.int32).contiguous()
    k2_win = motion.extract_windows(padded, k2_off, 71)
    b3_flat = torch.cat([padded, ctu_mod.pad_frame(mr_refs[0], pl, pr, pl, pr)]).contiguous()
    b3_off1 = (k2_off.flip(0) + torch.tensor([padded.shape[0], 0], device=dev)).to(
        torch.int32).contiguous()
    yuv = [YuvFrame(*(torch.as_tensor(p, device=dev) for p in f))
           for f in cs.structured_pan(h, w)]

    # B13, B12 and B11 at the PU decision's tiles: tile i's window at its
    # position plus a random MV plus R in the pan's padded plane.
    def pu_tiles(b):
        k = 64 // b
        tiles = ctu_mod.split_blocks(pan_src, b).contiguous()
        offs = torch.tensor([(ty * b, tx * b) for ty in range(k) for tx in range(k)],
                            dtype=torch.int32, device=dev)
        mv = torch.as_tensor(np.random.default_rng(b).integers(-r, r + 1, (n, k * k, 2)),
                             device=dev)
        starts = (pos[:, None] + offs[None] + mv + r).reshape(-1, 2).to(torch.int32).contiguous()
        return tiles, starts, motion.extract_windows(p_padded, starts, b + 7)

    # B5 and B6: luma windows as K2's, chroma windows of every 32x32 block
    # of the pan's cb and cr planes.
    mc_rng = np.random.default_rng(14)
    mv2 = torch.as_tensor(mc_rng.integers(-r, r + 1, (n, 2)), device=dev)
    mr_padded = ctu_mod.pad_frame(mr_refs[0], pl, pr, pl, pr)
    mc_luma = [k2_win, motion.extract_windows(mr_padded, (pos + mv2 + r).to(torch.int32), 71)]
    mc_chroma = []
    for c_plane in (yuv[1].cb, yuv[1].cr):
        gr_c, gc_c = c_plane.shape[0] // 32, c_plane.shape[1] // 32
        mv_c = torch.as_tensor(mc_rng.integers(-4, 5, (gr_c * gc_c, 2)), device=dev)
        mc_chroma.append(motion.extract_windows(ctu_mod.pad_frame(c_plane, 8, 8, 8, 8),
                                                motion.ctu_positions(gr_c, gc_c, 32, dev)
                                                + mv_c + 7, 35))
    mc_chroma = [torch.cat(mc_chroma).contiguous(), torch.cat(mc_chroma).flip(0).contiguous()]

    def mc_fracs(m, phases):
        return [torch.as_tensor(mc_rng.integers(0, phases, (m,)), dtype=torch.int32, device=dev)
                for _ in range(4)]

    fl, fc = mc_fracs(n, 4), mc_fracs(mc_chroma[0].shape[0], 8)
    mc_kernels = {
        "b5_luma": lambda: mc.pred_uni(mc_luma[0], fl[0], fl[1]),
        "b6_luma": lambda: mc.pred_bi(*mc_luma, *fl),
        "b5_chroma": lambda: mc.pred_uni(mc_chroma[0], fc[0], fc[1], 4),
        "b6_chroma": lambda: mc.pred_bi(*mc_chroma, *fc, 4),
    }

    t16, s16, w16 = pu_tiles(16)
    t8, s8, _ = pu_tiles(8)

    def b4_qargs(tu, tr_type):
        c = EncodeConfig(search_range=r, qp=32, tu=tu)
        return (*c.quant_params(bool(tr_type)), *c.dequant_params())

    def stats(samples):
        return {"median": statistics.median(samples), "min": samples[0], "max": samples[-1]}

    def kernel_ms(fn):
        return stats(cs.samples_ms(fn, calls=10))

    def device_ms(fn):
        return stats(sorted(cs.device_ms(fn) for _ in range(5)))

    refine_kernels = {
        "k2": lambda: inter_ctu_fused_dma(src, padded, k2_off, *qargs),
        "b16": lambda: inter_ctu_fused(src, k2_win, *qargs),
        "b3": lambda: bi_ctu_fused_dma(src, b3_flat, k2_off, b3_off1, *qargs),
        "b11": lambda: refine_quarter_pel_fused(src, k2_win),
        "b4_8x8": lambda: residual_pipeline_ctu(src, b_ref, *qargs),
        **{f"b4_{tu}x{tu}{'_dst' if tr else ''}": lambda tu=tu, tr=tr, q=b4_qargs(tu, tr):
           residual_pipeline_ctu(src, b_ref, *q, tu=tu, tr_type=tr)
           for tu, tr in ((4, 1), (4, 0), (16, 0), (32, 0))},
        "b13_8160_16x16": lambda: refine_qpel_costmap_dma(t16, p_padded, s16),
        "b13_32640_8x8": lambda: refine_qpel_costmap_dma(t8, p_padded, s8),
        "b12_8160_16x16": lambda: refine_qpel_costmap(t16, w16),
        "b11_8160_16x16": lambda: refine_quarter_pel_fused(t16, w16),
    }

    return {
        "card": cs.card_line(),
        "luma_p_frame_ms": stats(cs.samples_ms(lambda: encode_inter_frame(cur, ref, cfg))),
        "multiref_k4_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame_multiref(mr_cur, mr_refs, cfg))),
        "multiref_k2_refine_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame_multiref(mr_cur, mr_refs[:2], refine_cfg))),
        "k1_ms": stats(cs.samples_ms(lambda: ssd_grid_plane(src, plane, grid, num), calls=10)),
        "b7_k4_ms": stats(cs.samples_ms(lambda: ssd_grid_plane_multi(src, view, grid, num),
                                        calls=10)),
        "b10_sad_ms": stats(cs.samples_ms(lambda: sad(src, b_ref), calls=10)),
        "b10_sad_multiref_ms": stats(cs.samples_ms(lambda: sad_multiref(src, b_refs),
                                                   calls=10)),
        "cdist_sad_ms": stats(cs.samples_ms(lambda: torch.cdist(cd_src, cd_ref, p=1), calls=10)),
        "cdist_sad_multiref_ms": stats(cs.samples_ms(
            lambda: torch.cdist(cd_src, cd_refs, p=1), calls=10)),
        "luma_p_sad_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame(cur, ref, sad_cfg))),
        "pu_decision_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame(pan_cur, pan_ref, pu_cfg))),
        "pu_decision_sad_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame(pan_cur, pan_ref, pu_sad_cfg))),
        "pu_decision_r16_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame(pan_cur, pan_ref, pu_r16_cfg))),
        "pu_amp_8x8_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame(pan_cur, pan_ref, pu_amp_cfg))),
        "b9_510_ctus_r32_ms": kernel_ms(lambda: sad_grid(pan_src, p_win, num, num)),
        "b9_8160_16x16_r32_ms": kernel_ms(lambda: sad_grid(*b9_16, num, num)),
        "b9_pyramid_coarse_ms": kernel_ms(lambda: sad_grid(coarse_src, coarse_win, 17, 17)),
        "b9_pyramid_fine_ms": kernel_ms(lambda: sad_grid(pan_src, fine_win, 7, 7)),
        "b15_base16_ms": kernel_ms(lambda: base_layout_decide(pan_src, p_win, 16, lists16)),
        "b15_base32_ms": kernel_ms(lambda: base_layout_decide(pan_src, p_win, 32, lists32)),
        "b15_base8_ms": kernel_ms(lambda: base_layout_decide(pan_src, p_win, 8, lists8)),
        "b14_base8_ms": kernel_ms(lambda: base_grids_ctu(pan_src, p_win, 8)),
        "b14_base16_ms": kernel_ms(lambda: base_grids_ctu(pan_src, p_win, 16)),
        "b14_base32_ms": kernel_ms(lambda: base_grids_ctu(pan_src, p_win, 32)),
        "b8_8160_16x16_r16_ms": kernel_ms(lambda: ssd_grid(*b8_16, 33, 33)),
        "b8_32640_8x8_r16_ms": kernel_ms(lambda: ssd_grid(*b8_8, 33, 33)),
        "b8_pyramid_coarse_ms": kernel_ms(lambda: ssd_grid(coarse_src, coarse_win, 17, 17)),
        "b8_pyramid_fine_ms": kernel_ms(lambda: ssd_grid(pan_src, fine_win, 7, 7)),
        "b17_search_mv_ms": kernel_ms(lambda: search_mv(src, win128, num)),
        "b17_search_mv_dma_ms": kernel_ms(lambda: search_mv_dma(src, padded, pos, r)),
        "b19_mega_ms": kernel_ms(lambda: encode_ctu_mega(src, padded, pos, r, *qargs)),
        "b19_mega_device_ms": device_ms(lambda: encode_ctu_mega(src, padded, pos, r, *qargs)),
        **{f"{name}_ms": kernel_ms(fn) for name, fn in refine_kernels.items()},
        **{f"{name}_device_ms": device_ms(fn) for name, fn in refine_kernels.items()},
        **{f"{name}_ms": kernel_ms(fn) for name, fn in mc_kernels.items()},
        **{f"{name}_device_ms": device_ms(fn) for name, fn in mc_kernels.items()},
        "yuv_p_frame_ms": stats(cs.samples_ms(
            lambda: encode_inter_frame_yuv(yuv[0], yuv[1], cfg))),
        "yuv_b_frame_ms": stats(cs.samples_ms(
            lambda: encode_b_frame_yuv(yuv[0], yuv[1], yuv[2], cfg))),
        **{f"luma_p_{name}_frame_ms": stats(cs.samples_ms(
            lambda c=c: encode_inter_frame(cur, ref, c))) for name, c in search_cfgs.items()},
    }


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--measure":
        sys.path[:0] = [args[1]]
        print(json.dumps(measure()), flush=True)
        return 0
    rounds = 1
    if args[:1] == ["--rounds"] and len(args) > 1 and args[1].isdigit():
        rounds, args = int(args[1]), args[2:]
    if len(args) not in (1, 2) or rounds < 1:
        print(__doc__, file=sys.stderr)
        return 2
    before = Path(args[0]).resolve()
    after = Path(args[1]).resolve() if len(args) == 2 else HERE
    for label, root in (("before", before), ("after", after), ("after", after),
                        ("before", before)) * rounds:
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
