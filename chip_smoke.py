#!/usr/bin/env python3
"""Smoke run of hevcasm_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   a CUDA card must be present; prints nvidia-smi's name and power
            limit of card 0.
2. build    compiles hevcasm_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
            process per source, into build/ and prints the build time; the
            SASS of the library (cuobjdump -sass, from nvcc's toolkit) must
            show IMMA, the u8/s8 tensor-core product, in K1/B7's kernel, in
            B8's, B14's, B15's, B17's, B19's, K2's (which B16 launches) and
            B3's, and in every instance of B11's, B12's and B13's kernels
            (each tile side), at least 16 in every instance of B4's (each
            TU size: a warp's four transform passes), at least 6 in every
            instance of B5's and B6's (taps 8 and 4, uni and bi: both FIR
            passes), and VABSDIFF4, the packed absolute difference, in B9's;
            the CUDA-core search loop that B17 and B19 ran before they took
            K1's core (csrc/search_core.cuh) must be gone, neither B11 nor
            B5/B6 (csrc/mc.cu) may include the CUDA-core refinement
            (csrc/refine_core.cuh), and csrc/residual_core.cuh must no
            longer hold the CUDA-core residual stage (tmat).  Prints B5's
            and B6's registers and local memory (cuobjdump -res-usage).
            K2's and B3's kernels must each have two instances, the
            host-int one and the device-q one (the quantizer parameters
            read from an int32[5] on the card), both with IMMA; prints
            their registers and local memory.
3. kernels  each kernel against its plain PyTorch version on the card, bit
            for bit on every output: the 1080p shapes (510 CTUs, R = 32), an
            odd grid width (3) at R = 8 (K1 also at R = 1, 2 and 31, and B7
            at R = 31), K1 and B7 on all-0 / all-255 and all-255 / all-255
            CTUs and planes (4096 * 255^2 and 0 everywhere), refine offsets
            at 0 and at the
            maximum (in both stacked planes for B3), constant planes on
            which every candidate ties, and (K2, B3 and B16) 0/255 CTUs on
            planes that drive the refinement's int16 intermediate to 22440
            and -6120 and its vertical sums to both extremes.  The partition kernels run on the
            structured pan's luma: B15 at base 16 (the 26 PU lists of the
            default layouts) and base 32, B14 at base 8 and 16, B13 on the
            8160 16x16 and 32640 8x8 tiles at their searched MVs and at
            offsets 0..max, B12 at b = 64/32/16/8 on gathered windows (B11,
            B12 and B13 also on constant inputs, where every fraction ties:
            B11 must take fraction 0 and B12/B13 give 16 equal costs), B8
            on the sub-block windows of the 8160 16x16 blocks at R = 16 and
            32, the 32640 8x8 blocks at R = 16, and the 510 CTUs at R = 32.
            The multi-reference kernels run on the multiref pan (below): B7
            at k = 4, R = 32 on the loop's padded planes (a view), and at
            k = 3, R = 8 on an odd grid width; B11 on the 510 64x64 windows
            at the searched MVs and on the 8160 16x16 tiles; B16 on 510
            windows at random MVs, unbatched and in groups of 4 (which do
            not divide 510); B4 on 510 CTUs at 4x4 TUs with the DST-VII and
            the DCT, and at 8, 16 and 32, and at each of them on the
            residual's full-swing CTUs (255 over 0 and the reverse,
            checkerboards, random 0/255, beside random ones) at qp 32 and at
            the quantizer parameters' range edges (RESIDUAL_EDGE_QARGS).
            intra_wave_fused over every wave of the 1080p bench frame and of
            a random 4K one, at qp 32 with strong intra smoothing and qp 22
            without, against intra_wave_ref wave by wave (the canvas, the
            nnz and each block's mode).
            The search configurations'
            kernels: B9 on the pyramid's shapes (510 16x16 decimated blocks
            at num 17, 510 CTUs at num 7), the full search (510 CTUs, R =
            32) and the PU decision's 8160 16x16 blocks at R = 32; B17
            (both entries) and B19 at 1080p R = 32 on bench content, on
            the multiref pan's reference 0 and on two independent noise
            planes (on these two most minima must be non-zero and differ
            between CTUs, and on the noise most MVs too), and on a constant
            plane, where every candidate ties and the answer is (-32, -32);
            B19 also at R = 8 on an odd grid width.  Each B17 call (both
            entries) must put exactly one operation on the card, its kernel
            (torch.profiler: no memset, no decode kernel, no torch op).  B9 at every block side
            b in {8, 16, 32, 64} and num in {1, 7, 17, 33, 65} on the pan's
            blocks, with windows cut from wider rows at an odd offset; B15
            at bases 8, 16 and 32 and R = 1, 2, 31 and 32 with the default
            PU lists and three that are no rectangle.  The self-test's
            kernels: B10 (sad, sad_multiref) at the 23 partitions as the
            suites pass them (2-D strided views of 128x128 arrays, k = 4),
            on 510 64x64 blocks against one reference and against k = 4
            (also as strided views); B5 and B6 at every self-test shape with
            every fraction (windows as views into wider rows) and 2-D with
            int fractions, on 510 64x64 luma blocks (8-tap, per-block
            fractions 0-3) and 1020 32x32 chroma blocks (4-tap, 0-7); B18
            on the structured pan's 510 CTUs at R = 32 with the 26 default
            PU lists, where it must also equal B15 at base 16.  K2, B16 and
            B3 through their device-q C entries (the parameters as 0-d int32
            tensors, read by the kernel) at 1080p and qp 10, 32 and 49, equal
            to their host-int entries and plain versions; a qshift of 28 or
            a dshift of 0 must set its bit in the range flag and leave the
            fractions as they were.
4. main     the paths below, each with every launch count set to 0 just
            before it and read just after.  With
            EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma"):
            encode_inter_frame on a 1920x1088 luma P frame of bench content
            (seed 0, a pure (2, 3) shift) must launch K1 and K2;
            encode_inter_frame_yuv on a 1920x1088 4:2:0 P frame of bench's
            structured pan must launch K1 and K2; encode_b_frame_yuv on the
            B frame of that content must launch K1 twice and B3.  The RDO P
            frame, encode_inter_frame(EncodeConfig(search_range=32, qp=32,
            pu_decision=True)) on the structured pan's luma, must launch B15
            and B13; with all six layouts B14 and B13; with tu_sizes=(4, 8,
            16, 32) K1; with both B15 and B13; and at search_range=16 B8 and
            B13.  The unpruned PU decision, partition.select_pu_layout, must
            launch B8 and B12 and equal the pruned one.  The multi-reference
            P frame, encode_inter_frame_multiref, on the multiref pan (the
            structured pan's picture at four earlier positions of a (2, 3)
            pixel-a-frame pan, each reference clean in its own quarter of
            the frame and noisy elsewhere): with k = 4 and inter_impl
            "fused_dma" it must launch B7 and K2; with k = 2,
            fused_refine=True and residual_impl="pallas" B7, B11 and B4;
            its ref_idx must use more than one reference.  The luma P frame
            under inter_impl "fused" and "fused_batched" must launch K1 and
            B16.  The search configurations, which must launch exactly the
            kernels named and no other: the luma P frame (bench content,
            fused_dma) under search_impl "dma" (B17 dma + K2) and "mv" (B17
            + K2), under inter_impl "mega" (B19 alone), under me_metric
            "sad" (B9 + K2), under me_strategy "pyramid" with SSD (B8 twice
            + K2) and with SAD (B9 twice + K2); pu_decision with SAD on the
            structured pan's luma (B9 + B13); the yuv B frame with SAD (B9 +
            B3).  Each frame must equal its plain path on the card
            (pu_layout, tu_choice and ref_idx included), and 128x192 frames
            of each must equal the plain path on the CPU.  The self-test
            (python -m hevcasm_tpu_torch's path), selftest.main(time_it=
            False) on the card, must return 0 errors and launch exactly B10
            23 + 23 times, B9 and B8 3 times each, B5 32, B6 4, B11 2 and
            B4 2 (once a case of their suites) and nothing else.  The PU
            decision, partition.select_pu_layout_pruned, with B18 as its
            decide_fn (base 16 at the default layouts, R = 32) must launch
            exactly B18 and B13 and equal the decision through B15.  The
            rate-controlled GOP (encode.rate) on 9 frames of the rate tests'
            clip at 1920x1088 (smoothed noise panned (2, 3) a frame, +-12
            noise a frame, seed 0), R = 32, qp0 = 40, the target the
            geometric mean of frame 1's bits at qp 38 and 22: its loop
            (rate._gop_rc_body) must run under
            torch.cuda.set_sync_debug_mode("error") and launch exactly K1 x8
            and K2 x8 through its device-q entry (IPPP, fused_dma), K1 x8
            and B16 x8 (IPPP, fused), K1 x8 and B11 x8 (IPPP, stages,
            fused_refine), K1 x12, K2 x4 and B3 x4 (IBPBP, fused_dma); each
            must equal encode_gop_rate_controlled and the plain path on the
            card in recon, bits and qp (PSNR within 1e-3 dB), move qp from
            40, land frames 4-8 within 2.5x the target (a B/P pair within
            2.5x twice it) and code its first P frame as
            encode_inter_frame at qp 40 does; qp0 = 60 in [55, 70] must
            raise ValueError ("outside") under fused_dma and stages.
            The intra frames at 1920x1088, qp 32, intra_block 32:
            encode_intra_frame on bench content must launch no registry
            kernel and use more than 4 distinct modes (its peak device
            memory is printed); encode_intra_frame_wavefront (126 waves)
            must run under torch.cuda.set_sync_debug_mode("error") (no host
            read) and launch exactly intra_wave_fused x126 (a launch a
            wave) and nothing else; encode_intra_frame_yuv on
            the structured pan likewise; each equal to its plain path on the
            card and, at 128x192, to the CPU.  The GOPs on 5 frames of the
            rate clip at 1920x1088 with chroma planes from the seed,
            fused_dma, R = 32: encode_gop (open loop, and with the
            wavefront I frame), encode_gop_yuv IPPP, encode_gop_closed_loop
            and encode_gop_closed_loop_yuv must launch exactly K1 x4 and K2
            x4, encode_gop_yuv(b_frames=True) and
            encode_gop_closed_loop_yuv_b exactly K1 x6, K2 x2 and B3 x2,
            each with a wavefront I frame also intra_wave_fused x126;
            each equal to its plain path on the card, the closed-loop ones
            also to the per-frame entry points chained on reconstructions,
            and a 128x192 clip (3 frames, 5 with B frames) at R = 8 to the
            CPU; their host reads are counted (set_sync_debug_mode("warn")).
            python -m hevcasm_tpu_torch encode --frames 3 --width 640
            --height 384 must print its JSON line, with the nnz of the same
            command on the CPU and its PSNR within 1e-3 dB, and a Y4M round
            trip through --input / --output in a temporary directory must
            give back encode_gop_yuv's reconstruction.
5. multi    the sharded entry points (hevcasm_tpu_torch.parallel).  nccl
            with 2 ranks on one card must be refused (ValueError) by
            parallel.launch.spawn and multihost.initialize.  A world of 1
            under nccl in this process (multihost.initialize(), mesh 1x1;
            a group of one rank moves nothing, so this checks the
            bring-up, the mesh and the band logic on the card):
            encode_inter_frame_spatial on a 3840x2176 frame of bench content
            (2040 CTUs) must launch exactly K1 and K2 and equal
            encode_inter_frame; encode_gop_data_parallel on the rate clip's
            9 frames at 1920x1088 exactly K1 x8 and K2 x8, equal to
            encode_p_frames_batch and to the per-frame calls; each timed in
            turns with its single-card twin.  A world of 2 ranks sharing
            card 0 under gloo (NCCL takes one card a rank), each rank given
            its inputs with everything outside its share replaced by noise:
            config 4 (that GOP over mesh (2, 1)) must launch exactly K1 x4
            and K2 x4 a rank, config 5 (a 3-frame closed-loop spatial GOP
            of the rate clip at 3840x2176 over mesh (1, 2); depth cut from
            BASELINE's 32 frames) K1 x2, K2 x2 and intra_wave_fused x254
            (the wavefront I frame, coded whole by each rank), the 4K
            spatial frame over mesh (1, 2) K1 and K2; each equal to the
            single-card entry point (recon, sad, nnz, mvs where given; PSNR
            within 1e-3 dB); a 1080p frame over 2 bands (17 CTU rows) must
            raise ValueError.  Prints each path's ms a frame (CUDA events),
            the halo bytes a P frame, the bytes gathered and the host time of
            the gloo copies, with the card's name and power limit.
6. timing   CUDA-event medians over 20 samples after warm-up: each path per
            frame, synchronised after each (ms per frame and CTU/s), the luma
            path also 20 frames back to back, and each path's plain version;
            the four RDO variants of tools/bench_rdo.py (pu_decision,
            pu_amp+8x8, tu_select, pu+tu), pu_decision at R = 16 and the
            plain pu_decision path on the structured pan's luma, each with
            the minimum and maximum of its samples; each kernel beside its
            plain version at the 1080p shapes, a kernel sample being 10
            launches back to back so that its host overhead is hidden.
            The multi-reference and fused paths, with min and max too (the
            plain multi-reference path, ~0.3 s a frame, over 3 samples),
            and B7 (its plain version over 3 samples), B11, B16 and B4 (at
            each TU size).  The search configurations' frames with min and
            max, the mega frame and the fused_dma frame in turns, and B9,
            B17 (both entries) and B19.  Each kernel's bound is computed
            from the shapes it was timed at: the larger of the bytes it must
            move (each input read once, each output written once) at 3.35
            TB/s and its multiply-adds (2 operations each, in the form the
            int8 tensor cores could run) at 1,979 TOP/s, the H100 SXM's
            published rates.  B9's |a - b| is no product, so its operations
            are the fewest CUDA-core instructions its terms need (packed,
            four terms an instruction) at the cores' issue rate
            (INT_INSTR_PER_S and SAD_TERMS_PER_INSTR below).  The timed
            self-test once (its lines printed); B10, B5, B6 and B18 beside
            their plain versions at the frame shapes of phase 3, B10 also
            beside torch.cdist(p=1) on float32 copies (library_ms; the two
            sampled in turns, since host work bounds both), and
            their device time from torch.profiler (device_ms), which says
            whether the kernel or the wrapper's host work bounds a call; K1
            and B7 with their device_ms and the tensor-core design's own
            floor, torch.cdist(p=1) with its device_ms beside B10's (call
            with call, device with device), and the host time of each step
            of B10's launch path beside the whole call and cdist's.  The
            card's own rates of mma.sync m16n8k32 u8 and of vabsdiff4 with
            .add (tools/b9_b15_phase_costs.py), and from them the design
            floors of K1/B7, B17 and B19 (the products of K1's core), B9 (its
            terms, four an instruction), B15, B8, B14, and K2, B16, B3, B11,
            B12 and B13 (the m16n8k32 and m16n8k16 products each issues,
            K2's, B16's and B3's with their residual stage's) beside their
            bounds and device times; B4's at each TU size: its products at
            mma.sync's own rates plus its other SASS instructions (a warp
            runs each once for its tile) at the CUDA cores' issue rate,
            beside its bound and device time (torch.profiler), the same
            for B5 and B6 (luma and chroma, uni and bi: their m16n8k32
            products plus their other SASS instructions once a warp task),
            and B19's device time.  The rate-controlled IPPP GOP (fused_dma)
            in turns with a closed loop of fixed-qp encode_inter_frame
            calls over the same frames, ms a frame with min and max of 20
            samples; K2's and B3's device time through each C entry at the
            1080p shapes, and a call of each, in turns.  The intra frames
            (open loop, wavefront, yuv) and each GOP in ms a frame (min,
            median and max), the n = 32 mode decision's device time (its
            float64 products, the whole decision, the residual beside it),
            and torch.profiler's device busy share and kernel launches over
            a wavefront frame, a yuv I frame and a closed-loop yuv GOP.
            intra_wave_fused's device time a wave and a frame (the 1080p
            and a 4K frame's waves, torch.profiler), the frames' waves
            enqueued behind a spin kernel (so the chain runs unpaced by the
            host) and the host's enqueue a wave, beside its bound: the
            chain of dependent launches, as many as waves, at the gap that
            as many dependent one-element torch kernels take behind a spin.
            Device times count the card's own events only (on_device_ms).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

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


def structured_pan(h: int, w: int, seed: int = 0):
    """bench.py's 4:2:0 rows: the bench noise smoothed twice by a 3-tap box
    in each direction; the luma P frame's top half pans (+3, +2) and its
    bottom half (-5, -7) against the reference, the B frame's second
    reference is offset (-2, -4), and chroma is a (1, 2) shift.  Returns
    (cur, ref0, ref1) as 3-tuples of (y, cb, cr) numpy planes."""
    pan = pan_picture(h, w, seed)
    ref0 = pan[32:32 + h, 32:32 + w].copy()
    cur = np.empty((h, w), np.uint8)
    cur[:h // 2] = pan[35:35 + h // 2, 34:34 + w]
    cur[h // 2:] = pan[27 + h // 2:27 + h, 25:25 + w]
    ref1 = pan[30:30 + h, 28:28 + w].copy()
    cb0 = pan[:h // 2, :w // 2].copy()
    cb1 = pan[1:1 + h // 2, 2:2 + w // 2].copy()
    return (cur, cb1, cb1), (ref0, cb0, cb0), (ref1, cb0, cb0)


def max_abs_err(got, want) -> int:
    """Largest |difference| over matching tensors (0 when bit-equal),
    computed on the device of ``got``."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.to(g.device).long()).abs().max()))
    return err


def sample_ms(fn, calls: int) -> float:
    """The CUDA-event time of ``calls`` calls of fn, per call, from an idle
    card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def samples_ms(fn, calls: int = 1, reps: int = REPS) -> list[float]:
    """``reps`` samples of the CUDA-event time of ``calls`` calls of fn,
    per call, sorted.  Each sample starts on an idle card."""
    for _ in range(min(WARMUP, reps)):
        fn()
    torch.cuda.synchronize()
    return sorted(sample_ms(fn, calls) for _ in range(reps))


def turns_samples_ms(fns: dict, calls: int = 10, reps: int = REPS) -> dict:
    """``reps`` per-call CUDA-event samples of each fn, sorted, taken in
    turns (a sample of each, then the next round), so that a drift in the
    host's speed, which bounds calls this short, falls on every fn alike."""
    for fn in fns.values():
        for _ in range(WARMUP):
            fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            samples[name].append(sample_ms(fn, calls))
    return {name: sorted(v) for name, v in samples.items()}


def turns_ms(fns: dict, calls: int = 10, reps: int = REPS) -> dict:
    """The median of each fn's turns_samples_ms."""
    return {name: statistics.median(v)
            for name, v in turns_samples_ms(fns, calls, reps).items()}


def median_ms(fn, calls: int = 1, reps: int = REPS) -> float:
    return statistics.median(samples_ms(fn, calls, reps))


def on_device_ms(prof, kernel: str = "") -> float:
    """The device time (ms) of the operations on the card (kernels, copies,
    memsets) that a torch.profiler run recorded, those whose name holds
    ``kernel``.  Only the device's own events count: key_averages() also
    gives each torch op (aten::...) the time of the kernels it launched, so
    a sum over every entry would count a torch op's kernels twice (torch's
    own table sums the device events alone)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and kernel in e.key) / 1e3


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call of fn: the time of every operation
    torch.profiler records on the card over ``calls`` calls, per call (0.0
    when the profiler records none).  Set beside a CUDA-event time it says
    whether the device or the host's enqueue bounds the calls."""
    return kernel_device_ms(fn, "", calls)


def kernel_device_ms(fn, kernel: str, calls: int = 10) -> float:
    """Device time of one call of fn spent in the CUDA kernels whose name
    holds ``kernel`` (torch.profiler, over ``calls`` calls; 0.0 when it
    records none): a kernel's time without the small torch ops its wrapper
    also enqueues."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return on_device_ms(prof, kernel) / calls


def rate_clip(t: int, h: int, w: int, noise: int, seed: int = 0) -> np.ndarray:
    """The rate-control tests' clip (tests/test_rate.py): smoothed noise
    panned (2, 3) pixels a frame, with independent noise of +-``noise`` a
    frame so that residuals never quantize to zero.  (t, h, w) uint8."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    out = np.stack([base[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(t)])
    n = rng.integers(-noise, noise + 1, out.shape)
    return np.clip(out.astype(np.int16) + n, 0, 255).astype(np.uint8)


def device_ops(fn) -> list[str]:
    """The names of the operations torch.profiler records on the card (kernels,
    memsets, copies) during one call of fn, after a call that warms it up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def host_reads(fn):
    """fn()'s result and the number of times it synchronised the host with
    the card (each synchronising call warns under
    torch.cuda.set_sync_debug_mode("warn")): its host reads."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def without_host_read(fn):
    """fn()'s result; fails if fn synchronises the host with the card
    (torch.cuda.set_sync_debug_mode("error"))."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def intra_wave_frame(fn, cur, cfg) -> list:
    """``fn`` (intra_wave_fused or intra_wave_ref) over every wave of plane
    ``cur``'s wavefront I frame: [the tiled canvas, the frame's nnz, each
    block's mode in wave order]."""
    from hevcasm_tpu_torch.encode import ctu as ctu_mod
    from hevcasm_tpu_torch.encode import intra_wavefront

    h, w = cur.shape
    spans, order, refs, lav, aav, cav = intra_wavefront._schedule(h, w, 32, cur.device)
    src = ctu_mod.tile_frame(cur, 32).index_select(0, order)
    canvas = torch.full((h * w,), intra_wavefront.UNAVAILABLE, dtype=torch.uint8,
                        device=cur.device)
    nnz = torch.zeros((), dtype=torch.int32, device=cur.device)
    modes = torch.full((order.shape[0],), -1, dtype=torch.int32, device=cur.device)
    for s, e in spans:
        if s < e:
            fn(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes)
    return [canvas, nnz, modes]


def unpaced_ms(fn, reps: int = REPS, spin_cycles: int = 100_000_000) -> float:
    """Median device time of fn's work enqueued behind a spin kernel
    (torch.cuda._sleep, ~50 ms): the host has enqueued all of it before the
    card reaches it, so a chain of dependent launches runs back to back,
    unpaced by the host's enqueue (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def busy_share(fn) -> tuple[float, float, int]:
    """(device busy ms, wall ms, kernel launches) of one call of fn after a
    warm-up call: torch.profiler's self device time of every CUDA kernel,
    against the host clock from an idle card to the end of fn's work."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "emcpy" not in e.name and "emset" not in e.name]
    return on_device_ms(prof), wall, len(kernels)


HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 tensor cores, dense


# The CUDA cores' instruction rate, for work the tensor cores cannot run:
# each SM issues at most one 32-thread instruction a clock from each of its
# 4 schedulers (NVIDIA's Hopper architecture white paper), 128 thread
# instructions a clock, on 132 SMs at the 1.98 GHz boost clock that the
# data sheet's 67 TFLOP/s float32 implies (132 x 128 lanes x 2 x 1.98 GHz).
INT_INSTR_PER_S = 132 * 128 * 1.98e9
# The most SAD terms one thread instruction can do: PTX's packed
# vabsdiff4 with .add (PTX ISA, "SIMD video instructions") adds the
# absolute differences of four byte pairs to an accumulator, against one
# term for the scalar sad; B9's own design takes three (subtract, absolute
# value, add), so this bound is the card's and not the design's.
SAD_TERMS_PER_INSTR = 4


def bound(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take for a function that must
    move ``nbytes`` and do ``ops`` operations at ``ops_per_s``, and which of
    the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def refine_macs(b: int) -> int:
    """Multiply-adds of one b x b quarter-pel refinement: the 4 horizontal
    8-tap passes over b+7 rows, the 16 vertical candidates, and the
    winner's recomputation."""
    return 4 * (b + 7) * b * 8 + 16 * b * b * 8 + b * b * 8


def refine_ops(b: int) -> int:
    """refine_macs as operations, plus QPEL_SCORE's difference and sum for
    each candidate pixel."""
    return 2 * refine_macs(b) + 2 * 16 * b * b


def mc_macs(h: int, w: int, taps: int) -> int:
    """Multiply-adds of one h x w block's interpolation at one fraction:
    the horizontal pass over h + taps - 1 rows and the vertical pass."""
    return (h + taps - 1) * w * taps + h * w * taps


def residual_ops(tu: int) -> int:
    """Operations of one 64x64 CTU's residual: four separable transform
    passes of 4096 outputs, each tu multiply-adds."""
    return 2 * 4 * 4096 * tu


def residual_tc_products(n: int, tu: int) -> tuple[int, int]:
    """(m16n8k16, m16n8k32) products the tensor-core residual stage issues
    for n CTUs (csrc/residual_core.cuh): a warp's W x W tile takes 2 a pass
    and n8 tile for each of its W / 16 m tiles, four passes; W = 16 with
    k16 up to 16x16 TUs, W = 32 with k32 at 32x32."""
    w = 32 if tu == 32 else 16
    per_ctu = (64 // w) ** 2 * 4 * (w // 16) * (w // 8) * 2
    return (n * per_ctu, 0) if w == 16 else (0, n * per_ctu)


# The residual stage's content: name -> the CTUs [start, stop) it has in
# residual_ctus' stack.
RESIDUAL_CONTENTS = {"random": (0, 2), "src 255 over pred 0": (2, 3),
                     "src 0 over pred 255": (3, 4), "checkerboards": (4, 5),
                     "random 0 and 255": (5, 6)}
# Quantizer parameters (qscale, qshift, qoffset, dscale, dshift) at the ends
# of the ranges the C entries take: levels near half the coefficient with a
# dequantizer past its clip; the largest shifts with a dequantizer product
# that wraps int32; a dequantizer product far past 2^32.
RESIDUAL_EDGE_QARGS = {
    "qscale 2^15-1, qshift 16, dshift 1": (32767, 16, 32767, 18432, 1),
    "qshift 27, dshift 31": (32767, 27, 32767, 1 << 28, 31),
    "dequantizer product past 2^32": (32767, 16, 0, (1 << 20) + 3, 16),
}


def b4_name(tu: int, tr_type: int) -> str:
    """The name B4 is timed under at (tu, tr_type): 8x8 DCT is its row."""
    if (tu, tr_type) == (8, 0):
        return "residual_pipeline_ctu"
    return f"residual_pipeline_ctu 510 CTUs, tu={tu} {'DST' if tr_type else 'DCT'}"


def residual_ctus(rng) -> tuple[np.ndarray, np.ndarray]:
    """(src, pred) (6, 64, 64) uint8 of RESIDUAL_CONTENTS: random CTUs, and
    full-swing ones that drive every transform pass to its extremes."""
    src = rng.integers(0, 256, (6, 64, 64), dtype=np.uint8)
    pred = rng.integers(0, 256, (6, 64, 64), dtype=np.uint8)
    src[2], pred[2] = 255, 0
    src[3], pred[3] = 0, 255
    checker = (np.add.outer(np.arange(64), np.arange(64)) & 1).astype(np.uint8) * 255
    src[4], pred[4] = checker, 255 - checker
    src[5] = rng.integers(0, 2, (64, 64), dtype=np.uint8) * 255
    pred[5] = rng.integers(0, 2, (64, 64), dtype=np.uint8) * 255
    return src, pred


@functools.lru_cache(maxsize=None)
def _sass(nvcc: str, lib: str) -> str:
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def sass_counts(build, kernel: str, opcode: str) -> dict[str, int]:
    """{function: instructions of ``opcode``} in the SASS of each function
    of the built library whose name holds ``kernel`` (cuobjdump -sass, from
    the toolkit of the nvcc that built it, run once a library)."""
    counts, name = {}, None
    for line in _sass(build._nvcc(), str(build.build())).splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if kernel in name else None
            if name:
                counts[name] = 0
        elif name and opcode in line:
            counts[name] += 1
    return counts


def sass_count(build, kernel: str, opcode: str) -> int:
    """sass_counts summed over the functions."""
    return sum(sass_counts(build, kernel, opcode).values())


def resource_usage(build, kernel: str) -> dict[str, str]:
    """{instance: "REG:n STACK:n LOCAL:n"} of each function of the built
    library whose name holds ``kernel`` (cuobjdump -res-usage: registers a
    thread, and the stack and local memory that spills would take)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-res-usage", str(build.build())], capture_output=True,
                         text=True, check=True, timeout=300).stdout.splitlines()
    usage = {}
    for line, nxt in zip(out, out[1:] + [""]):
        if "Function " in line and kernel in line:
            name = line.split("Function ")[1].strip().rstrip(":")
            name = name[name.index(kernel):][:len(kernel) + 12]
            usage[name] = " ".join(f for f in nxt.split()
                                   if f.split(":")[0] in ("REG", "STACK", "LOCAL"))
    return usage


def tc_floor_ms(n: int, k: int, r: int) -> float:
    """The least time of K1/B7's own tensor-core work at the published int8
    rate: 2 x 16 x 8 x 32 operations for each m16n8k32 product it issues, m
    tiles x (k step, n tile) pairs with 32 ks - 8 nt in [-24, 64] x 64
    source rows, a CTU and plane (csrc/ssd_grid_plane.cu)."""
    num, wide = 2 * r + 1, 64 + 2 * r
    pairs = sum(1 for ks in range(-(-wide // 32)) for nt in range(-(-num // 8))
                if -24 <= 32 * ks - 8 * nt <= 64)
    return n * k * 64 * -(-num // 16) * pairs * 2 * 16 * 8 * 32 / INT8_OPS_PER_S * 1e3


B15_NG = {8: 2, 16: 9, 32: 9}     # n8 tiles a block of B15 (csrc/base_grids.cu), by base


def b15_products(n: int, base: int, r: int) -> int:
    """The m16n8k32 products B15 issues for n CTUs: for each m tile, source
    row and sub-block column q, the (k step, n tile) pairs of each block's
    n tiles whose band meets the column, 32 ks - 8 nt in [base q - 24,
    base q + base] (csrc/base_grids.cu)."""
    num, wide = 2 * r + 1, 64 + 2 * r
    nt_count, ks_count, ng = -(-num // 8), -(-wide // 32), B15_NG[base]
    per_row = sum(1 for q in range(64 // base) for nt0 in range(0, nt_count, ng)
                  for ks in range(min(4, ks_count)) for nt in range(nt0, min(nt0 + ng, nt_count))
                  if base * q - 24 <= 32 * ks - 8 * nt <= base * q + base)
    return n * -(-num // 16) * 64 * per_row


def narrow_pairs(bw: int, ks_count: int, nt_count: int) -> int:
    """The m16n8k32 products a narrow band bw bytes wide issues a source row
    and m tile (csrc/ssd_tc_core.cuh narrow_products): the (k step, n tile)
    pairs with 32 ks - 8 nt in [-24, bw], ks < ks_count, nt < min(9,
    nt_count)."""
    ks_max = -(-(72 + bw - 1) // 32)
    return sum(1 for ks in range(min(ks_max, ks_count)) for nt in range(min(9, nt_count))
               if -24 <= 32 * ks - 8 * nt <= bw)


def b14_products(n: int, base: int, r: int) -> int:
    """The m16n8k32 products B14 issues for n CTUs (csrc/base_grids.cu): for
    each m tile, sub-block and source row of it, the pairs of its band,
    max(base, 16) bytes wide from a 16-aligned column, at most 3 k steps."""
    num, bw = 2 * r + 1, max(base, 16)
    pairs = narrow_pairs(bw, min(3, -(-(num + bw - 1) // 32)), -(-num // 8))
    return n * -(-num // 16) * (64 // base) ** 2 * base * pairs


def b8_plan(b: int, n: int, num_dy: int, num_dx: int) -> dict:
    """B8's launch geometry (csrc/ssd_grid.cu make_plan): source blocks
    (sb), m16 tiles (mb) and n8 tiles (ntb) a block, the staged window rows,
    the E rows' stride, the shared bytes a source block (window, Z, E) and a
    block, threads."""
    max_mb, target_warps, smem_cap = 8, 8, 96 * 1024
    ks = -(-(72 + b - 1) // 32)
    ws, zp = 32 * ks + 16, b // 4 + 8
    mt, nt = -(-num_dy // 16), -(-num_dx // 8)
    mb = -(-mt // -(-mt // max_mb))
    ntb = -(-nt // -(-nt // 9))
    rows = 16 * mb + b - 1
    es = (min(8 * ntb, num_dx) + b - 1) | 1
    per = rows * ws + b * zp * 8 + -(-max(min(16 * mb, num_dy) * es * 4, b * b) // 16) * 16
    sb = max(1, target_warps // mb)
    if sb * per > smem_cap:
        sb = max(1, smem_cap // per)
    sb = min(sb, n)
    return dict(sb=sb, mb=mb, ntb=ntb, rows=rows, es=es, per=per,
                smem=sb * per + -(-4 * sb // 16) * 16, threads=32 * sb * mb)


def b8_products(n: int, b: int, num_dy: int, num_dx: int) -> int:
    """The m16n8k32 products B8 issues for n blocks: for each block of its
    plan, each busy warp (m tile) and source row, its band's pairs inside
    the block's columns."""
    plan = b8_plan(b, n, num_dy, num_dx)
    mb, ntb = plan["mb"], plan["ntb"]
    total = 0
    for dy0 in range(0, num_dy, 16 * mb):
        busy = -(-min(16 * mb, num_dy - dy0) // 16)
        for dx0 in range(0, num_dx, 8 * ntb):
            cols = min(8 * ntb, num_dx - dx0)
            total += busy * narrow_pairs(b, -(-(cols + b - 1) // 32), -(-cols // 8))
    return n * b * total


def refine_tc_products(n: int, refs: int = 1) -> tuple[int, int]:
    """The mma.sync products of K2's and B3's tensor-core refinement
    (csrc/refine_tc_core.cuh) for n CTUs of refs references: m16n8k32, the
    horizontal pass's 4 m tiles x 9 n tiles x 4 xf; m16n8k16, the vertical
    pass's 32 tiles x 16 candidates x 2 (hi, lo) and the winner's 32 x 2."""
    return n * refs * 4 * 9 * 4, n * refs * (32 * 16 * 2 + 32 * 2)


def refine_tile_products(n: int, b: int, winner: bool) -> tuple[int, int]:
    """The mma.sync products of B11 (winner) and B12/B13 for n tiles of side
    b: at b = 64 K2's block core (refine_tc_products, less the winner's 64
    m16n8k16 for a cost map); below, a warp's tile or pair of 8x8 tiles
    (csrc/refine_tile_tc.cuh): m16n8k32, its m groups x n tiles of window
    rows x 4 xf; m16n8k16, its fragments x 16 candidates x 2 (hi, lo), and
    for B11 the winners' fragments x 2 a tile."""
    if b == 64:
        k32, k16 = refine_tc_products(n)
        return k32, k16 - (0 if winner else n * 32 * 2)
    per_warp, cg = (2 if b == 8 else 1), (2 if b == 32 else 1)
    warps, frags = -(-n // per_warp), cg * b // 8
    k16 = warps * frags * 16 * 2 + (warps * frags * per_warp * 2 if winner else 0)
    return warps * cg * -(-(b + 7) // 8) * 4, k16


def mc_tc_products(n: int, h: int, w: int, bi: bool) -> int:
    """The mma.sync m16n8k32 products B5 (bi False) or B6 issues for n h x w
    blocks (csrc/mc_tc.cuh): for each 16-column strip and run of up to 4
    steps of 16 rows, 2 horizontal products a chunk of 16 window rows (a
    run's steps + 1 chunks) and 4 vertical ones a step (two 8-column
    halves, hi and lo), for each window."""
    steps = -(-h // 16)
    runs = [min(4, steps - q0) for q0 in range(0, steps, 4)]
    return n * -(-w // 16) * sum(2 * (k + 1) + 4 * k for k in runs) * (2 if bi else 1)


def adversarial_plane(shape, device, invert: bool = False) -> torch.Tensor:
    """A plane on which K2's and B3's refinement meets the extremes of its
    intermediate: for xf = yf = 2 (taps -1 4 -11 40 40 -11 4 -1), 255 under
    every positive tap and 0 under every negative one drives the horizontal
    pass to 22440 (hi byte 87), the reverse to -6120 (hi byte -24); rows
    alternate between the two in the same pattern, so the vertical pass
    meets both extremes too."""
    pos = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0], dtype=torch.bool, device=device)
    rows = torch.arange(shape[0], device=device)[:, None] % 8
    cols = torch.arange(shape[1], device=device)[None, :] % 8
    return ((pos[cols] ^ ~pos[rows] ^ invert).to(torch.uint8) * 255).contiguous()


def pan_picture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """bench.py's structured picture: its noise smoothed twice by a 3-tap
    box in each direction, (h + 64, w + 64) uint8."""
    rng = np.random.default_rng(seed)
    smooth = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8).astype(np.float32)
    for _ in range(2):
        smooth = (np.roll(smooth, 1, 0) + smooth + np.roll(smooth, -1, 0)) / 3
        smooth = (np.roll(smooth, 1, 1) + smooth + np.roll(smooth, -1, 1)) / 3
    return np.clip(smooth, 0, 255).astype(np.uint8)


def multiref_pan(h: int, w: int, k: int = 4, seed: int = 0):
    """The multi-reference content: cur is the pan picture at (32, 32); the
    k references are it at the k earlier positions of a pan of (2, 3)
    pixels a frame, reference i clean in the i-th of k vertical strips and
    with noise in [-24, 24] elsewhere, so each strip's CTUs pick their own
    reference.  Returns (cur (h, w), refs (k, h, w)) uint8."""
    pan = pan_picture(h, w, seed)
    cur = pan[32:32 + h, 32:32 + w].copy()
    noise = np.random.default_rng(seed + 1).integers(-24, 25, (k, h, w))
    refs = []
    for i in range(k):
        y0, x0 = 32 - 2 * (i + 1), 32 - 3 * (i + 1)
        ref = pan[y0:y0 + h, x0:x0 + w].astype(np.int32)
        clean = slice(i * w // k, (i + 1) * w // k)
        noise[i][:, clean] = 0
        refs.append(np.clip(ref + noise[i], 0, 255).astype(np.uint8))
    return cur, np.stack(refs)


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call of fn in microseconds, over ``calls`` calls
    (the card is synchronised before and after, not in between)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def log_b10_host_steps(tag: str, src, ref, cd_src, cd_ref) -> None:
    """The host time of each step of B10's launch path for 510 64x64 blocks
    (kernels/sad.py sad), beside the whole call and torch.cdist(p=1)'s."""
    from hevcasm_tpu_torch.kernels import build, sad as sad_mod
    from hevcasm_tpu_torch.utils.tensor import as_tensor

    dev, n = src.device, src.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    args = sad_mod._ARGS.pack(src.data_ptr(), 4096, 64, ref.data_ptr(), 4096, 0, 64,
                              out.data_ptr(), n, 1, 64, 64, dev.index, build.raw_stream(dev.index))
    lib = build.load()
    steps = {
        "as_tensor x2": lambda: (as_tensor(src), as_tensor(ref, dev)),
        "shape, stride, dtype checks": lambda: (
            src.shape, src.stride(), ref.stride(), ref.shape == src.shape,
            src.dtype is torch.uint8, ref.dtype is torch.uint8, dev.type == "cuda"),
        "torch.empty(n)": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "data_ptr x3 + raw_stream + pack": lambda: sad_mod._ARGS.pack(
            src.data_ptr(), 4096, 64, ref.data_ptr(), 4096, 0, 64, out.data_ptr(), n, 1, 64, 64,
            dev.index, build.raw_stream(dev.index)),
        "C entry (ctypes call and launch)": lambda: lib.hevc_sad(args),
        "sad() whole": lambda: sad_mod.sad(src, ref),
        "torch.cdist(p=1) whole": lambda: torch.cdist(cd_src, cd_ref, p=1),
    }
    log(f"{tag} B10 sad launch path, host us a call: " + ", ".join(
        f"{what} {host_us(fn):.2f}" for what, fn in steps.items()))


# ---- the multi phase: the sharded entry points (hevcasm_tpu_torch.parallel) --

H4K, W4K = 2176, 3840    # 4K padded to whole 64x64 CTUs: 34 x 60 = 2040
WAVES_1080P, WAVES_4K = 126, 254   # the wavefront I frame's waves: 2 (rows - 1) + cols of 32x32

#: Each counted wrapper's kernel module (hevcasm_tpu_torch.kernels.<module>).
COUNTED = {"ssd_grid_plane": "search", "inter_ctu_fused_dma": "inter_fused",
           "bi_ctu_fused_dma": "bi_fused", "refine_qpel_costmap": "costmap",
           "refine_qpel_costmap_dma": "costmap", "base_grids_ctu": "base_grids",
           "base_layout_decide": "base_grids", "ssd_grid": "search",
           "ssd_grid_plane_multi": "search", "refine_quarter_pel_fused": "inter_fused",
           "inter_ctu_fused": "inter_fused", "residual_pipeline_ctu": "residual_ctu",
           "sad_grid": "sad", "search_mv": "search", "search_mv_dma": "search",
           "encode_ctu_mega": "mega", "sad": "sad", "sad_multiref": "sad", "pred_uni": "mc",
           "pred_bi": "mc", "base_layout_decide_fc": "base_grids",
           "chroma_p_fused": "chroma_fused", "intra_wave_fused": "intra_wave"}


def counted_wrappers() -> dict:
    """Every registry kernel's wrapper by name; each counts its launches."""
    import importlib

    return {name: getattr(importlib.import_module(f"hevcasm_tpu_torch.kernels.{mod}"), name)
            for name, mod in COUNTED.items()}


def poisoned(a: np.ndarray, keep: slice, axis: int, seed: int) -> np.ndarray:
    """A copy of ``a`` whose entries outside ``keep`` along ``axis`` are
    noise: a rank given it reads nothing but its own share, or it fails."""
    out = np.random.default_rng(seed).integers(0, 256, a.shape, dtype=np.uint8)
    index = [slice(None)] * a.ndim
    index[axis] = keep
    out[tuple(index)] = a[tuple(index)]
    return out


def multi_rank(rank: int, world: int, clip9: np.ndarray, cur4k: np.ndarray,
               ref4k: np.ndarray, gop4k: np.ndarray, reps: int) -> dict:
    """One rank of the gloo world of two ranks on card 0 (parallel.launch
    starts it): config 4 (clip9's 8 P frames over mesh (2, 1)), config 5
    (gop4k's closed-loop spatial GOP over mesh (1, 2)) and the 4K spatial
    frame (mesh (1, 2)), each on a copy of its input made noise outside this
    rank's share (frames of its chunk and the reference before them; rows
    of its band; frame 0 of gop4k whole, since every rank codes the I frame).
    Each run's launches (counts set to 0 just before), what crossed between
    the ranks, and ``reps`` CUDA-event samples of its ms a coded frame, taken
    after a barrier with both ranks on the card at once."""
    import torch.distributed as dist

    from hevcasm_tpu_torch.encode.loop import EncodeConfig
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.parallel import (encode_gop_closed_loop_spatial,
                                            encode_gop_data_parallel,
                                            encode_inter_frame_spatial, make_mesh, multihost,
                                            sharding)

    build.load()
    counted = counted_wrappers()
    dev = multihost.rank_device()
    cfg = EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_dma")
    chunk = (clip9.shape[0] - 1) // world
    h = cur4k.shape[0]
    band = slice(rank * h // world, (rank + 1) * h // world)
    clip_t = torch.as_tensor(poisoned(clip9, slice(rank * chunk, (rank + 1) * chunk + 1), 0,
                                      100 + rank), device=dev)
    cur_t = torch.as_tensor(poisoned(cur4k, band, 0, 200 + rank), device=dev)
    ref_t = torch.as_tensor(poisoned(ref4k, band, 0, 300 + rank), device=dev)
    gop = poisoned(gop4k, band, 1, 400 + rank)
    gop[0] = gop4k[0]
    gop_t = torch.as_tensor(gop, device=dev)
    mesh_dp, mesh_sp = make_mesh(frames=world, rows=1), make_mesh(frames=1, rows=world)
    runs = {
        "config 4": (lambda: encode_gop_data_parallel(clip_t, mesh_dp, cfg),
                     {"ssd_grid_plane": 4, "inter_ctu_fused_dma": 4}, clip9.shape[0] - 1),
        "config 5": (lambda: encode_gop_closed_loop_spatial(gop_t, mesh_sp, cfg),
                     {"ssd_grid_plane": 2, "inter_ctu_fused_dma": 2,
                      "intra_wave_fused": WAVES_4K},
                     gop4k.shape[0]),
        "spatial 4K": (lambda: encode_inter_frame_spatial(cur_t, ref_t, mesh_sp, cfg),
                       {"ssd_grid_plane": 1, "inter_ctu_fused_dma": 1}, 1)}
    out = {}
    for name, (fn, need, frames) in runs.items():
        dist.barrier()
        torch.cuda.synchronize()
        for wrapper in counted.values():
            wrapper.launches = 0
        sharding.reset_wire_stats()
        result = fn()
        torch.cuda.synchronize()
        launched = {k: w.launches for k, w in counted.items() if w.launches}
        wire = dataclasses.asdict(sharding.wire)
        samples = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / frames)
        out[name] = {"result": result, "launches": launched, "need": need, "wire": wire,
                     "ms": sorted(samples), "frames": frames}
    try:
        encode_inter_frame_spatial(clip9[1], clip9[0], mesh_sp, cfg)
        out["1080p refusal"] = ""
    except ValueError as e:
        out["1080p refusal"] = str(e)
    return out


def multi_phase(tag: str, dev, cfg, drive, launches: dict) -> None:
    """Phase 5: the sharded entry points on the card, in a world of 1 under
    nccl (this process) and a world of 2 ranks sharing card 0 under gloo
    (NCCL takes one card a rank), against the single-card entry points."""
    import torch.distributed as dist

    from hevcasm_tpu_torch.encode.loop import encode_inter_frame
    from hevcasm_tpu_torch.encode.video import encode_gop_closed_loop
    from hevcasm_tpu_torch.parallel import (encode_gop_data_parallel,
                                            encode_inter_frame_spatial,
                                            encode_p_frames_batch, launch, make_mesh,
                                            multihost)

    def differs(got: dict, want: dict, keys) -> str:
        bad = []
        for k in keys:
            g = torch.as_tensor(np.asarray(got[k]) if not isinstance(got[k], torch.Tensor)
                                else got[k]).cpu()
            w = want[k].cpu()
            if g.shape != w.shape or g.dtype != w.dtype:
                bad.append(f"{k} {tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
            elif k == "psnr_db":
                if float((g - w).abs().max()) > 1e-3:
                    bad.append(f"{k} {g.tolist()} != {w.tolist()}")
            elif not torch.equal(g, w):
                bad.append(f"{k} max_abs_err {max_abs_err([g], [w])}")
        return "; ".join(bad)

    # Refusals: nccl takes a card a rank; nothing is started for them.  A
    # launcher tells initialize() the ranks on this host by LOCAL_WORLD_SIZE.
    for what, fn in (("spawn", lambda: launch.spawn(multi_rank, 2, backend="nccl",
                                                    device="cuda")),
                     ("initialize", lambda: multihost.initialize(
                         "localhost:29533", 2, 0, backend="nccl"))):
        try:
            with mock.patch.dict(os.environ, {"LOCAL_WORLD_SIZE": "2"}):
                fn()
        except ValueError as e:
            log(f"multi: nccl with 2 ranks on one card refused ({what}): {e}")
        else:
            raise AssertionError(f"multi: nccl with 2 ranks on one card was not refused ({what})")

    cur4k, ref4k = bench_frames(H4K, W4K)
    clip9 = rate_clip(9, H, W, 12)
    gop4k = rate_clip(3, H4K, W4K, 12, seed=1)
    cur_t, ref_t = (torch.as_tensor(a, device=dev) for a in (cur4k, ref4k))
    clip_t, gop_t = (torch.as_tensor(a, device=dev) for a in (clip9, gop4k))
    k1k2 = {"ssd_grid_plane": 1, "inter_ctu_fused_dma": 1}
    single4k = encode_inter_frame(cur_t, ref_t, cfg)
    per_frame = [encode_inter_frame(clip_t[t], clip_t[t - 1], cfg) for t in range(1, 9)]
    per_frame = {k: torch.stack([o[k] for o in per_frame]) for k in per_frame[0]}
    closed4k = encode_gop_closed_loop(gop_t, cfg, 3)
    keys = ("recon", "mvs", "sad", "nnz", "psnr_db")
    sp_keys = ("recon", "sad", "nnz", "psnr_db")

    # A world of 1 under nccl in this process, mesh 1 x 1.
    multihost.initialize()
    try:
        if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
            raise AssertionError(f"world of 1: {dist.get_backend()} x {dist.get_world_size()}")
        mesh = make_mesh(1, 1)
        sp1 = drive("multi: 4K spatial frame, world of 1 (nccl, mesh 1x1)",
                    lambda: encode_inter_frame_spatial(cur_t, ref_t, mesh, cfg), k1k2,
                    exact=True)
        diff = differs(sp1, single4k, sp_keys)
        if diff or set(sp1) != set(sp_keys):
            raise AssertionError(f"multi: 4K spatial frame (world of 1) != encode_inter_frame: "
                                 f"{diff} {sorted(sp1)}")
        dp1 = drive("multi: 1080p dp GOP of 9 frames, world of 1 (nccl, mesh 1x1)",
                    lambda: encode_gop_data_parallel(clip_t, mesh, cfg),
                    {"ssd_grid_plane": 8, "inter_ctu_fused_dma": 8}, exact=True)
        batch = encode_p_frames_batch(clip_t[1:], clip_t[:-1], cfg)
        for whose, want in (("encode_p_frames_batch", batch), ("the per-frame calls",
                                                               per_frame)):
            diff = differs(dp1, want, keys)
            if diff or set(dp1) != set(keys):
                raise AssertionError(f"multi: dp GOP (world of 1) != {whose}: {diff}")
        log(f"multi: world of 1 (nccl, mesh 1x1, {mesh.device_type}): the 4K spatial frame "
            f"equals encode_inter_frame (psnr_db {float(sp1['psnr_db']):.4f}), the 1080p dp "
            "GOP equals encode_p_frames_batch and the per-frame calls")
        t1 = turns_samples_ms({
            "4K spatial frame, world of 1": lambda: encode_inter_frame_spatial(
                cur_t, ref_t, mesh, cfg),
            "4K encode_inter_frame": lambda: encode_inter_frame(cur_t, ref_t, cfg)},
            calls=1, reps=10)
        t1.update({k: [v / 8 for v in s] for k, s in turns_samples_ms({
            "1080p dp GOP a P frame, world of 1": lambda: encode_gop_data_parallel(
                clip_t, mesh, cfg),
            "1080p encode_p_frames_batch a P frame": lambda: encode_p_frames_batch(
                clip_t[1:], clip_t[:-1], cfg)}, calls=1, reps=10).items()})
        for name, s in t1.items():
            log(f"{tag} multi: {name}: {statistics.median(s):.3f} ms a frame "
                f"(min {s[0]:.3f}, max {s[-1]:.3f}; 10 samples in turns, CUDA events)")
    finally:
        dist.destroy_process_group()
        multihost._DEVICE = None

    # A world of 2 ranks on card 0 under gloo.
    t0 = time.perf_counter()
    ranks = launch.spawn(multi_rank, 2, backend="gloo", device="cuda",
                         args=(clip9, cur4k, ref4k, gop4k, 5), timeout_s=900)
    log(f"multi: world of 2 on card 0 (gloo): {time.perf_counter() - t0:.1f} s with the "
        "ranks' start")
    wants = {"config 4": (per_frame, keys), "config 5": (closed4k, ("recon", "psnr_db")),
             "spatial 4K": (single4k, sp_keys)}
    for rank, out in enumerate(ranks):
        if "whole" not in out["1080p refusal"]:
            raise AssertionError(f"multi: rank {rank}: a 1080p frame over 2 bands (17 CTU "
                                 f"rows) was not refused: {out['1080p refusal']!r}")
        for name, (want, wkeys) in wants.items():
            run = out[name]
            if run["launches"] != run["need"]:
                raise AssertionError(f"multi: rank {rank} {name}: launched {run['launches']}, "
                                     f"not exactly {run['need']}")
            diff = differs(run["result"], want, wkeys)
            if diff or set(run["result"]) != set(wkeys):
                raise AssertionError(f"multi: rank {rank} {name} != the single-card entry "
                                     f"point: {diff}")
            for k, v in run["launches"].items():
                launches[k] += v
            s, wire = run["ms"], run["wire"]
            log(f"{tag} multi: rank {rank} of 2 (gloo, card 0 shared) {name}: "
                f"{statistics.median(s):.3f} ms a frame (min {s[0]:.3f}, max {s[-1]:.3f}; "
                f"{len(s)} samples, CUDA events); launches {run['launches']}; halo "
                f"{wire['halo_bytes'] / max(run['frames'] - (name == 'config 5'), 1):.0f} "
                f"bytes a P frame, gathered {wire['gathered_bytes']} bytes, host copies "
                f"{wire['host_copy_s'] * 1e3:.3f} ms a call")
    log("multi: world of 2 (gloo): config 4, config 5 and the 4K spatial frame equal the "
        "single-card entry points on inputs that are noise outside each rank's share, with "
        "exact launches; a 1080p frame over 2 bands refused")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from hevcasm_tpu_torch import cli, selftest
    from hevcasm_tpu_torch import io as yuv_io
    from hevcasm_tpu_torch.config import Tier
    from hevcasm_tpu_torch.encode import ctu as ctu_mod, motion, partition, rate
    from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu_torch.encode.loop import (
        EncodeConfig, _intra_mode_decide, _intra_neighbours, _prepare_intra_refs,
        _residual_pipeline, encode_gop, encode_inter_frame, encode_inter_frame_multiref,
        encode_intra_frame)
    from hevcasm_tpu_torch.encode.video import (
        YuvFrame, encode_b_frame_yuv, encode_gop_closed_loop, encode_gop_closed_loop_yuv,
        encode_gop_closed_loop_yuv_b, encode_gop_yuv, encode_inter_frame_yuv,
        encode_intra_frame_yuv)
    from hevcasm_tpu_torch.kernels import build
    from hevcasm_tpu_torch.kernels import mc
    from hevcasm_tpu_torch.kernels.base_grids import (
        base_grids_ctu, base_grids_ctu_ref, base_layout_decide, base_layout_decide_fc,
        base_layout_decide_fc_ref, base_layout_decide_ref)
    from hevcasm_tpu_torch.kernels.bi_fused import (
        bi_ctu_fused_dma, bi_ctu_fused_dma_ref)
    from hevcasm_tpu_torch.kernels.chroma_fused import chroma_p_fused, chroma_p_fused_ref
    from hevcasm_tpu_torch.kernels.intra_wave import intra_wave_fused, intra_wave_ref
    from hevcasm_tpu_torch.kernels.costmap import (
        refine_qpel_costmap, refine_qpel_costmap_dma, refine_qpel_costmap_dma_ref,
        refine_qpel_costmap_ref)
    from hevcasm_tpu_torch.kernels.inter_fused import (
        inter_ctu_fused, inter_ctu_fused_batched, inter_ctu_fused_dma,
        inter_ctu_fused_dma_ref, inter_ctu_fused_ref, refine_quarter_pel_fused,
        refine_quarter_pel_fused_ref)
    from hevcasm_tpu_torch.kernels.mega import encode_ctu_mega, encode_ctu_mega_ref
    from hevcasm_tpu_torch.kernels.residual_ctu import (
        residual_pipeline_ctu, residual_pipeline_ctu_ref)
    from hevcasm_tpu_torch.kernels.sad import (sad, sad_grid, sad_grid_ref, sad_multiref,
                                               sad_multiref_ref, sad_ref)
    from hevcasm_tpu_torch.ops.quantize import raise_on_flag, range_flag
    from hevcasm_tpu_torch.kernels.search import (
        search_mv, search_mv_dma, search_mv_dma_ref, search_mv_ref, ssd_grid,
        ssd_grid_plane, ssd_grid_plane_multi, ssd_grid_plane_multi_ref, ssd_grid_plane_ref,
        ssd_grid_ref)

    # ---- 1. device -----------------------------------------------------------
    dev = torch.device("cuda", 0)
    card_kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    tag = f"[{card}]"

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    imma = {name: sass_count(build, kernel, "IMMA") for name, kernel in (
        ("K1/B7", "ssd_grid_plane_kernel"), ("B8", "ssd_grid_tc_kernel"),
        ("B14", "base_grids_kernel"), ("B15", "decide_kernel"),
        ("B17", "search_mv_kernel"), ("B19", "mega_kernel"),
        ("K2/B16", "inter_fused_kernel"), ("B3", "bi_fused_kernel"))}
    vabs_b9 = sass_count(build, "sad_grid_kernel", "VABSDIFF4")
    log("SASS: IMMA instructions " + ", ".join(f"{k} {v}" for k, v in imma.items())
        + f"; {vabs_b9} VABSDIFF4 in B9's, "
        f"{sass_count(build, 'sad_kernel', 'VABSDIFF4')} VABSDIFF4 in B10's (cuobjdump -sass)")
    for name, count in imma.items():
        if not count:
            raise AssertionError(f"{name}'s kernel has no IMMA (u8 tensor-core) instruction")
    # B11, B12 and B13: every instance (tile side) of each kernel.
    for name, kernels, sides in (("B11", ("refine_tile_kernel", "refine_ctu_kernel"), 4),
                                 ("B12", ("costmap_windows_kernel", "costmap_ctu_kernel"), 4),
                                 ("B13", ("costmap_plane_kernel",), 3)):
        counts = {f: c for kernel in kernels for f, c in sass_counts(build, kernel, "IMMA").items()}
        log(f"SASS: IMMA instructions in {name}'s {len(counts)} kernel instances: "
            f"{sorted(counts.values())}")
        if len(counts) != sides or not min(counts.values()):
            raise AssertionError(f"{name}: a kernel instance has no IMMA instruction ({counts})")
    if "refine_core.cuh" in (build.CSRC / "refine_fused.cu").read_text():
        raise AssertionError("B11 includes the CUDA-core refinement (refine_core.cuh) again")
    # B5 and B6: both FIR passes on the tensor cores in each of the four
    # instances (taps 8 and 4, uni and bi), and no CUDA-core refinement.
    mc_imma = sass_counts(build, "pred_kernel", "IMMA")
    log(f"SASS: IMMA instructions in B5's and B6's {len(mc_imma)} kernel instances: "
        f"{sorted(mc_imma.values())}; their registers and local memory (cuobjdump "
        f"-res-usage): {resource_usage(build, 'pred_kernel')}")
    if len(mc_imma) != 4 or min(mc_imma.values()) < 6:
        raise AssertionError(f"B5/B6: an instance lacks its tensor-core passes ({mc_imma})")
    if "refine_core.cuh" in (build.CSRC / "mc.cu").read_text():
        raise AssertionError("B5/B6 include the CUDA-core refinement (refine_core.cuh) again")
    # B4: every instance (TU size) runs its four passes on the tensor cores,
    # at least 16 products a warp's tile, and the CUDA-core stage is gone.
    b4_imma = sass_counts(build, "residual_ctu_kernel", "IMMA")
    log(f"SASS: IMMA instructions in B4's {len(b4_imma)} kernel instances: "
        f"{sorted(b4_imma.values())}")
    if len(b4_imma) != 5 or min(b4_imma.values()) < 16:
        raise AssertionError(f"B4: an instance lacks its tensor-core passes ({b4_imma})")
    if "tmat<" in (build.CSRC / "residual_core.cuh").read_text():
        raise AssertionError("the CUDA-core residual stage (tmat) is back in residual_core.cuh")
    for gone, whose in (("search_core.cuh", "B17/B19's"), ("grid_core.cuh", "B8/B14's")):
        if (build.CSRC / gone).exists() or any(
                gone in f.read_text() for f in build.CSRC.glob("*.cu*")):
            raise AssertionError(f"{whose} former CUDA-core grid loop ({gone}) is back")
    if not vabs_b9:
        raise AssertionError("B9's kernel has no VABSDIFF4 (packed absolute difference)")
    # K2's and B3's kernels: the host-int instance and the device-q one (the
    # rate controller's), each on the tensor cores.
    for name, kernel in (("K2/B16", "inter_fused_kernel"), ("B3", "bi_fused_kernel")):
        q_imma = sass_counts(build, kernel, "IMMA")
        log(f"SASS: {name}'s {len(q_imma)} kernel instances (host-int, device-q): IMMA "
            f"{sorted(q_imma.values())}; registers and local memory (cuobjdump -res-usage): "
            f"{resource_usage(build, kernel)}")
        if len(q_imma) != 2 or not min(q_imma.values()):
            raise AssertionError(f"{name}: not two tensor-core instances ({q_imma})")

    # ---- 3. each kernel against its plain version ---------------------------
    cfg = EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_dma")
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    err = dict.fromkeys(("ssd_grid_plane", "inter_ctu_fused_dma", "bi_ctu_fused_dma",
                         "refine_qpel_costmap", "refine_qpel_costmap_dma",
                         "base_grids_ctu", "base_layout_decide", "ssd_grid",
                         "ssd_grid_plane_multi", "refine_quarter_pel_fused",
                         "inter_ctu_fused", "residual_pipeline_ctu", "sad_grid",
                         "search_mv", "search_mv_dma", "encode_ctu_mega", "sad",
                         "sad_multiref", "pred_uni", "pred_bi", "base_layout_decide_fc",
                         "chroma_p_fused", "intra_wave_fused"), 0)

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

    def check_b3(what, src, flat, off0, off1):
        got = bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
        want = bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs)
        e = max_abs_err(got, want)
        log(f"B3 bi_ctu_fused_dma {what}: n={src.shape[0]} offsets0 "
            f"[{int(off0.min())}, {int(off0.max())}] offsets1 "
            f"[{int(off1.min())}, {int(off1.max())}] max_abs_err={e}")
        err["bi_ctu_fused_dma"] = max(err["bi_ctu_fused_dma"], e)

    def stacked(ref0, ref1, r):
        """Two references padded as the loop pads them, stacked by rows,
        and the lower plane's row offset."""
        pl, pr = r + motion.PAD_L, r + motion.PAD_R
        planes = [ctu_mod.pad_frame(p, pl, pr, pl, pr) for p in (ref0, ref1)]
        hp = planes[0].shape[0]
        return (torch.cat(planes).contiguous(),
                torch.tensor([hp, 0], dtype=torch.int32, device=dev))

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
    for r in (1, 2, 31):           # one tile each way; a part last k step and word
        check_k1("odd grid width", *search_inputs(small[0], small[1], r)[:3], r)
    # The extremes: 4096 * 255^2 (the largest sum) and 0 at every candidate.
    extremes = [(0, 255, 4096 * 255 * 255), (255, 255, 0)]
    for sv, pv, want in extremes:
        e_src = torch.full((3, 64, 64), sv, dtype=torch.uint8, device=dev)
        e_plane = torch.full((64 + 2 * SEARCH_RANGE, 192 + 2 * SEARCH_RANGE), pv,
                             dtype=torch.uint8, device=dev)
        check_k1(f"CTUs all {sv}, plane all {pv}", e_src, e_plane, (1, 3), SEARCH_RANGE)
        got = ssd_grid_plane(e_src, e_plane, (1, 3), 2 * SEARCH_RANGE + 1)
        if not bool((got == want).all()):
            raise AssertionError(f"K1 CTUs all {sv}, plane all {pv}: not {want} everywhere")
    # B3: the B frame of the structured pan, two stacked 1080p planes.
    yuv_cur, yuv_ref0, yuv_ref1 = (YuvFrame(*(torch.as_tensor(p, device=dev) for p in f))
                                   for f in structured_pan(H, W))
    b_src = ctu_mod.tile_frame(yuv_cur.y, 64).contiguous()
    b_flat, lower = stacked(yuv_ref0.y, yuv_ref1.y, SEARCH_RANGE)
    b_mvs = [motion.full_search_slab(b_src, half, SEARCH_RANGE, grid,
                                     grid_plane_fn=ssd_grid_plane_ref)[0]
             for half in b_flat.chunk(2)]
    b3_off0 = (pos + b_mvs[0] + SEARCH_RANGE).contiguous()
    b3_off1 = (pos + b_mvs[1] + SEARCH_RANGE + lower).contiguous()
    check_b3("1080p at the searched MVs", b_src, b_flat, b3_off0, b3_off1)
    check_b3("1080p offsets 0..max in both planes", b_src, b_flat,
             mv_offsets(grid, SEARCH_RANGE, 5), mv_offsets(grid, SEARCH_RANGE, 6) + lower)
    s_flat, s_lower = stacked(small[1], small[0], 8)
    check_b3("odd grid width, offsets 0..max in both planes", s_src, s_flat,
             mv_offsets(s_grid, 8, 7), mv_offsets(s_grid, 8, 8) + s_lower)
    c_flat, c_lower = stacked(flat, torch.full_like(flat, 40), SEARCH_RANGE)
    c_offsets = (mv_offsets(c_grid, SEARCH_RANGE, 9),
                 mv_offsets(c_grid, SEARCH_RANGE, 10) + c_lower)
    c_got = bi_ctu_fused_dma(c_src, c_flat, *c_offsets, *qargs)
    if int(c_got[1].abs().max()) or int(c_got[2].abs().max()):
        raise AssertionError("constant planes: the first fraction did not win")
    check_b3("constant planes (all fractions tie)", c_src, c_flat, *c_offsets)
    # K2's and B3's intermediate at its extremes (22440 and -6120 after the
    # horizontal pass, both extremes in the vertical pass), on 0/255 CTUs.
    adv_src = (src > 127).to(torch.uint8) * 255
    adv_offsets = mv_offsets(grid, SEARCH_RANGE, 13)
    for invert in (False, True):
        adv = adversarial_plane(padded.shape, dev, invert)
        what = f"adversarial windows{' (inverted)' if invert else ''}"
        check_k2(what, adv_src, adv, adv_offsets)
        hp_b = b_flat.shape[0] // 2
        adv_flat = torch.cat([adversarial_plane((hp_b, b_flat.shape[1]), dev, invert),
                              adversarial_plane((hp_b, b_flat.shape[1]), dev, not invert)])
        check_b3(what, adv_src, adv_flat.contiguous(), mv_offsets(grid, SEARCH_RANGE, 14),
                 mv_offsets(grid, SEARCH_RANGE, 15) + lower)

    # K2's, B16's and B3's device-q C entries (the rate controller's): the
    # five parameters as 0-d int32 tensors, read by the kernel from an
    # int32[5] on the card, against the host-int entry and the plain
    # version at qp 10, 32 and 49; a shift of 28 or a dshift of 0 must set
    # its bit in the range flag and leave the fractions as they were.
    def qtensors(args):
        return tuple(torch.full((), q, dtype=torch.int32, device=dev) for q in args)

    k2_win = motion.extract_windows(padded, k2_offsets, 71).contiguous()
    device_q_cases = (
        ("inter_ctu_fused_dma", "K2", inter_ctu_fused_dma, inter_ctu_fused_dma_ref,
         (src, padded, k2_offsets)),
        ("inter_ctu_fused", "B16", inter_ctu_fused, inter_ctu_fused_ref, (src, k2_win)),
        ("bi_ctu_fused_dma", "B3", bi_ctu_fused_dma, bi_ctu_fused_dma_ref,
         (b_src, b_flat, b3_off0, b3_off1)))
    for qp_q in (10, 32, 49):
        q_cfg = dataclasses.replace(cfg, qp=qp_q)
        q_args = (*q_cfg.quant_params(False), *q_cfg.dequant_params())
        for name, short, fn, ref_fn, args in device_q_cases:
            flag = range_flag(dev)
            got = fn(*args, *qtensors(q_args), range_flag=flag)
            host = fn(*args, *q_args)
            e = max(max_abs_err(got, host), max_abs_err(got, ref_fn(*args, *q_args)))
            if int(flag):
                raise AssertionError(f"{short} device-q entry at qp {qp_q}: flag {int(flag)}")
            log(f"{short} {name} device-q entry, 1080p at qp {qp_q}: max_abs_err={e} against "
                "the host-int entry and the plain version")
            err[name] = max(err[name], e)
            if qp_q == 32:
                for bad, bit in (((q_args[0], 28, *q_args[2:]), 2), ((*q_args[:4], 0), 8)):
                    flag = range_flag(dev)
                    out_bad = fn(*args, *qtensors(bad), range_flag=flag)
                    if int(flag) != bit or not torch.equal(out_bad[1], host[1]):
                        raise AssertionError(f"{short} device-q entry, parameters {bad}: "
                                             f"flag {int(flag)}, not {bit}, or fractions moved")
                log(f"{short} device-q entry: qshift 28 sets flag bit 2, dshift 0 bit 8")

    # B8 and B12-B15: the partition kernels on the structured pan's luma.
    def check(name, what, got, want, shape):
        e = max_abs_err(got, want)
        log(f"{name} {what}: {shape} max_abs_err={e}")
        err[name] = max(err[name], e)
        return got

    def check_b15(what, src, win, base, lists):
        return check("base_layout_decide", what, [base_layout_decide(src, win, base, lists)],
                     [base_layout_decide_ref(src, win, base, lists)],
                     f"n={src.shape[0]} base={base} PUs={len(lists)}")[0]

    def check_b14(what, src, win, base):
        got = check("base_grids_ctu", what, [base_grids_ctu(src, win, base)],
                    [base_grids_ctu_ref(src, win, base)], f"n={src.shape[0]} base={base}")[0]
        torch.cuda.empty_cache()
        return got

    def check_b13(what, tiles, plane, offsets):
        return check("refine_qpel_costmap_dma", what,
                     refine_qpel_costmap_dma(tiles, plane, offsets),
                     refine_qpel_costmap_dma_ref(tiles, plane, offsets),
                     f"tiles={tuple(tiles.shape)} offsets [{int(offsets.min())}, "
                     f"{int(offsets.max())}]")

    def check_b8(what, blocks, windows, num, num_dx=None):
        num_dx = num_dx or num
        return check("ssd_grid", what, [ssd_grid(blocks, windows, num, num_dx)],
                     [ssd_grid_ref(blocks, windows, num, num_dx)],
                     f"blocks={tuple(blocks.shape)} windows={tuple(windows.shape)} "
                     f"num {num}x{num_dx}")[0]

    def sub_block_windows(ctu_win, base, r):
        """partition.base_grid_search's operands: the (base x base) blocks
        of the pan's CTUs and their (base + 2r)^2 windows, cut from CTU
        windows at R = 32."""
        wsub, o = base + 2 * r, SEARCH_RANGE - r
        w = ctu_win[:, o:o + 64 + 2 * r, o:o + 64 + 2 * r]
        w = w.unfold(1, wsub, base).unfold(2, wsub, base).reshape(-1, wsub, wsub)
        return ctu_mod.split_blocks(b_src, base).contiguous(), w.contiguous()

    def check_b12(what, tiles, windows):
        return check("refine_qpel_costmap", what, [refine_qpel_costmap(tiles, windows)],
                     [refine_qpel_costmap_ref(tiles, windows)],
                     f"tiles={tuple(tiles.shape)}")[0]

    def tile_offsets(base, mv):
        """Window starts pos + tile offset + MV + R of every base tile of
        the frame, for integer MVs (n, k*k, 2)."""
        k = 64 // base
        offs = torch.tensor([(ty * base, tx * base) for ty in range(k) for tx in range(k)],
                            dtype=torch.int32, device=dev)
        return (pos[:, None] + offs[None] + mv + SEARCH_RANGE).reshape(-1, 2) \
            .to(torch.int32).contiguous()

    p_padded = ctu_mod.pad_frame(yuv_ref0.y, SEARCH_RANGE + motion.PAD_L,
                                 SEARCH_RANGE + motion.PAD_R, SEARCH_RANGE + motion.PAD_L,
                                 SEARCH_RANGE + motion.PAD_R)
    p_win = motion.extract_aligned_windows(p_padded, (motion.PAD_L, motion.PAD_L), grid,
                                           64, 64 + 2 * SEARCH_RANGE)
    default_layouts = EncodeConfig().pu_layouts
    lists8 = partition._pu_lists(default_layouts, 8)
    lists16 = partition._pu_lists(default_layouts, 16)
    lists32 = partition._pu_lists(default_layouts[:4], 32)       # quarter needs base 16
    dec16 = check_b15("1080p base 16, default layouts", b_src, p_win, 16, lists16)
    check_b15("1080p base 32", b_src, p_win, 32, lists32)
    g8 = check_b14("1080p base 8", b_src, p_win, 8)
    mv8, _ = partition._argmin_grid(g8, SEARCH_RANGE)                      # (n, 8, 8, 2)
    del g8
    check_b14("1080p base 16", b_src, p_win, 16)
    check_b14("1080p base 32", b_src, p_win, 32)
    # The quarter layout's PUs are the 16 base-16 tiles (lists 9..24).
    q0 = len(lists16) - 17
    starts16 = tile_offsets(16, dec16[:, q0:q0 + 16, :2])
    starts8 = tile_offsets(8, mv8.reshape(-1, 64, 2))
    tiles16 = ctu_mod.split_blocks(b_src, 16).contiguous()
    tiles8 = ctu_mod.split_blocks(b_src, 8).contiguous()
    max_off = [p_padded.shape[0], p_padded.shape[1]]

    def spread(b, count, seed):
        """Offsets over [0, the largest start that fits], the first at 0 and
        the last at the maximum."""
        rng = np.random.default_rng(seed)
        hi = np.array(max_off) - (b + 7)
        o = (rng.random((count, 2)) * (hi + 1)).astype(np.int32)
        o[0], o[-1] = 0, hi
        return torch.as_tensor(o, device=dev)

    check_b13("1080p 16x16 tiles at the searched MVs", tiles16, p_padded, starts16)
    check_b13("1080p 8x8 tiles at the searched MVs", tiles8, p_padded, starts8)
    tiles32 = ctu_mod.split_blocks(b_src, 32).contiguous()
    for seed, tiles in enumerate((tiles32, tiles16, tiles8)):
        b = tiles.shape[-1]
        check_b13(f"1080p {b}x{b} tiles, offsets 0..max", tiles, p_padded,
                  spread(b, tiles.shape[0], 11 + seed))
    starts_by_b = {64: tile_offsets(64, dec16[:, -1:, :2]),
                   32: tile_offsets(32, dec16[:, q0 - 4:q0, :2]), 16: starts16, 8: starts8}
    for b, starts in starts_by_b.items():
        tiles = ctu_mod.split_blocks(b_src, b).contiguous()
        check_b12(f"1080p b={b} on gathered windows at the searched MVs", tiles,
                  motion.extract_windows(p_padded, starts, b + 7))
    b8_r16, b8_8_r16 = sub_block_windows(p_win, 16, 16), sub_block_windows(p_win, 8, 16)
    for base, r in ((16, 16), (16, SEARCH_RANGE), (8, 16)):
        blocks, wins = {(16, 16): b8_r16, (8, 16): b8_8_r16}.get((base, r)) \
            or sub_block_windows(p_win, base, r)
        check_b8(f"1080p {base}x{base} blocks, R={r}", blocks, wins, 2 * r + 1)
    check_b8("1080p CTUs, R=32", b_src, p_win, 2 * SEARCH_RANGE + 1)
    # Constant inputs: every candidate and every fraction ties.
    flat_win = torch.full_like(p_win, 97)
    c_dec = check_b15("constant windows (all candidates tie)", b_src, flat_win, 16, lists16)
    if not bool((c_dec[:, :, :2] == -SEARCH_RANGE).all()):
        raise AssertionError("B15 constant windows: the first minimum is not (-R, -R)")
    check_b14("constant windows (all candidates tie)", b_src, flat_win, 32)
    c_grid = check_b8("constant windows (all candidates tie)",
                      *sub_block_windows(flat_win, 16, 16), 33)
    if not bool((c_grid == c_grid[:, :1, :1]).all()):
        raise AssertionError("B8 constant windows: the candidates do not tie")
    flat_plane = torch.full_like(p_padded, 40)
    c_cost, _ = check_b13("constant plane (all fractions tie)", tiles16, flat_plane, starts16)
    c_map = check_b12("constant windows (all fractions tie)", tiles8,
                      torch.full((tiles8.shape[0], 15, 15), 97, dtype=torch.uint8, device=dev))
    if not (bool((c_cost == c_cost[:, :1, :1]).all()) and bool((c_map == c_map[:, :1, :1]).all())):
        raise AssertionError("B12/B13 constant inputs: the fractions do not tie")
    for b in (8, 16, 32, 64):
        c_tiles = ctu_mod.split_blocks(b_src, b).contiguous()
        c_win = torch.full((c_tiles.shape[0], b + 7, b + 7), 97, dtype=torch.uint8, device=dev)
        c_pred, c_frac, _ = check("refine_quarter_pel_fused",
                                  f"constant windows (all fractions tie), b={b}",
                                  refine_quarter_pel_fused(c_tiles, c_win),
                                  refine_quarter_pel_fused_ref(c_tiles, c_win),
                                  f"tiles={tuple(c_tiles.shape)}")
        if bool(c_frac.any()) or not bool((c_pred == 97).all()):
            raise AssertionError(f"B11 constant windows, b={b}: not fraction 0 and the constant")

    # B7, B11, B16 and B4: the multi-reference P frame's kernels.
    mr_cur_np, mr_refs_np = multiref_pan(H, W)
    mr_cur = torch.as_tensor(mr_cur_np, device=dev)
    mr_src = ctu_mod.tile_frame(mr_cur, 64).contiguous()
    pl, pr = SEARCH_RANGE + motion.PAD_L, SEARCH_RANGE + motion.PAD_R
    mr_planes = torch.stack([ctu_mod.pad_frame(torch.as_tensor(p, device=dev), pl, pr, pl, pr)
                             for p in mr_refs_np])                   # (4, Hp, Wp)
    mr_view = mr_planes[:, motion.PAD_L:motion.PAD_L + H + 2 * SEARCH_RANGE,
                        motion.PAD_L:motion.PAD_L + W + 2 * SEARCH_RANGE]
    check("ssd_grid_plane_multi", "1080p k=4 on the padded planes (a view)",
          [ssd_grid_plane_multi(mr_src, mr_view, grid, 65)],
          [ssd_grid_plane_multi_ref(mr_src, mr_view, grid, 65)], f"n=510 k=4 R={SEARCH_RANGE}")
    s_planes = torch.stack([ctu_mod.pad_frame(p, 8, 8, 8, 8) for p in (small[1], small[0],
                                                                     flat)])
    check("ssd_grid_plane_multi", "odd grid width, k=3", 
          [ssd_grid_plane_multi(s_src, s_planes, s_grid, 17)],
          [ssd_grid_plane_multi_ref(s_src, s_planes, s_grid, 17)], f"grid={s_grid} k=3 R=8")
    r31_planes = torch.stack([search_inputs(small[0], p, 31)[1] for p in (small[1], small[0],
                                                                           flat)])
    check("ssd_grid_plane_multi", "odd grid width, k=3, R=31",
          [ssd_grid_plane_multi(s_src, r31_planes, s_grid, 63)],
          [ssd_grid_plane_multi_ref(s_src, r31_planes, s_grid, 63)], f"grid={s_grid} k=3 R=31")
    for sv, pv, want in extremes:
        e_src = torch.full((3, 64, 64), sv, dtype=torch.uint8, device=dev)
        e_planes = torch.full((2, 64 + 2 * SEARCH_RANGE, 192 + 2 * SEARCH_RANGE), pv,
                              dtype=torch.uint8, device=dev)
        got = check("ssd_grid_plane_multi", f"CTUs all {sv}, planes all {pv}",
                    [ssd_grid_plane_multi(e_src, e_planes, (1, 3), 65)],
                    [ssd_grid_plane_multi_ref(e_src, e_planes, (1, 3), 65)], "k=2 R=32")[0]
        if not bool((got == want).all()):
            raise AssertionError(f"B7 CTUs all {sv}, planes all {pv}: not {want} everywhere")
    mr_mv, mr_idx, _ = motion.full_search_multi(
        mr_src, mr_planes, pos, SEARCH_RANGE, grid=grid, metric="ssd",
        grid_plane_multi_fn=ssd_grid_plane_multi_ref)
    hp_mr, wp_mr = mr_planes.shape[1:]
    mr_flat = mr_planes.reshape(-1, wp_mr)
    mr_start = pos + mr_mv + SEARCH_RANGE
    mr_offsets = torch.stack([mr_idx * hp_mr + mr_start[:, 0], mr_start[:, 1]], -1) \
        .to(torch.int32).contiguous()
    mr_win = motion.extract_windows(mr_flat, mr_offsets, 71)
    check("refine_quarter_pel_fused", "1080p 510 64x64 windows at the searched MVs",
          refine_quarter_pel_fused(mr_src, mr_win), refine_quarter_pel_fused_ref(mr_src, mr_win),
          "n=510 b=64")
    win16 = motion.extract_windows(p_padded, starts16, 23)
    check("refine_quarter_pel_fused", "1080p 8160 16x16 tiles at the searched MVs",
          refine_quarter_pel_fused(tiles16, win16), refine_quarter_pel_fused_ref(tiles16, win16),
          "n=8160 b=16")
    b16_win = motion.extract_windows(padded, mv_offsets(grid, SEARCH_RANGE, 12), 71)
    b16_want = inter_ctu_fused_ref(src, b16_win, *qargs)
    check("inter_ctu_fused", "1080p 510 windows at random MVs",
          inter_ctu_fused(src, b16_win, *qargs), b16_want, "n=510")
    check("inter_ctu_fused", "1080p batched, group 4 (510 % 4 = 2)",
          inter_ctu_fused_batched(src, b16_win, *qargs, group=4), b16_want, "n=510 group=4")
    for invert in (False, True):
        adv_win = motion.extract_windows(adversarial_plane(padded.shape, dev, invert),
                                         adv_offsets, 71)
        check("inter_ctu_fused", f"adversarial windows{' (inverted)' if invert else ''}",
              inter_ctu_fused(adv_src, adv_win, *qargs),
              inter_ctu_fused_ref(adv_src, adv_win, *qargs), "n=510")
    b4_pred = ctu_mod.tile_frame(yuv_ref0.y, 64).contiguous()
    b4_args = {}
    for tu, tr_type in ((4, 1), (4, 0), (8, 0), (16, 0), (32, 0)):
        tcfg = EncodeConfig(qp=32, tu=tu)
        b4_args[(tu, tr_type)] = (*tcfg.quant_params(bool(tr_type)), *tcfg.dequant_params())
        check("residual_pipeline_ctu", f"1080p tu={tu} {'DST' if tr_type else 'DCT'}",
              residual_pipeline_ctu(b_src, b4_pred, *b4_args[(tu, tr_type)], tu=tu,
                                    tr_type=tr_type),
              residual_pipeline_ctu_ref(b_src, b4_pred, *b4_args[(tu, tr_type)], tu=tu,
                                        tr_type=tr_type), "n=510")
    # Full-swing CTUs (255 over 0 and the reverse, checkerboards, random
    # 0/255) beside random ones, at qp 32 and at the quantizer's range edges.
    rs_src, rs_pred = (torch.as_tensor(a, device=dev)
                       for a in residual_ctus(np.random.default_rng(13)))
    for (tu, tr_type), q32 in b4_args.items():
        for qname, q in (("qp 32", q32), *RESIDUAL_EDGE_QARGS.items()):
            check("residual_pipeline_ctu",
                  f"full swing, tu={tu} {'DST' if tr_type else 'DCT'}, {qname}",
                  residual_pipeline_ctu(rs_src, rs_pred, *q, tu=tu, tr_type=tr_type),
                  residual_pipeline_ctu_ref(rs_src, rs_pred, *q, tu=tu, tr_type=tr_type),
                  "n=6")

    # B9, B17 and B19: the search configurations' kernels.
    def check_b9(what, blocks, windows, num):
        return check("sad_grid", what, [sad_grid(blocks, windows, num, num)],
                     [sad_grid_ref(blocks, windows, num, num)],
                     f"blocks={tuple(blocks.shape)} windows={tuple(windows.shape)}")[0]

    # The pyramid's two levels on the structured pan: the 4x-decimated CTUs
    # against the decimated reference padded by R/4 = 8, then the CTUs at
    # +-3 around coarse MVs in [-29, 29].
    b9_src_c = motion._downsample4(b_src).contiguous()
    b9_ref_c = ctu_mod.pad_frame(motion._downsample4(yuv_ref0.y), 8, 8, 8, 8)
    b9_win_c = motion.extract_aligned_windows(b9_ref_c, (0, 0), grid, 16, 32)
    check_b9("1080p pyramid coarse level, 510 16x16 blocks", b9_src_c, b9_win_c, 17)
    mv_c = torch.as_tensor(np.random.default_rng(13).integers(-29, 30, (grid[0] * grid[1], 2)),
                           device=dev)
    b9_win_f = motion.extract_windows(p_padded, pos + mv_c - 3 + SEARCH_RANGE + motion.PAD_L, 70)
    check_b9("1080p pyramid fine level, 510 CTUs", b_src, b9_win_f, 7)
    check_b9("1080p full search, 510 CTUs, R=32", b_src, p_win, 65)
    b8_r32 = sub_block_windows(p_win, 16, SEARCH_RANGE)
    check_b9("1080p PU decision, 8160 16x16 blocks, R=32", *b8_r32, 65)
    c_sad = check_b9("constant windows (all candidates tie)", b_src, flat_win, 65)
    if not bool((c_sad == c_sad[:, :1, :1]).all()):
        raise AssertionError("B9 constant windows: the candidates do not tie")
    # Every residue-class plan: each block side and count, windows cut from
    # wider rows at an odd byte offset (rows and pointers unaligned).
    odd_rows = torch.nn.functional.pad(p_win[:8], (0, 5, 0, 1))      # rows 133 bytes apart
    for b in (8, 16, 32, 64):
        for num_b9 in (1, 7, 17, 33, 65):
            check_b9(f"b={b} num={num_b9}, unaligned strided windows", b_src[:8, :b, :b]
                     .contiguous(), odd_rows[:, 1:, 3:3 + b + num_b9 - 1], num_b9)
    # B8 on the same windows (also num_dy != num_dx), on the pyramid's two
    # levels, and on windows up to 256 wide (past the TPU kernel's 128),
    # which tile the m and n ranges over blocks.
    for b in (8, 16, 32, 64):
        for num_b8 in (1, 7, 17, 33, 65):
            blocks_b8 = b_src[:8, :b, :b].contiguous()
            win_b8 = odd_rows[:, 1:, 3:3 + b + num_b8 - 1]
            check_b8(f"b={b} num={num_b8}, unaligned strided windows", blocks_b8, win_b8,
                     num_b8)
            check_b8(f"b={b} num={max(1, num_b8 // 2)}x{num_b8}, unaligned strided windows",
                     blocks_b8, win_b8, max(1, num_b8 // 2), num_b8)
    check_b8("1080p pyramid coarse level, 510 16x16 blocks", b9_src_c, b9_win_c, 17)
    check_b8("1080p pyramid fine level, 510 CTUs", b_src, b9_win_f, 7)
    wide_win = yuv_ref0.y.unfold(0, 256, 64).unfold(1, 256, 64)[:8, :8].reshape(64, 256, 256)
    for b, num_dy, num_dx in ((8, 249, 249), (64, 193, 193), (64, 129, 129), (16, 150, 97)):
        check_b8(f"b={b} windows {b + num_dy - 1}x{b + num_dx - 1}, 64 blocks",
                 b_src[:64, :b, :b].contiguous(), wide_win, num_dy, num_dx)

    def win128_of(plane, g):
        """search_mv's operand: the gathered 128x128 windows at R = 32."""
        return motion.extract_aligned_windows(plane, (motion.PAD_L, motion.PAD_L), g, 64,
                                              128).contiguous()

    def nontrivial(what, mv, best, vary_mv):
        """Fail unless most minima are non-zero and differ between CTUs
        (and, with vary_mv, most MVs too), so that a kernel which mis-sums
        the candidates that do not win cannot pass."""
        n_ = best.shape[0]
        zero = float((best == 0).float().mean())
        mvs, mins = len(torch.unique(mv, dim=0)), len(torch.unique(best))
        log(f"{what}: share of CTUs at best 0 {zero:.4f}, {mvs} distinct MVs, "
            f"{mins} distinct minima of {n_} CTUs")
        if zero > 0.5 or mins < n_ // 2 or (vary_mv and mvs < n_ // 2):
            raise AssertionError(f"{what}: the search on this content is trivial")

    # Bench content (and the structured pan's luma) is a pure integer shift,
    # so most CTUs match exactly.  The multiref pan's reference 0 is noisy
    # outside its own quarter of the frame: non-zero minima, one MV.  Two
    # independent noise planes: non-zero minima at MVs that differ between
    # CTUs.
    rnd = np.random.default_rng(14)
    rnd_src = ctu_mod.tile_frame(torch.as_tensor(
        rnd.integers(0, 256, (H, W), dtype=np.uint8), device=dev), 64).contiguous()
    rnd_padded = ctu_mod.pad_frame(torch.as_tensor(
        rnd.integers(0, 256, (H, W), dtype=np.uint8), device=dev), pl, pr, pl, pr)
    s_pos = motion.ctu_positions(*s_grid, 64, dev)
    # (what, src, padded plane, positions, CTU grid, R, check): the constant
    # plane's frame is 128x192, the grid of s_grid.
    b17_cases = [
        ("1080p bench content", src, padded, pos, grid, SEARCH_RANGE, None),
        ("1080p multiref pan, reference 0", mr_src, mr_planes[0], pos, grid, SEARCH_RANGE,
         "minima"),
        ("1080p independent noise planes", rnd_src, rnd_padded, pos, grid, SEARCH_RANGE,
         "minima and MVs"),
        ("odd grid width", s_src, s_padded, s_pos, s_grid, 8, None),
        ("constant plane (all candidates and fractions tie)", c_src, c_padded,
         motion.ctu_positions(*s_grid, 64, dev), s_grid, SEARCH_RANGE, "ties"),
    ]
    for what, src_i, plane_i, pos_i, grid_i, r, kind in b17_cases:
        shape = f"n={src_i.shape[0]} R={r}"
        outs = []
        if r == SEARCH_RANGE:           # B17 runs at R = 32 only, as the loop does
            win_i = win128_of(plane_i, grid_i)
            outs.append(check("search_mv", what, search_mv(src_i, win_i, 65),
                              search_mv_ref(src_i, win_i, 65), shape))
            outs.append(check("search_mv_dma", what,
                              search_mv_dma(src_i, plane_i, pos_i, r),
                              search_mv_dma_ref(src_i, plane_i, pos_i, r), shape))
        mega_out = check("encode_ctu_mega", what,
                         encode_ctu_mega(src_i, plane_i, pos_i, r, *qargs),
                         encode_ctu_mega_ref(src_i, plane_i, pos_i, r, *qargs), shape)
        outs.append((mega_out[1], mega_out[3]))
        for name, (mv_i, best_i) in zip(("B17 search_mv", "B17 search_mv_dma",
                                         "B19 encode_ctu_mega")[-len(outs):], outs):
            if kind == "ties" and not bool((mv_i == -r).all()):
                raise AssertionError(f"{name} constant plane: the first minimum is not (-R, -R)")
            if kind in ("minima", "minima and MVs"):
                nontrivial(f"{name} {what}", mv_i, best_i, kind == "minima and MVs")
        if kind == "ties" and bool(mega_out[2].any()):
            raise AssertionError("B19 constant plane: the first fraction did not win")
    win128 = win128_of(padded, grid)
    # B17 is one launch a call: no key scratch to clear, no decode kernel,
    # and its wrappers add no torch op.
    for name, fn in (("search_mv", lambda: search_mv(src, win128, 65)),
                     ("search_mv_dma", lambda: search_mv_dma(src, padded, pos, SEARCH_RANGE))):
        ops = device_ops(fn)
        log(f"B17 {name}: operations on the card in one call (torch.profiler): {ops}")
        if len(ops) != 1 or "search_mv_kernel" not in ops[0]:
            raise AssertionError(f"B17 {name}: a call must launch its kernel and nothing "
                                 f"else, got {ops}")

    # B10, B5, B6 and B18: the self-test's kernels, at every self-test shape
    # (strided views and 2-D inputs as the suites pass them) and at frame
    # shapes.
    st_rng = np.random.default_rng(15)
    st_src = torch.as_tensor(st_rng.integers(0, 256, (128, 128), dtype=np.uint8), device=dev)
    st_ref = torch.as_tensor(st_rng.integers(0, 256, (4, 128, 128), dtype=np.uint8),
                             device=dev)
    for w_, h_ in selftest.PARTITIONS:
        s_v, r_v = st_src[:h_, :w_], st_ref[0, 1:1 + h_, 1:1 + w_]   # rows 128 bytes apart
        check("sad", f"{w_}x{h_} strided 2-D views", [sad(s_v, r_v)], [sad_ref(s_v, r_v)],
              f"{tuple(s_v.shape)} strides {s_v.stride()}")
        check("sad_multiref", f"4-way {w_}x{h_} strided views",
              [sad_multiref(s_v, st_ref[:, :h_, :w_])],
              [sad_multiref_ref(s_v, st_ref[:, :h_, :w_])], f"refs {(4, h_, w_)}")
    b10_ref = ctu_mod.tile_frame(yuv_ref0.y, 64).contiguous()
    mr_tiles = ctu_mod.tile_frame(torch.as_tensor(mr_refs_np, device=dev), 64) \
        .transpose(0, 1).contiguous()                                   # (510, 4, 64, 64)
    check("sad", "1080p 510 64x64 blocks", [sad(b_src, b10_ref)], [sad_ref(b_src, b10_ref)],
          "n=510")
    check("sad_multiref", "1080p 510 64x64 blocks, k=4", [sad_multiref(mr_src, mr_tiles)],
          [sad_multiref_ref(mr_src, mr_tiles)], "n=510 k=4")
    check("sad_multiref", "1080p k=4, blocks and references strided views",
          [sad_multiref(mr_src[:, :, :48], mr_tiles[:, :, :, :48])],
          [sad_multiref_ref(mr_src[:, :, :48], mr_tiles[:, :, :, :48])], "n=510 k=4 64x48")

    def check_mc(what, w0, w1, fr, h_, w_, taps):
        """B5 on w0 and B6 on (w0, w1) at fractions fr (xf0, yf0, xf1, yf1)."""
        shape = f"n={w0.shape[0]} {w_}x{h_} taps={taps} strides {w0.stride()}"
        check("pred_uni", what, [mc.pred_uni_batched(w0, fr[0], fr[1], h_, w_, taps)],
              [mc.pred_uni_batched_ref(w0, fr[0], fr[1], h_, w_, taps)], shape)
        check("pred_bi", what, [mc.pred_bi_batched(w0, w1, *fr, h_, w_, taps)],
              [mc.pred_bi_batched_ref(w0, w1, *fr, h_, w_, taps)], shape)

    for taps in (8, 4):
        ph = 4 if taps == 8 else 8
        every = torch.arange(ph * ph, dtype=torch.int32, device=dev)
        xf_all, yf_all = every % ph, every // ph                       # every (xf, yf)
        for w_, h_ in [(64, 64), (32, 16), (16, 16), (8, 4)]:
            w_, h_ = w_ * taps // 8, h_ * taps // 8
            wins = torch.as_tensor(st_rng.integers(
                0, 256, (2, ph * ph, h_ + taps - 1, w_ + taps + 9), dtype=np.uint8), device=dev)
            w0, w1 = wins[0, ..., :w_ + taps - 1], wins[1, ..., :w_ + taps - 1]   # views
            check_mc(f"self-test {taps}-tap {w_}x{h_}, every fraction, windows strided",
                     w0, w1, (xf_all, yf_all, yf_all, xf_all), h_, w_, taps)
            for fr in [(0, 0, 0, 0), (1, 0, 0, 1), (2, 3, 3, 2), (ph - 1, ph - 1, 1, 2)]:
                check("pred_uni", f"self-test {taps}-tap {w_}x{h_} {fr[:2]} 2-D",
                      [mc.pred_uni(w0[0], *fr[:2], taps)],
                      [mc.pred_uni_ref(w0[0], *fr[:2], taps)], f"{tuple(w0[0].shape)}")
                check("pred_bi", f"self-test {taps}-tap {w_}x{h_} {fr} 2-D",
                      [mc.pred_bi(w0[0], w1[0], *fr, taps)],
                      [mc.pred_bi_ref(w0[0], w1[0], *fr, taps)], f"{tuple(w0[0].shape)}")

    def chroma_windows(planes, seed):
        """35x35 windows of every 32x32 block of the chroma planes at MVs in
        [-4, 4]: (1020, 35, 35) for two 544x960 planes."""
        rng_c = np.random.default_rng(seed)
        out = []
        for plane in planes:
            gr_c, gc_c = plane.shape[0] // 32, plane.shape[1] // 32
            mv_c = torch.as_tensor(rng_c.integers(-4, 5, (gr_c * gc_c, 2)), device=dev)
            pos_c = motion.ctu_positions(gr_c, gc_c, 32, dev)
            out.append(motion.extract_windows(ctu_mod.pad_frame(plane, 8, 8, 8, 8),
                                              pos_c + mv_c + 8 - 1, 35))
        return torch.cat(out).contiguous()

    def frac_tensor(n_, ph, seed):
        return torch.as_tensor(np.random.default_rng(seed).integers(0, ph, (n_,)),
                               dtype=torch.int32, device=dev)

    mc_luma = (b16_win, mr_win.contiguous(),
               *(frac_tensor(b16_win.shape[0], 4, 16 + i) for i in range(4)))
    c_w0 = chroma_windows((yuv_ref0.cb, yuv_ref0.cr), 20)
    c_w1 = chroma_windows((yuv_ref1.cb, yuv_ref1.cr), 21)
    mc_chroma = (c_w0, c_w1, *(frac_tensor(c_w0.shape[0], 8, 22 + i) for i in range(4)))
    check_mc("1080p 510 64x64 luma blocks, per-block fractions 0-3", *mc_luma[:2],
             mc_luma[2:], 64, 64, 8)
    check_mc("1080p 1020 32x32 chroma blocks, per-block fractions 0-7", *mc_chroma[:2],
             mc_chroma[2:], 32, 32, 4)
    # chroma_p_fused: both chroma planes of the 1080p frame and of a 4K one
    # at MVs whose windows reach past every edge (R = 32), at the chroma qp
    # of luma qp 35 (qPc 33) and 22.
    cf_rng = np.random.default_rng(23)

    def chroma_mvs(h_c, w_c):
        return torch.as_tensor(cf_rng.integers(-136, 144, (h_c // 32 * (w_c // 32), 2)),
                               dtype=torch.int32, device=dev)

    cf_1080 = (yuv_cur.cb, yuv_cur.cr, yuv_ref0.cb, yuv_ref0.cr, chroma_mvs(H // 2, W // 2))
    cf_4k = (*(torch.as_tensor(cf_rng.integers(0, 256, (H4K // 2, W4K // 2), dtype=np.uint8),
                               device=dev) for _ in range(4)), chroma_mvs(H4K // 2, W4K // 2))
    for what_c, ops_c in (("1080p", cf_1080), ("4K", cf_4k)):
        for qp_c in (35, 22):
            ccfg = EncodeConfig(search_range=SEARCH_RANGE, qp=qp_c)
            check("chroma_p_fused", f"{what_c} 4:2:0 P frame's chroma planes, luma qp {qp_c}",
                  list(chroma_p_fused(*ops_c, ccfg)), list(chroma_p_fused_ref(*ops_c, ccfg)),
                  f"planes {tuple(ops_c[0].shape)}")
    # intra_wave_fused: every wave of the 1080p bench frame and of a random
    # 4K one against intra_wave_ref wave by wave.
    iw_4k = torch.as_tensor(np.random.default_rng(24).integers(0, 256, (H4K, W4K),
                                                               dtype=np.uint8), device=dev)
    for what_i, plane_i in (("1080p bench", cur), ("4K random", iw_4k)):
        for icfg in (EncodeConfig(qp=32), EncodeConfig(qp=22, strong_intra_smoothing=False)):
            check("intra_wave_fused", f"{what_i} I frame's waves, qp {icfg.qp}, strong "
                  f"smoothing {icfg.strong_intra_smoothing}",
                  intra_wave_frame(intra_wave_fused, plane_i, icfg),
                  intra_wave_frame(intra_wave_ref, plane_i, icfg),
                  f"plane {tuple(plane_i.shape)}")
    del iw_4k
    # B18: B15 at base 16 on the structured pan's CTUs, R = 32, 26 PU lists.
    b18 = check("base_layout_decide_fc", "1080p 510 CTUs, R=32, default layouts",
                [base_layout_decide_fc(b_src, p_win, lists16)],
                [base_layout_decide_fc_ref(b_src, p_win, lists16)], f"PUs={len(lists16)}")
    if max_abs_err(b18, [dec16]):
        raise AssertionError("B18 differs from B15 at base 16")
    log("B18 base_layout_decide_fc equals B15 base_layout_decide at base 16")
    # B15 at every base and edge radius (one tile each way; a part last k
    # step), the default lists and three that are no rectangle.
    for base in (8, 16, 32):
        k_b = 64 // base
        lists_b = partition._pu_lists(default_layouts if base <= 16 else default_layouts[:4],
                                      base) + (tuple(i * k_b + i for i in range(k_b)),
                                               (0, k_b * k_b - 1), tuple(range(0, k_b * k_b, 3)))
        for r in (1, 2, 31, 32):
            o = SEARCH_RANGE - r
            win_r = p_win[:64, o:o + 64 + 2 * r, o:o + 64 + 2 * r]
            check_b15(f"R={r}, default and non-rectangular lists", b_src[:64], win_r, base,
                      lists_b)
            check_b14(f"R={r}, 64 CTUs", b_src[:64], win_r, base)

    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the main paths ---------------------------------------------------
    counted = counted_wrappers()
    launches = dict.fromkeys(counted, 0)

    def drive(what, fn, need, exact=False):
        """Run one path with every launch count set to 0 just before it;
        fail unless each kernel in ``need`` ran at least that often (with
        ``exact``, exactly that often, and no other kernel at all)."""
        torch.cuda.synchronize()
        for wrapper in counted.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: wrapper.launches for name, wrapper in counted.items()}
        log(f"{what} launches: {got}")
        if any(got[name] < least for name, least in need.items()):
            raise AssertionError(f"{what}: a kernel of the path was not launched "
                                 f"as often as {need}: {got}")
        if exact and {k: v for k, v in got.items() if v} != need:
            raise AssertionError(f"{what}: launched {got}, not exactly {need}")
        for name in launches:
            launches[name] += got[name]
        return out

    out = drive("luma P path", lambda: encode_inter_frame(cur, ref, cfg),
                {"ssd_grid_plane": 1, "inter_ctu_fused_dma": 1})
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
    on_cpu = encode_inter_frame(cur_s, ref_s, small_cfg, device="cpu")
    e = max_abs_err([on_card[k] for k in keys], [on_cpu[k] for k in keys])
    if e or abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) > 1e-3:
        raise AssertionError("128x192 frame: the card differs from the CPU")
    log("128x192 R=8 frame (odd grid width): card equals the plain path on the CPU")

    def yuv_path(kind, frames, config, tiers=Tier.ALL):
        cur_f, ref0_f, ref1_f = frames
        if kind == "P":
            return encode_inter_frame_yuv(cur_f, ref0_f, config, tiers=tiers)
        return encode_b_frame_yuv(cur_f, ref0_f, ref1_f, config, tiers=tiers)

    def outputs_differ(got, want) -> str:
        """'' when every integer output (a plane, a YuvFrame, a tensor, an
        int) is equal and every PSNR (one, or one a frame) within 1e-3 dB
        (float means summed in other orders), else what differs."""
        if set(got) != set(want):
            return f"keys {sorted(got)} != {sorted(want)}"
        bad = []
        for k in got:
            g, w = got[k], want[k]
            if k.startswith("psnr"):
                same = float((g.cpu() - w.cpu()).abs().max()) <= 1e-3
            elif isinstance(g, torch.Tensor):
                same = not max_abs_err([g], [w])
            elif isinstance(g, tuple):
                same = not max_abs_err(list(g), list(w))
            else:
                same = g == w
            if not same:
                bad.append(k)
        return f"differs in {bad}" if bad else ""

    yuv_frames = (yuv_cur, yuv_ref0, yuv_ref1)
    need = {"P": {"ssd_grid_plane": 1, "inter_ctu_fused_dma": 1, "chroma_p_fused": 1},
            "B": {"ssd_grid_plane": 2, "bi_ctu_fused_dma": 1}}
    int_shapes = {"P": {"mvs": (n, 2), "nnz": ()},
                  "B": {"mvs0": (n, 2), "mvs1": (n, 2), "nnz": ()}}
    for kind in ("P", "B"):
        got = drive(f"yuv {kind} path",
                    lambda: yuv_path(kind, yuv_frames, cfg), need[kind])
        plane_shapes = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
        if [tuple(p.shape) for p in got["recon"]] != plane_shapes \
                or any(p.dtype != torch.uint8 for p in got["recon"]):
            raise AssertionError(f"yuv {kind}: recon planes {got['recon']}")
        for key, shape in int_shapes[kind].items():
            if tuple(got[key].shape) != shape or got[key].dtype != torch.int32:
                raise AssertionError(f"yuv {kind} {key}: {tuple(got[key].shape)} "
                                     f"{got[key].dtype}")
        psnrs = {k: float(v) for k, v in got.items() if k.startswith("psnr")}
        if not all(np.isfinite(v) and got[k].dtype == torch.float32
                   for k, v in psnrs.items()):
            raise AssertionError(f"yuv {kind}: psnr {psnrs}")
        diff = outputs_differ(got, yuv_path(kind, yuv_frames, cfg, Tier.REF))
        if diff:
            raise AssertionError(f"yuv {kind} differs from the plain path on the card: {diff}")
        small_yuv = [YuvFrame(*(torch.as_tensor(p) for p in f))
                     for f in structured_pan(128, 192, seed=5)]
        on_card = yuv_path(kind, [YuvFrame(*(p.to(dev) for p in f)) for f in small_yuv],
                           small_cfg)
        diff = outputs_differ(on_card, yuv_path(kind, small_yuv, small_cfg))
        if diff:
            raise AssertionError(f"128x192 yuv {kind}: the card differs from the CPU: {diff}")
        log(f"yuv {kind} path: {', '.join(f'{k}={v:.4f}' for k, v in psnrs.items())} "
            f"nnz={int(got['nnz'])}; equal to the plain path on the card, and a "
            "128x192 R=8 frame equal to the plain path on the CPU")

    # The RDO P frame on the structured pan's luma: the PU decision at the
    # default layouts (B15 + B13), at all six (B14 + B13) and at R = 16
    # (B8 + B13), the TU-size selection (K1), and both (B15 + B13).
    rdo_cfgs = {
        "pu_decision": EncodeConfig(search_range=SEARCH_RANGE, qp=32, pu_decision=True),
        "pu_amp+8x8": EncodeConfig(search_range=SEARCH_RANGE, qp=32, pu_decision=True,
                                   pu_layouts=tuple(partition.PU_LAYOUTS)),
        "tu_select": EncodeConfig(search_range=SEARCH_RANGE, qp=32, tu_sizes=(4, 8, 16, 32)),
        "pu+tu": EncodeConfig(search_range=SEARCH_RANGE, qp=32, pu_decision=True,
                              tu_sizes=(4, 8, 16, 32)),
        "pu_decision R=16": EncodeConfig(search_range=16, qp=32, pu_decision=True),
    }
    rdo_need = {"pu_decision": {"base_layout_decide": 1, "refine_qpel_costmap_dma": 1},
                "pu_amp+8x8": {"base_grids_ctu": 1, "refine_qpel_costmap_dma": 1},
                "tu_select": {"ssd_grid_plane": 1},
                "pu+tu": {"base_layout_decide": 1, "refine_qpel_costmap_dma": 1},
                "pu_decision R=16": {"ssd_grid": 1, "refine_qpel_costmap_dma": 1}}
    small_pan = structured_pan(128, 192, seed=5)
    for name, need_rdo in rdo_need.items():
        rcfg = rdo_cfgs[name]
        got = drive(f"RDO P path ({name})",
                    lambda: encode_inter_frame(yuv_cur.y, yuv_ref0.y, rcfg), need_rdo)
        rdo_shapes = {"recon": ((H, W), torch.uint8), "mvs": ((n, 2), torch.int32),
                      "sad": ((n,), torch.int32), "nnz": ((), torch.int32),
                      "psnr_db": ((), torch.float32)}
        if rcfg.pu_decision:
            rdo_shapes["pu_layout"] = ((n,), torch.int32)
        if rcfg.tu_sizes:
            rdo_shapes["tu_choice"] = ((n,), torch.int32)
        if set(got) != set(rdo_shapes) or any(
                (tuple(got[k].shape), got[k].dtype) != v for k, v in rdo_shapes.items()):
            raise AssertionError(f"RDO {name}: {[(k, tuple(v.shape), v.dtype) for k, v in got.items()]}")
        psnr = float(got["psnr_db"])
        if not np.isfinite(psnr):
            raise AssertionError(f"RDO {name}: psnr_db {psnr} is not finite")
        plain = encode_inter_frame(yuv_cur.y, yuv_ref0.y, rcfg, tiers=Tier.REF)
        keys_rdo = [k for k in rdo_shapes if k != "psnr_db"]
        e = max_abs_err([got[k] for k in keys_rdo], [plain[k] for k in keys_rdo])
        if e or abs(psnr - float(plain["psnr_db"])) > 1e-3:
            raise AssertionError(f"RDO {name} differs from the plain path on the card: {e}")
        radii = sorted({8, rcfg.search_range})
        for r_small in radii:
            cfg_small = dataclasses.replace(rcfg, search_range=r_small)
            s_cur, s_ref = (torch.as_tensor(f[0]) for f in small_pan[:2])
            on_card = encode_inter_frame(s_cur.to(dev), s_ref.to(dev), cfg_small)
            on_cpu = encode_inter_frame(s_cur, s_ref, cfg_small)
            e = max_abs_err([on_card[k] for k in keys_rdo], [on_cpu[k] for k in keys_rdo])
            if e or abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) > 1e-3:
                raise AssertionError(f"128x192 RDO {name} R={r_small}: the card differs "
                                     "from the CPU")
        chosen = []
        for key, names in (("pu_layout", rcfg.pu_layouts), ("tu_choice", rcfg.tu_sizes)):
            if key in got:
                counts = torch.bincount(got[key].long(), minlength=len(names))
                chosen.append(f"{key} {dict(zip(names, counts.tolist()))}")
        log(f"RDO P path ({name}): psnr_db={psnr:.4f} nnz={int(got['nnz'])} "
            f"{'; '.join(chosen)}; equal to the plain path on the card, and 128x192 "
            f"frames at R={' and R='.join(map(str, radii))} equal to the plain path on "
            "the CPU")

    # The unpruned oracle, partition.select_pu_layout, scores its grids in
    # B8 and refines every layout through B12; its selected result must
    # equal the pruned decision's.
    lam = partition.mv_lambda(32)
    oracle = drive("RDO oracle select_pu_layout (default layouts)",
                   lambda: partition.select_pu_layout(
                       b_src, p_padded, pos, p_win, SEARCH_RANGE, lam, default_layouts,
                       ssd_grid, costmap_fn=refine_qpel_costmap),
                   {"ssd_grid": 1, "refine_qpel_costmap": 1})
    pruned = partition.select_pu_layout_pruned(b_src, p_padded, pos, p_win, SEARCH_RANGE, lam,
                                               default_layouts, ssd_grid, grid=grid)
    e = max_abs_err([oracle[0], oracle[1], oracle[3]], [pruned[0], pruned[1], pruned[3]])
    if e:
        raise AssertionError(f"select_pu_layout differs from select_pu_layout_pruned: {e}")
    log("RDO oracle: pred, choice and best64 equal to the pruned decision's")
    # B18 is B15 at base 16; the PU decision takes it through its decide_fn
    # hook (at the default layouts and R = 32 every decision is base 16),
    # as hevcasm_tpu offered the fine/coarse kernel as an alternative
    # decide kernel.  The result must equal the decision through B15.
    fc_pruned = drive("RDO PU decision with B18 as decide_fn",
                      lambda: partition.select_pu_layout_pruned(
                          b_src, p_padded, pos, p_win, SEARCH_RANGE, lam, default_layouts,
                          ssd_grid, grid=grid,
                          decide_fn=lambda s_, w_, base, lists: base_layout_decide_fc(
                              s_, w_, lists)),
                      {"base_layout_decide_fc": 1, "refine_qpel_costmap_dma": 1}, exact=True)
    e = max_abs_err(fc_pruned, pruned)
    if e:
        raise AssertionError(f"the PU decision through B18 differs from B15's: {e}")
    log("RDO PU decision through B18: equal to the decision through B15")

    # The multi-reference P frame on the multiref pan, and the luma P frame
    # under the fused inter_impl values (B16) on bench content.
    def differs(got, want) -> str:
        """'' when every integer output is equal and psnr_db within 1e-3
        dB, else what differs."""
        if set(got) != set(want):
            return f"keys {sorted(got)} != {sorted(want)}"
        ints = [k for k in got if k != "psnr_db"]
        e = max_abs_err([got[k] for k in ints], [want[k] for k in ints])
        far = abs(float(got["psnr_db"]) - float(want["psnr_db"])) > 1e-3
        return f"max_abs_err {e}, psnr_db {float(got['psnr_db'])} vs " \
            f"{float(want['psnr_db'])}" if e or far else ""

    mr_refs = torch.as_tensor(mr_refs_np, device=dev)
    extra_paths = {
        "multiref k=4 fused_dma": (
            lambda config, tiers=Tier.ALL: encode_inter_frame_multiref(
                mr_cur, mr_refs, config, tiers=tiers),
            EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_dma"),
            {"ssd_grid_plane_multi": 1, "inter_ctu_fused_dma": 1}),
        "multiref k=2 fused_refine+pallas": (
            lambda config, tiers=Tier.ALL: encode_inter_frame_multiref(
                mr_cur, mr_refs[:2], config, tiers=tiers),
            EncodeConfig(search_range=SEARCH_RANGE, qp=32, fused_refine=True,
                         residual_impl="pallas"),
            {"ssd_grid_plane_multi": 1, "refine_quarter_pel_fused": 1,
             "residual_pipeline_ctu": 1}),
        "luma P fused": (
            lambda config, tiers=Tier.ALL: encode_inter_frame(cur, ref, config, tiers=tiers),
            EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused"),
            {"ssd_grid_plane": 1, "inter_ctu_fused": 1}),
        "luma P fused_batched": (
            lambda config, tiers=Tier.ALL: encode_inter_frame(cur, ref, config, tiers=tiers),
            EncodeConfig(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_batched"),
            {"ssd_grid_plane": 1, "inter_ctu_fused": 1}),
    }
    small_mr = multiref_pan(128, 192)
    for name, (run, pcfg, need_p) in extra_paths.items():
        got = drive(f"{name} path", lambda: run(pcfg), need_p)
        want_shapes = {"recon": ((H, W), torch.uint8), "mvs": ((n, 2), torch.int32),
                       "nnz": ((), torch.int32), "psnr_db": ((), torch.float32)}
        want_shapes.update({"ref_idx": ((n,), torch.int32)} if "multiref" in name
                           else {"sad": ((n,), torch.int32)})
        if set(got) != set(want_shapes) or any(
                (tuple(got[k].shape), got[k].dtype) != v for k, v in want_shapes.items()):
            raise AssertionError(f"{name}: {[(k, tuple(v.shape), v.dtype) for k, v in got.items()]}")
        if not np.isfinite(float(got["psnr_db"])):
            raise AssertionError(f"{name}: psnr_db is not finite")
        diff = differs(got, run(pcfg, Tier.REF))
        if diff:
            raise AssertionError(f"{name} differs from the plain path on the card: {diff}")
        small_cfg_p = dataclasses.replace(pcfg, search_range=8)
        if "multiref" in name:
            k_p = 4 if "k=4" in name else 2
            s_cur, s_refs = small_mr[0], small_mr[1][:k_p]
            on_card = encode_inter_frame_multiref(torch.as_tensor(s_cur, device=dev),
                                                  s_refs, small_cfg_p)
            on_cpu = encode_inter_frame_multiref(s_cur, s_refs, small_cfg_p, device="cpu")
            hist = torch.bincount(got["ref_idx"].long(), minlength=k_p).tolist()
            if sum(c > 0 for c in hist) < 2:
                raise AssertionError(f"{name}: ref_idx uses one reference only: {hist}")
            chosen = f"ref_idx histogram {hist}"
        else:
            on_card = encode_inter_frame(torch.as_tensor(cur_s, device=dev), ref_s, small_cfg_p)
            on_cpu = encode_inter_frame(cur_s, ref_s, small_cfg_p, device="cpu")
            chosen = f"share of CTUs at mv (8, 12) qpel=" \
                f"{float((got['mvs'] == torch.tensor([8, 12], device=dev)).all(-1).float().mean()):.4f}"
        diff = differs(on_card, on_cpu)
        if diff:
            raise AssertionError(f"128x192 {name}: the card differs from the CPU: {diff}")
        log(f"{name} path: psnr_db={float(got['psnr_db']):.4f} nnz={int(got['nnz'])} "
            f"{chosen}; equal to the plain path on the card, and a 128x192 R=8 frame equal "
            "to the plain path on the CPU")

    # The search configurations: the luma P frame on bench content, the PU
    # decision on the structured pan's luma, the B frame on the structured
    # pan; each must launch exactly its kernels.
    def search_path(kind):
        def run(config, tiers=Tier.ALL, small=False):
            if kind == "luma":
                frames = (cur_s, ref_s) if small else (cur, ref)
                return encode_inter_frame(*frames, config, tiers=tiers,
                                          device="cpu" if small else None)
            if kind == "rdo":
                frames = [torch.as_tensor(f[0]) for f in small_pan[:2]] if small else \
                    (yuv_cur.y, yuv_ref0.y)
                return encode_inter_frame(*frames, config, tiers=tiers)
            frames = small_yuv_cpu if small else yuv_frames
            return encode_b_frame_yuv(*frames, config, tiers=tiers)
        return run

    small_yuv_cpu = [YuvFrame(*(torch.as_tensor(p) for p in f))
                     for f in structured_pan(128, 192, seed=5)]
    fused = dict(search_range=SEARCH_RANGE, qp=32, inter_impl="fused_dma")
    search_paths = {
        "luma P search_impl=dma": ("luma", EncodeConfig(**fused, search_impl="dma"),
                                   {"search_mv_dma": 1, "inter_ctu_fused_dma": 1}),
        "luma P search_impl=mv": ("luma", EncodeConfig(**fused, search_impl="mv"),
                                  {"search_mv": 1, "inter_ctu_fused_dma": 1}),
        "luma P mega": ("luma", EncodeConfig(search_range=SEARCH_RANGE, qp=32,
                                             inter_impl="mega"), {"encode_ctu_mega": 1}),
        "luma P sad": ("luma", EncodeConfig(**fused, me_metric="sad"),
                       {"sad_grid": 1, "inter_ctu_fused_dma": 1}),
        "luma P pyramid": ("luma", EncodeConfig(**fused, me_strategy="pyramid"),
                           {"ssd_grid": 2, "inter_ctu_fused_dma": 1}),
        "luma P pyramid sad": ("luma", EncodeConfig(**fused, me_strategy="pyramid",
                                                    me_metric="sad"),
                               {"sad_grid": 2, "inter_ctu_fused_dma": 1}),
        "RDO pu_decision sad": ("rdo", EncodeConfig(search_range=SEARCH_RANGE, qp=32,
                                                    pu_decision=True, me_metric="sad"),
                                {"sad_grid": 1, "refine_qpel_costmap_dma": 1}),
        "yuv B sad": ("B", EncodeConfig(**fused, me_metric="sad"),
                      {"sad_grid": 1, "bi_ctu_fused_dma": 1}),
    }
    for name, (kind, pcfg, need_p) in search_paths.items():
        run = search_path(kind)
        got = drive(f"{name} path", lambda: run(pcfg), need_p, exact=True)
        check_out = outputs_differ if kind == "B" else differs
        recon = got["recon"][0] if kind == "B" else got["recon"]
        mvs = got["mvs0"] if kind == "B" else got["mvs"]
        if tuple(recon.shape) != (H, W) or recon.dtype != torch.uint8 \
                or tuple(mvs.shape) != (n, 2) or mvs.dtype != torch.int32:
            raise AssertionError(f"{name}: recon {tuple(recon.shape)} {recon.dtype}, "
                                 f"mvs {tuple(mvs.shape)} {mvs.dtype}")
        psnrs = [float(v) for k, v in got.items() if k.startswith("psnr")]
        if not all(np.isfinite(v) for v in psnrs):
            raise AssertionError(f"{name}: psnr {psnrs} is not finite")
        diff = check_out(got, run(pcfg, Tier.REF))
        if diff:
            raise AssertionError(f"{name} differs from the plain path on the card: {diff}")
        # search_impl "mv"/"dma" cover R = 32 only (EncodeConfig's guard).
        small_cfg_p = pcfg if pcfg.search_impl in ("mv", "dma") else \
            dataclasses.replace(pcfg, search_range=8)
        on_cpu = run(small_cfg_p, small=True)
        if kind == "B":
            on_card = encode_b_frame_yuv(*[YuvFrame(*(p.to(dev) for p in f))
                                           for f in small_yuv_cpu], small_cfg_p)
        elif kind == "rdo":
            on_card = encode_inter_frame(*[torch.as_tensor(f[0], device=dev)
                                           for f in small_pan[:2]], small_cfg_p)
        else:
            on_card = encode_inter_frame(torch.as_tensor(cur_s, device=dev), ref_s, small_cfg_p)
        diff = check_out(on_card, on_cpu)
        if diff:
            raise AssertionError(f"128x192 {name}: the card differs from the CPU: {diff}")
        log(f"{name} path: psnr {', '.join(f'{v:.4f}' for v in psnrs)} "
            f"nnz={int(got['nnz'])}; equal to the plain path on the card, and a 128x192 "
            f"R={small_cfg_p.search_range} frame equal to the plain path on the CPU")

    # The self-test, python -m hevcasm_tpu_torch's path: every suite on the
    # card, REF golden, KERNEL compared bit for bit.  Each KERNEL op must
    # launch its kernel exactly once a case of its suites (a count of 0 would
    # mean the fixtures stayed on the CPU and the plain version ran).
    st_need = {"sad": 23, "sad_multiref": 23, "sad_grid": 3, "ssd_grid": 3, "pred_uni": 32,
               "pred_bi": 4, "refine_quarter_pel_fused": 2, "residual_pipeline_ctu": 2,
               "chroma_p_fused": 2}
    st_errors = drive("self-test (selftest.main, time_it=False)",
                      lambda: selftest.main(time_it=False), st_need, exact=True)
    if st_errors:
        raise AssertionError(f"self-test on the card: {st_errors} errors")
    log("self-test path: 0 errors, each KERNEL op launched once a case")

    # The rate-controlled GOP (encode.rate), qp on the card from the first
    # frame to the last: T = 9 frames of the rate tests' clip at 1080p, the
    # target between frame 1's bits at qp 38 and at qp 22, qp0 = 40.  Each
    # GOP loop runs under torch.cuda.set_sync_debug_mode("error") (no host
    # read of the card) and launches exactly its kernels; the one read of
    # the range flag follows it.
    rc_frames = torch.as_tensor(rate_clip(9, H, W, 12), device=dev)
    rc_cfgs = {"IPPP fused_dma": (cfg, False, {"ssd_grid_plane": 8, "inter_ctu_fused_dma": 8}),
               "IPPP fused": (dataclasses.replace(cfg, inter_impl="fused"), False,
                              {"ssd_grid_plane": 8, "inter_ctu_fused": 8}),
               "IPPP stages fused_refine": (
                   dataclasses.replace(cfg, inter_impl="stages", fused_refine=True), False,
                   {"ssd_grid_plane": 8, "refine_quarter_pel_fused": 8}),
               "IBPBP fused_dma": (cfg, True, {"ssd_grid_plane": 12, "inter_ctu_fused_dma": 4,
                                               "bi_ctu_fused_dma": 4})}
    rc_bits = [int(rate.encode_inter_frame_traced_qp(rc_frames[1], rc_frames[0], q, cfg)["bits"])
               for q in (38, 22)]
    rc_target = int(np.sqrt(max(rc_bits[0], 1) * max(rc_bits[1], 1)))
    log(f"rate control: 1080p, T = 9, frame 1's bits {rc_bits[0]} at qp 38 and {rc_bits[1]} "
        f"at qp 22, target {rc_target} bits a frame, qp0 = 40")
    device_q_wrappers = {"inter_ctu_fused_dma": inter_ctu_fused_dma,
                         "inter_ctu_fused": inter_ctu_fused, "bi_ctu_fused_dma": bi_ctu_fused_dma}

    def gop_loop(rc_cfg, b_frames, flag):
        target = torch.full((), float(rc_target), dtype=torch.float32, device=dev)
        qp0 = torch.full((), 40, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return rate._gop_rc_body(rc_frames, target, qp0, rc_cfg, 10, 49, b_frames,
                                     Tier.ALL, flag)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    for name, (rc_cfg, b_frames, need) in rc_cfgs.items():
        flag = range_flag(dev)
        for wrapper in device_q_wrappers.values():
            wrapper.device_q_launches = 0
        out = drive(f"rate-controlled GOP {name}", lambda: gop_loop(rc_cfg, b_frames, flag),
                    need, exact=True)
        raise_on_flag(flag)
        q_got = {k: w.device_q_launches for k, w in device_q_wrappers.items() if k in need}
        if q_got != {k: need[k] for k in q_got}:
            raise AssertionError(f"GOP {name}: device-q launches {q_got}, not {need}")
        entry = rate.encode_gop_rate_controlled(rc_frames, rc_target, 40, rc_cfg,
                                                b_frames=b_frames)
        plain = rate.encode_gop_rate_controlled(rc_frames, rc_target, 40, rc_cfg,
                                                b_frames=b_frames, tiers=Tier.REF)
        for want, whose in ((entry, "the entry point's"), (plain, "the plain path's")):
            e = max_abs_err([out[k] for k in ("recon", "bits", "qp")],
                            [want[k] for k in ("recon", "bits", "qp")])
            d_psnr = float((out["psnr_db"] - want["psnr_db"]).abs().max())
            if e or d_psnr > 1e-3:
                raise AssertionError(f"GOP {name} differs from {whose}: {e}, psnr {d_psnr}")
        qps, bits = out["qp"].tolist(), out["bits"].tolist()
        # Frames 4-8: IPPP's bits[3:], IBPBP's pairs (3, 4), (5, 6), (7, 8)
        # against twice the target.
        per = 2 if b_frames else 1
        settled = bits[3 // per:]
        if all(q == 40 for q in qps) or not all(
                per * rc_target / 2.5 < b < per * rc_target * 2.5 for b in settled):
            raise AssertionError(f"GOP {name}: qp {qps}, bits {bits} against {rc_target}")
        first = 1 if not b_frames else 2
        fixed = encode_inter_frame(rc_frames[first], rc_frames[0],
                                   dataclasses.replace(rc_cfg, qp=40))
        if not torch.equal(out["recon"][first - 1], fixed["recon"]):
            raise AssertionError(f"GOP {name}: frame {first} differs from encode_inter_frame "
                                 "at qp 40")
        log(f"rate-controlled GOP {name}: qp {qps}, bits {bits} (target {rc_target}"
            f"{' a frame, twice that a B/P pair' if b_frames else ''}), psnr_db "
            f"{[round(v, 4) for v in out['psnr_db'].tolist()]}; no host read in the loop; "
            "equal to the entry point and the plain path on the card; frame "
            f"{first} equal to encode_inter_frame at qp 40")
    for name in ("IPPP fused_dma", "IPPP stages fused_refine"):
        try:
            rate.encode_gop_rate_controlled(rc_frames[:3], rc_target, 60, rc_cfgs[name][0],
                                            qp_min=55, qp_max=70)
        except ValueError as exc:
            if "outside" not in str(exc):
                raise
            log(f"rate-controlled GOP {name} at qp0 60 in [55, 70] raises: {exc}")
        else:
            raise AssertionError(f"GOP {name}: qp 60 did not raise")

    # Intra frames on bench content and the structured pan at 1080p, qp 32,
    # intra_block 32: the open-loop frames launch no registry kernel (the n
    # = 32 mode decision is float64 matrix products, the residual plain
    # torch); the wavefront frame one intra_wave_fused a wave (126), under
    # set_sync_debug_mode("error"): no host read.
    intra_cfg = EncodeConfig(qp=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    intra = drive("I frame (open loop)", lambda: encode_intra_frame(cur, intra_cfg), {},
                  exact=True)
    intra_peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    m_blocks = (H // 32) * (W // 32)
    for key, shape, dtype in (("recon", (H, W), torch.uint8), ("modes", (m_blocks,), torch.int32),
                              ("nnz", (), torch.int32), ("psnr_db", (), torch.float32)):
        if tuple(intra[key].shape) != shape or intra[key].dtype != dtype:
            raise AssertionError(f"I frame {key}: {tuple(intra[key].shape)} {intra[key].dtype}")
    modes_used = int(torch.unique(intra["modes"]).numel())
    if modes_used <= 4 or not np.isfinite(float(intra["psnr_db"])):
        raise AssertionError(f"I frame: {modes_used} modes, psnr {float(intra['psnr_db'])}")
    _, wf_first_reads = host_reads(lambda: encode_intra_frame_wavefront(cur, intra_cfg))
    wavefront = drive("I frame (wavefront, no host read)", lambda: without_host_read(
        lambda: encode_intra_frame_wavefront(cur, intra_cfg)), {"intra_wave_fused": WAVES_1080P},
        exact=True)
    intra_yuv = drive("yuv I frame", lambda: encode_intra_frame_yuv(yuv_cur, intra_cfg), {},
                      exact=True)
    small_i = YuvFrame(*(torch.as_tensor(p) for p in structured_pan(128, 192, seed=5)[0]))
    for what, fn, frame, small, got in (
            ("I frame", encode_intra_frame, cur, small_i.y, intra),
            ("wavefront I frame", encode_intra_frame_wavefront, cur, small_i.y, wavefront),
            ("yuv I frame", encode_intra_frame_yuv, yuv_cur, small_i, intra_yuv)):
        diff = outputs_differ(got, fn(frame, intra_cfg, Tier.REF))
        if diff:
            raise AssertionError(f"{what} differs from the plain path on the card: {diff}")
        small_card = (small.to(dev) if isinstance(small, torch.Tensor)
                      else YuvFrame(*(p.to(dev) for p in small)))
        diff = outputs_differ(fn(small_card, intra_cfg), fn(small, intra_cfg))
        if diff:
            raise AssertionError(f"128x192 {what}: the card differs from the CPU: {diff}")
    log(f"I frame (open loop): {modes_used} distinct modes, psnr_db "
        f"{float(intra['psnr_db']):.4f}, nnz {int(intra['nnz'])}, no registry kernel, peak "
        f"memory {intra_peak_mb:.1f} MiB above the inputs; wavefront I frame: psnr_db "
        f"{float(wavefront['psnr_db']):.4f}, nnz {int(wavefront['nnz'])}, "
        f"intra_wave_fused x{WAVES_1080P}, no host read "
        f"({wf_first_reads} on its first call, which builds the wave tables); yuv I frame: "
        f"psnr_y {float(intra_yuv['psnr_y']):.4f}, nnz {int(intra_yuv['nnz'])}; each equal "
        "to the plain path on the card, and at 128x192 to the CPU")

    # The GOPs: 5 frames of the rate clip at 1080p with chroma planes from
    # the seed, fused_dma, R = 32.  Each must launch exactly its kernels,
    # equal its plain path on the card (the closed-loop ones also the
    # per-frame entry points chained on reconstructions) and, on a 128x192
    # clip at R = 8, the CPU.  Host reads in each are counted.
    def gop_clip(t, h, w, seed):
        return YuvFrame(*(torch.as_tensor(rate_clip(t, hh, ww, 12, seed + k), device=dev)
                          for k, (hh, ww) in enumerate(((h, w), (h // 2, w // 2),
                                                        (h // 2, w // 2)))))

    gop_frames = gop_clip(5, H, W, 0)
    wf_cfg = dataclasses.replace(cfg, intra_mode="wavefront")
    ippp = {"ssd_grid_plane": 4, "inter_ctu_fused_dma": 4}
    ibpbp = {"ssd_grid_plane": 6, "inter_ctu_fused_dma": 2, "bi_ctu_fused_dma": 2}
    # The 4:2:0 GOPs' P frames code their chroma in chroma_p_fused, and a
    # wavefront I frame its waves in intra_wave_fused.
    ippp_yuv, ibpbp_yuv = {**ippp, "chroma_p_fused": 4}, {**ibpbp, "chroma_p_fused": 2}
    waves = {"intra_wave_fused": WAVES_1080P}
    gops = {
        "encode_gop": (lambda f, c, t=Tier.ALL: encode_gop(f.y, c, t), cfg, ippp),
        "encode_gop wavefront": (lambda f, c, t=Tier.ALL: encode_gop(f.y, c, t), wf_cfg,
                                 {**ippp, **waves}),
        "encode_gop_yuv IPPP": (lambda f, c, t=Tier.ALL: encode_gop_yuv(f, c, tiers=t), cfg,
                                ippp_yuv),
        "encode_gop_yuv IBPBP": (lambda f, c, t=Tier.ALL: encode_gop_yuv(f, c, True, t), cfg,
                                 ibpbp_yuv),
        "encode_gop_closed_loop": (
            lambda f, c, t=Tier.ALL: encode_gop_closed_loop(f.y, c, f.y.shape[0], t), cfg,
            {**ippp, **waves}),
        "encode_gop_closed_loop_yuv": (
            lambda f, c, t=Tier.ALL: encode_gop_closed_loop_yuv(f, c, t), cfg,
            {**ippp_yuv, **waves}),
        "encode_gop_closed_loop_yuv_b": (
            lambda f, c, t=Tier.ALL: encode_gop_closed_loop_yuv_b(f, c, t), cfg,
            {**ibpbp_yuv, **waves})}

    def chained(name, f, c):
        """The closed-loop GOP composed from the per-frame entry points."""
        at = [YuvFrame(*(p[t] for p in f)) for t in range(f.y.shape[0])]
        i_y = encode_intra_frame_wavefront(at[0].y, c)
        if name == "encode_gop_closed_loop":
            recs, psnrs = [i_y["recon"]], [i_y["psnr_db"]]
            for fr in at[1:]:
                out = encode_inter_frame(fr.y, recs[-1], c)
                recs.append(out["recon"])
                psnrs.append(out["psnr_db"])
            return {"recon": torch.stack(recs), "psnr_db": torch.stack(psnrs)}
        i_c = encode_intra_frame_yuv(at[0], c)["recon"]
        recs, psnrs = [YuvFrame(i_y["recon"], i_c.cb, i_c.cr)], [i_y["psnr_db"]]
        if name == "encode_gop_closed_loop_yuv":
            for fr in at[1:]:
                out = encode_inter_frame_yuv(fr, recs[-1], c)
                recs.append(out["recon"])
                psnrs.append(out["psnr_y"])
        else:
            for t in range(1, len(at), 2):
                p_out = encode_inter_frame_yuv(at[t + 1], recs[-1], c)
                b_out = encode_b_frame_yuv(at[t], recs[-1], p_out["recon"], c)
                recs += [b_out["recon"], p_out["recon"]]
                psnrs += [b_out["psnr_y"], p_out["psnr_y"]]
        return {"recon": YuvFrame(*(torch.stack(p) for p in zip(*recs))),
                "psnr_y": torch.stack(psnrs)}

    gop_reads = {}
    for name, (run, gcfg, need) in gops.items():
        got, gop_reads[name] = drive(f"GOP {name}", lambda: host_reads(
            lambda: run(gop_frames, gcfg)), need, exact=True)
        recon_y = got["recon"].y if isinstance(got["recon"], tuple) else got["recon"]
        if tuple(recon_y.shape) != (5, H, W) or recon_y.dtype != torch.uint8:
            raise AssertionError(f"GOP {name}: recon {tuple(recon_y.shape)} {recon_y.dtype}")
        psnr_key = "psnr_y" if "psnr_y" in got else "psnr_db"
        if not bool(torch.isfinite(got[psnr_key]).all()):
            raise AssertionError(f"GOP {name}: psnr {got[psnr_key]}")
        wants = [("the plain path on the card", run(gop_frames, gcfg, Tier.REF))]
        if "closed" in name:
            wants.append(("the per-frame entry points chained",
                          chained(name, gop_frames, gcfg)))
        for whose, want in wants:
            diff = outputs_differ(got, want)
            if diff:
                raise AssertionError(f"GOP {name} differs from {whose}: {diff}")
        t_small = 5 if name.endswith(("IBPBP", "_b")) else 3
        small_gop = gop_clip(t_small, 128, 192, 5)
        small_cfg_g = dataclasses.replace(small_cfg, intra_mode=gcfg.intra_mode)
        diff = outputs_differ(run(small_gop, small_cfg_g),
                           run(YuvFrame(*(p.cpu() for p in small_gop)), small_cfg_g))
        if diff:
            raise AssertionError(f"128x192 GOP {name}: the card differs from the CPU: {diff}")
        log(f"GOP {name}: {psnr_key} {[round(v, 4) for v in got[psnr_key].reshape(-1).tolist()]}"
            + (f", nnz {got['nnz']}" if "nnz" in got else "") + f"; {gop_reads[name]} host "
            f"reads; equal to {' and '.join(w for w, _ in wants)}, and at 128x192 "
            f"(T = {t_small}) to the CPU")

    # The CLI: python -m hevcasm_tpu_torch encode on the card against the
    # same command on the CPU, and a Y4M round trip through --input and
    # --output against encode_gop_yuv.
    cli_args = ["encode", "--frames", "3", "--width", "640", "--height", "384"]
    proc = subprocess.run([sys.executable, "-m", "hevcasm_tpu_torch", *cli_args],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the encode CLI failed: {proc.stdout}{proc.stderr}")
    card_json = json.loads(proc.stdout.strip().splitlines()[-1])
    out_buf = io.StringIO()
    with contextlib.redirect_stdout(out_buf):
        if cli.main([*cli_args, "--device", "cpu"]):
            raise AssertionError("the encode CLI failed on the CPU")
    cpu_json = json.loads(out_buf.getvalue().strip().splitlines()[-1])
    if card_json["nnz"] != cpu_json["nnz"] or abs(card_json["psnr_db"]
                                                  - cpu_json["psnr_db"]) > 1e-3:
        raise AssertionError(f"encode CLI: card {card_json} against the CPU {cpu_json}")
    log(f"encode CLI on the card: {json.dumps(card_json)}; nnz equal to the CPU's, psnr_db "
        f"within 1e-3 dB ({cpu_json['psnr_db']:.6f})")
    with tempfile.TemporaryDirectory() as tmp:
        src_y4m, rec_y4m = Path(tmp) / "in.y4m", Path(tmp) / "rec.y4m"
        planes = [p.cpu().numpy() for p in gop_frames]
        yuv_io.write_y4m(src_y4m, [yuv_io.YuvArrays(*(p[t] for p in planes))
                                   for t in range(3)], W, H)
        out_buf = io.StringIO()
        with contextlib.redirect_stdout(out_buf):
            if cli.main(["encode", "--input", str(src_y4m), "--output", str(rec_y4m)]):
                raise AssertionError("the encode CLI failed on a Y4M file")
        y4m_json = json.loads(out_buf.getvalue().strip().splitlines()[-1])
        back = list(yuv_io.iter_frames(rec_y4m))
        want = encode_gop_yuv(YuvFrame(*(p[:3] for p in gop_frames)),
                              EncodeConfig(qp=32, search_range=16))
        e = max_abs_err([torch.as_tensor(np.stack(p)) for p in zip(*back)],
                        [p.cpu() for p in want["recon"]])
        if e or len(back) != 3 or y4m_json["nnz"] != want["nnz"]:
            raise AssertionError(f"Y4M round trip: max_abs_err {e}, {len(back)} frames, "
                                 f"{y4m_json} against nnz {want['nnz']}")
    log(f"encode CLI, Y4M round trip ({yuv_io.last_path} reader): {json.dumps(y4m_json)}; "
        "the reconstruction read back equals encode_gop_yuv's")

    # ---- 5. multi ------------------------------------------------------------
    multi_phase(tag, dev, cfg, drive, launches)

    # ---- 6. timing -----------------------------------------------------------
    log("timed self-test (best of each case's iters, CUDA events):")
    if selftest.main(time_it=True):
        raise AssertionError("timed self-test: errors")
    ms_main = median_ms(lambda: encode_inter_frame(cur, ref, cfg))
    ms_chain = median_ms(lambda: encode_inter_frame(cur, ref, cfg), calls=REPS)
    ms_plain = median_ms(lambda: encode_inter_frame(cur, ref, cfg, tiers=Tier.REF))
    log(f"{tag} main path: {ms_main:.3f} ms/frame, {n / ms_main * 1e3:.0f} CTU/s "
        f"per frame; {ms_chain:.3f} ms/frame, {n / ms_chain * 1e3:.0f} CTU/s "
        f"with {REPS} frames back to back (plain path: {ms_plain:.3f} ms/frame, "
        f"{n / ms_plain * 1e3:.0f} CTU/s)")
    for kind in ("P", "B"):
        ms_k = median_ms(lambda: yuv_path(kind, yuv_frames, cfg))
        ms_p = median_ms(lambda: yuv_path(kind, yuv_frames, cfg, Tier.REF))
        log(f"{tag} yuv {kind} path: {ms_k:.3f} ms/frame, {n / ms_k * 1e3:.0f} CTU/s "
            f"per frame (plain path: {ms_p:.3f} ms/frame, {n / ms_p * 1e3:.0f} CTU/s)")
    # The rate-controlled IPPP GOP (fused_dma) in turns with a closed loop of
    # fixed-qp encode_inter_frame calls over the same frames; a sample is a
    # whole GOP of 8 coded frames, synchronised at its end.
    fixed_cfg = dataclasses.replace(cfg, qp=40)

    def fixed_loop():
        prev = rc_frames[0]
        for cur_f in rc_frames[1:]:
            prev = encode_inter_frame(cur_f, prev, fixed_cfg)["recon"]

    gop_turns = turns_samples_ms(
        {"GOP": lambda: rate.encode_gop_rate_controlled(rc_frames, rc_target, 40, cfg),
         "fixed": fixed_loop}, calls=1)
    for name, what in (("GOP", "rate-controlled IPPP GOP (fused_dma)"),
                       ("fixed", "fixed-qp encode_inter_frame loop (qp 40)")):
        v = [t / 8 for t in gop_turns[name]]
        log(f"{tag} {what}: {statistics.median(v):.3f} ms/frame (min {v[0]:.3f}, max "
            f"{v[-1]:.3f} over {REPS} samples of 8 frames, in turns)")
    # Intra frames and the GOPs at 1080p: ms a frame (CUDA events, min,
    # median and max), the n = 32 mode decision's device time (its float64
    # products, and the whole decision beside the residual), and
    # torch.profiler's busy share and kernel launches over a wavefront frame
    # and a closed-loop yuv GOP.
    for what, fn, reps in (
            ("I frame (open loop)", lambda: encode_intra_frame(cur, intra_cfg), REPS),
            ("wavefront I frame", lambda: encode_intra_frame_wavefront(cur, intra_cfg), 10),
            ("yuv I frame", lambda: encode_intra_frame_yuv(yuv_cur, intra_cfg), REPS)):
        v = samples_ms(fn, reps=reps)
        log(f"{tag} {what}: {statistics.median(v):.3f} ms/frame (min {v[0]:.3f}, max "
            f"{v[-1]:.3f} over {reps} samples)")
    for name, (run, gcfg, _) in gops.items():
        v = [t / 5 for t in samples_ms(lambda: run(gop_frames, gcfg), reps=5)]
        log(f"{tag} GOP {name}: {statistics.median(v):.3f} ms/frame (min {v[0]:.3f}, max "
            f"{v[-1]:.3f} over 5 samples of 5 frames); {gop_reads[name]} host reads a GOP")
    blocks32 = ctu_mod.tile_frame(cur, 32)
    refs32 = _prepare_intra_refs(*_intra_neighbours(cur, 32), 32, intra_cfg)
    pred32, _ = _intra_mode_decide(blocks32, *refs32, 32)

    def decide():
        return _intra_mode_decide(blocks32, *refs32, 32)

    def residual():
        return _residual_pipeline(blocks32, pred32, intra_cfg, intra=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    decide()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        decide()
        torch.cuda.synchronize()
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    products = sum(t for t, key in by_kernel if "gemm" in key.lower())
    d_decide, d_res = device_ms(decide, calls=3), device_ms(residual, calls=3)
    log(f"{tag} the n = 32 mode decision of a 1080p frame ({m_blocks} blocks): device "
        f"{d_decide:.3f} ms, of which its float64 products (gemm kernels) {products:.3f} ms; "
        f"the residual of the same blocks {d_res:.3f} ms (torch.profiler); its kernels by "
        f"device ms: {[(round(t, 4), key[:60]) for t, key in by_kernel[:6]]}")
    for what, fn in (("wavefront I frame", lambda: encode_intra_frame_wavefront(cur, intra_cfg)),
                     ("yuv I frame", lambda: encode_intra_frame_yuv(yuv_cur, intra_cfg)),
                     ("closed-loop yuv GOP (5 frames)",
                      lambda: encode_gop_closed_loop_yuv(gop_frames, cfg))):
        busy, wall, n_launch = busy_share(fn)
        log(f"{tag} {what}: device busy {busy:.3f} ms in {wall:.3f} ms (share "
            f"{busy / wall:.3f}), {n_launch} kernel launches (torch.profiler)")
    # K2 and B3 through each C entry at the 1080p shapes: the kernels'
    # device time alone (the device-q call also stacks its int32[5]).
    q32 = qtensors(qargs)
    q_flag = range_flag(dev)
    for short, kernel, host_fn, q_fn in (
            ("K2", "inter_fused_kernel",
             lambda: inter_ctu_fused_dma(src, padded, k2_offsets, *qargs),
             lambda: inter_ctu_fused_dma(src, padded, k2_offsets, *q32, range_flag=q_flag)),
            ("B3", "bi_fused_kernel",
             lambda: bi_ctu_fused_dma(b_src, b_flat, b3_off0, b3_off1, *qargs),
             lambda: bi_ctu_fused_dma(b_src, b_flat, b3_off0, b3_off1, *q32,
                                      range_flag=q_flag))):
        for _ in range(2):
            d_host, d_q = (kernel_device_ms(f, kernel) for f in (host_fn, q_fn))
            log(f"{tag} {short} device time, 1080p: host-int entry {d_host:.4f} ms, "
                f"device-q entry {d_q:.4f} ms (torch.profiler, 10 calls each)")
        calls = turns_ms({"host-int": host_fn, "device-q": q_fn})
        log(f"{tag} {short} a call (CUDA events, 10 calls a sample, in turns): host-int "
            f"{calls['host-int']:.4f} ms, device-q {calls['device-q']:.4f} ms")
    raise_on_flag(q_flag)
    def log_rdo(what, samples, psnr=None):
        ms_r = statistics.median(samples)
        log(f"{tag} RDO {what}: {ms_r:.3f} ms/frame (min {samples[0]:.3f}, max "
            f"{samples[-1]:.3f} over {REPS} samples), {n / ms_r * 1e3:.0f} CTU/s"
            + ("" if psnr is None else f", psnr_db={psnr:.4f}"))

    for name, rcfg in rdo_cfgs.items():
        samples = samples_ms(lambda: encode_inter_frame(yuv_cur.y, yuv_ref0.y, rcfg))
        log_rdo(name, samples,
                float(encode_inter_frame(yuv_cur.y, yuv_ref0.y, rcfg)["psnr_db"]))
    log_rdo("pu_decision plain path", samples_ms(lambda: encode_inter_frame(
        yuv_cur.y, yuv_ref0.y, rdo_cfgs["pu_decision"], tiers=Tier.REF)))

    def log_path(what, samples, reps=REPS):
        ms_r = statistics.median(samples)
        log(f"{tag} {what}: {ms_r:.3f} ms/frame (min {samples[0]:.3f}, max "
            f"{samples[-1]:.3f} over {reps} samples), {n / ms_r * 1e3:.0f} CTU/s")

    for name, (run, pcfg, _) in extra_paths.items():
        log_path(f"{name} path", samples_ms(lambda: run(pcfg)))
        reps = 3 if "multiref" in name else REPS
        log_path(f"{name} plain path", samples_ms(lambda: run(pcfg, Tier.REF), reps=reps),
                 reps)
    for name, (kind, pcfg, _) in search_paths.items():
        log_path(f"{name} path", samples_ms(lambda: search_path(kind)(pcfg)))
    # The one-kernel inner loop beside the two-kernel one, in turns.
    mega_cfg = search_paths["luma P mega"][1]
    for _ in range(2):
        log_path("luma P fused_dma path (beside mega)",
                 samples_ms(lambda: encode_inter_frame(cur, ref, cfg)))
        log_path("luma P mega path (beside fused_dma)",
                 samples_ms(lambda: encode_inter_frame(cur, ref, mega_cfg)))
    num = 2 * SEARCH_RANGE + 1
    # B10's yardstick: torch.cdist(p=1) on float32 copies (cast not timed),
    # exact here since every sum is below 4096 * 255 < 2^24, timed in turns
    # with B10: both are calls of ~15 us of host work.
    cd_src, cd_ref = b_src.reshape(n, 1, 4096).float(), b10_ref.reshape(n, 1, 4096).float()
    cd_mr, cd_refs = mr_src.reshape(n, 1, 4096).float(), mr_tiles.reshape(n, 4, 4096).float()
    if not (torch.equal(torch.cdist(cd_src, cd_ref, p=1)[:, 0, 0].int(), sad(b_src, b10_ref))
            and torch.equal(torch.cdist(cd_mr, cd_refs, p=1)[:, 0].int(),
                            sad_multiref(mr_src, mr_tiles))):
        raise AssertionError("torch.cdist(p=1) differs from B10")
    b10_turns = turns_ms({"sad": lambda: sad(b_src, b10_ref),
                          "sad cdist": lambda: torch.cdist(cd_src, cd_ref, p=1),
                          "sad_multiref": lambda: sad_multiref(mr_src, mr_tiles),
                          "sad_multiref cdist": lambda: torch.cdist(cd_mr, cd_refs, p=1)})
    library = {"sad": b10_turns["sad cdist"], "sad_multiref": b10_turns["sad_multiref cdist"]}
    cf_cfg = EncodeConfig(search_range=SEARCH_RANGE, qp=35)
    times = {
        "ssd_grid_plane": (
            median_ms(lambda: ssd_grid_plane(src, plane, grid, num), calls=10),
            median_ms(lambda: ssd_grid_plane_ref(src, plane, grid, num))),
        "inter_ctu_fused_dma": (
            median_ms(lambda: inter_ctu_fused_dma(src, padded, k2_offsets, *qargs),
                      calls=10),
            median_ms(lambda: inter_ctu_fused_dma_ref(src, padded, k2_offsets, *qargs))),
        "bi_ctu_fused_dma": (
            median_ms(lambda: bi_ctu_fused_dma(b_src, b_flat, b3_off0, b3_off1, *qargs),
                      calls=10),
            median_ms(lambda: bi_ctu_fused_dma_ref(b_src, b_flat, b3_off0, b3_off1,
                                                   *qargs))),
        "refine_qpel_costmap": (
            median_ms(lambda: refine_qpel_costmap(tiles16, win16), calls=10),
            median_ms(lambda: refine_qpel_costmap_ref(tiles16, win16))),
        "refine_qpel_costmap_dma": (
            median_ms(lambda: refine_qpel_costmap_dma(tiles16, p_padded, starts16), calls=10),
            median_ms(lambda: refine_qpel_costmap_dma_ref(tiles16, p_padded, starts16))),
        "base_grids_ctu": (
            median_ms(lambda: base_grids_ctu(b_src, p_win, 8), calls=10),
            median_ms(lambda: base_grids_ctu_ref(b_src, p_win, 8))),
        "base_layout_decide": (
            median_ms(lambda: base_layout_decide(b_src, p_win, 16, lists16), calls=10),
            median_ms(lambda: base_layout_decide_ref(b_src, p_win, 16, lists16))),
        "ssd_grid": (
            median_ms(lambda: ssd_grid(*b8_r16, 33, 33), calls=10),
            median_ms(lambda: ssd_grid_ref(*b8_r16, 33, 33))),
        "ssd_grid_plane_multi": (
            median_ms(lambda: ssd_grid_plane_multi(mr_src, mr_view, grid, num), calls=10),
            median_ms(lambda: ssd_grid_plane_multi_ref(mr_src, mr_view, grid, num), reps=3)),
        "refine_quarter_pel_fused": (
            median_ms(lambda: refine_quarter_pel_fused(mr_src, mr_win), calls=10),
            median_ms(lambda: refine_quarter_pel_fused_ref(mr_src, mr_win))),
        "inter_ctu_fused": (
            median_ms(lambda: inter_ctu_fused(src, b16_win, *qargs), calls=10),
            median_ms(lambda: inter_ctu_fused_ref(src, b16_win, *qargs))),
        "residual_pipeline_ctu": (
            median_ms(lambda: residual_pipeline_ctu(b_src, b4_pred, *b4_args[(8, 0)]),
                      calls=10),
            median_ms(lambda: residual_pipeline_ctu_ref(b_src, b4_pred, *b4_args[(8, 0)]))),
        "sad_grid": (
            median_ms(lambda: sad_grid(b_src, p_win, num, num), calls=10),
            median_ms(lambda: sad_grid_ref(b_src, p_win, num, num))),
        "search_mv": (
            median_ms(lambda: search_mv(src, win128, num), calls=10),
            median_ms(lambda: search_mv_ref(src, win128, num))),
        "search_mv_dma": (
            median_ms(lambda: search_mv_dma(src, padded, pos, SEARCH_RANGE), calls=10),
            median_ms(lambda: search_mv_dma_ref(src, padded, pos, SEARCH_RANGE))),
        "encode_ctu_mega": (
            median_ms(lambda: encode_ctu_mega(src, padded, pos, SEARCH_RANGE, *qargs), calls=10),
            median_ms(lambda: encode_ctu_mega_ref(src, padded, pos, SEARCH_RANGE, *qargs))),
        "sad": (b10_turns["sad"], median_ms(lambda: sad_ref(b_src, b10_ref))),
        "sad_multiref": (b10_turns["sad_multiref"],
                         median_ms(lambda: sad_multiref_ref(mr_src, mr_tiles))),
        "pred_uni": (
            median_ms(lambda: mc.pred_uni(mc_luma[0], *mc_luma[2:4]), calls=10),
            median_ms(lambda: mc.pred_uni_ref(mc_luma[0], *mc_luma[2:4]))),
        "pred_bi": (
            median_ms(lambda: mc.pred_bi(*mc_luma), calls=10),
            median_ms(lambda: mc.pred_bi_ref(*mc_luma))),
        "base_layout_decide_fc": (
            median_ms(lambda: base_layout_decide_fc(b_src, p_win, lists16), calls=10),
            median_ms(lambda: base_layout_decide_fc_ref(b_src, p_win, lists16))),
        "chroma_p_fused": (
            median_ms(lambda: chroma_p_fused(*cf_1080, cf_cfg), calls=10),
            median_ms(lambda: chroma_p_fused_ref(*cf_1080, cf_cfg))),
        # A call is a 1080p I frame's 126 waves (the host enqueue included).
        "intra_wave_fused": (
            median_ms(lambda: intra_wave_frame(intra_wave_fused, cur, intra_cfg)),
            median_ms(lambda: intra_wave_frame(intra_wave_ref, cur, intra_cfg), reps=3)),
    }
    # Device time beside the CUDA-event time of 10 calls says whether the
    # kernel or the wrapper's host work bounds a call: for the small kernels,
    # for K1 and B7, for K2, B3 and B16 (whose kernels take less than their
    # wrappers' host work), and for B10's library call, so that
    # B10 is compared with cdist call with call and device with device.
    profiled = {
        "ssd_grid_plane": lambda: ssd_grid_plane(src, plane, grid, num),
        "ssd_grid_plane_multi": lambda: ssd_grid_plane_multi(mr_src, mr_view, grid, num),
        "torch.cdist(p=1), B10 sad's library call": lambda: torch.cdist(cd_src, cd_ref, p=1),
        "torch.cdist(p=1), B10 sad_multiref's library call":
            lambda: torch.cdist(cd_mr, cd_refs, p=1),
        "sad": lambda: sad(b_src, b10_ref),
        "sad_multiref": lambda: sad_multiref(mr_src, mr_tiles),
        "pred_uni": lambda: mc.pred_uni(mc_luma[0], *mc_luma[2:4]),
        "pred_bi": lambda: mc.pred_bi(*mc_luma),
        "pred_uni chroma": lambda: mc.pred_uni(mc_chroma[0], *mc_chroma[2:4], 4),
        "pred_bi chroma": lambda: mc.pred_bi(*mc_chroma, 4),
        "base_layout_decide_fc": lambda: base_layout_decide_fc(b_src, p_win, lists16),
        "inter_ctu_fused_dma": lambda: inter_ctu_fused_dma(src, padded, k2_offsets, *qargs),
        "bi_ctu_fused_dma": lambda: bi_ctu_fused_dma(b_src, b_flat, b3_off0, b3_off1, *qargs),
        "inter_ctu_fused": lambda: inter_ctu_fused(src, b16_win, *qargs),
        "encode_ctu_mega": lambda: encode_ctu_mega(src, padded, pos, SEARCH_RANGE, *qargs),
        "chroma_p_fused": lambda: chroma_p_fused(*cf_1080, cf_cfg),
        "intra_wave_fused": lambda: intra_wave_frame(intra_wave_fused, cur, intra_cfg),
        **{b4_name(tu, tr): lambda tu=tu, tr=tr: residual_pipeline_ctu(
            b_src, b4_pred, *b4_args[(tu, tr)], tu=tu, tr_type=tr) for tu, tr in b4_args},
    }
    device = {}
    for what, fn in profiled.items():
        device[what] = d_ms = device_ms(fn)
        log(f"{tag} {what} at 1080p: device {d_ms:.4f} ms a call (torch.profiler, kernels' "
            f"self time)" if d_ms else f"{tag} {what}: device time not measured (the "
            "profiler recorded no kernel)")
    log_b10_host_steps(tag, b_src, b10_ref, cd_src, cd_ref)
    shapes_timed = {"refine_qpel_costmap": "8160 16x16 tiles, gathered windows",
                    "refine_qpel_costmap_dma": "8160 16x16 tiles at the searched MVs",
                    "base_grids_ctu": "510 CTUs, base 8",
                    "base_layout_decide": "510 CTUs, base 16, 26 PU lists",
                    "ssd_grid": "8160 16x16 blocks, R=16",
                    "ssd_grid_plane_multi": "510 CTUs, k=4, R=32",
                    "refine_quarter_pel_fused": "510 64x64 windows",
                    "inter_ctu_fused": "510 windows",
                    "residual_pipeline_ctu": "510 CTUs, 8x8 TUs",
                    "sad_grid": "510 CTUs, R=32, the full search",
                    "sad": "510 64x64 blocks",
                    "sad_multiref": "510 64x64 blocks, k=4",
                    "pred_uni": "510 64x64 luma blocks, 8-tap, per-block fractions",
                    "pred_bi": "510 64x64 luma block pairs, 8-tap, per-block fractions",
                    "base_layout_decide_fc": "510 CTUs, R=32, 26 PU lists (B15 at base 16)",
                    "chroma_p_fused": "both 544x960 chroma planes, 1020 32x32 blocks, qp 35",
                    "intra_wave_fused": "a 1080p I frame's 126 waves, 2040 32x32 blocks, qp 32"}
    more = {
        "refine_qpel_costmap_dma 32640 8x8 tiles": (
            median_ms(lambda: refine_qpel_costmap_dma(tiles8, p_padded, starts8), calls=10),
            median_ms(lambda: refine_qpel_costmap_dma_ref(tiles8, p_padded, starts8))),
        "refine_qpel_costmap 510 64x64 tiles": (
            median_ms(lambda: refine_qpel_costmap(b_src, p_win[:, 32:103, 32:103]), calls=10),
            median_ms(lambda: refine_qpel_costmap_ref(b_src, p_win[:, 32:103, 32:103]))),
        "base_grids_ctu 510 CTUs, base 16": (
            median_ms(lambda: base_grids_ctu(b_src, p_win, 16), calls=10),
            median_ms(lambda: base_grids_ctu_ref(b_src, p_win, 16))),
        "base_grids_ctu 510 CTUs, base 32": (
            median_ms(lambda: base_grids_ctu(b_src, p_win, 32), calls=10),
            median_ms(lambda: base_grids_ctu_ref(b_src, p_win, 32))),
        "base_layout_decide 510 CTUs, base 8": (
            median_ms(lambda: base_layout_decide(b_src, p_win, 8, lists8), calls=10),
            median_ms(lambda: base_layout_decide_ref(b_src, p_win, 8, lists8))),
        "ssd_grid 32640 8x8 blocks, R=16": (
            median_ms(lambda: ssd_grid(*b8_8_r16, 33, 33), calls=10),
            median_ms(lambda: ssd_grid_ref(*b8_8_r16, 33, 33))),
        "ssd_grid 510 16x16 decimated blocks, num 17 (pyramid coarse level)": (
            median_ms(lambda: ssd_grid(b9_src_c, b9_win_c, 17, 17), calls=10),
            median_ms(lambda: ssd_grid_ref(b9_src_c, b9_win_c, 17, 17))),
        "ssd_grid 510 CTUs, num 7 (pyramid fine level)": (
            median_ms(lambda: ssd_grid(b_src, b9_win_f, 7, 7), calls=10),
            median_ms(lambda: ssd_grid_ref(b_src, b9_win_f, 7, 7))),
        "ssd_grid 8160 16x16 blocks, R=32": (
            median_ms(lambda: ssd_grid(*b8_r32, 65, 65), calls=10),
            median_ms(lambda: ssd_grid_ref(*b8_r32, 65, 65))),
        "ssd_grid 510 CTUs, R=32": (
            median_ms(lambda: ssd_grid(b_src, p_win, 65, 65), calls=10),
            median_ms(lambda: ssd_grid_ref(b_src, p_win, 65, 65))),
        "base_layout_decide 510 CTUs, base 32": (
            median_ms(lambda: base_layout_decide(b_src, p_win, 32, lists32), calls=10),
            median_ms(lambda: base_layout_decide_ref(b_src, p_win, 32, lists32))),
        "refine_quarter_pel_fused 8160 16x16 tiles": (
            median_ms(lambda: refine_quarter_pel_fused(tiles16, win16), calls=10),
            median_ms(lambda: refine_quarter_pel_fused_ref(tiles16, win16))),
        "inter_ctu_fused_batched 510 windows, group 4": (
            median_ms(lambda: inter_ctu_fused_batched(src, b16_win, *qargs, group=4),
                      calls=10),
            median_ms(lambda: inter_ctu_fused_ref(src, b16_win, *qargs))),
        **{b4_name(tu, tr): (
            median_ms(lambda: residual_pipeline_ctu(b_src, b4_pred, *b4_args[(tu, tr)], tu=tu,
                                                    tr_type=tr), calls=10),
            median_ms(lambda: residual_pipeline_ctu_ref(b_src, b4_pred, *b4_args[(tu, tr)],
                                                        tu=tu, tr_type=tr)))
           for tu, tr in b4_args if (tu, tr) != (8, 0)},
        "sad_grid 510 16x16 decimated blocks, num 17 (pyramid coarse level)": (
            median_ms(lambda: sad_grid(b9_src_c, b9_win_c, 17, 17), calls=10),
            median_ms(lambda: sad_grid_ref(b9_src_c, b9_win_c, 17, 17))),
        "sad_grid 510 CTUs, num 7 (pyramid fine level)": (
            median_ms(lambda: sad_grid(b_src, b9_win_f, 7, 7), calls=10),
            median_ms(lambda: sad_grid_ref(b_src, b9_win_f, 7, 7))),
        "sad_grid 8160 16x16 blocks, R=32 (PU decision)": (
            median_ms(lambda: sad_grid(*b8_r32, 65, 65), calls=10),
            median_ms(lambda: sad_grid_ref(*b8_r32, 65, 65))),
        "pred_uni 1020 32x32 chroma blocks, 4-tap, per-block fractions": (
            median_ms(lambda: mc.pred_uni(mc_chroma[0], *mc_chroma[2:4], 4), calls=10),
            median_ms(lambda: mc.pred_uni_ref(mc_chroma[0], *mc_chroma[2:4], 4))),
        "pred_bi 1020 32x32 chroma block pairs, 4-tap, per-block fractions": (
            median_ms(lambda: mc.pred_bi(*mc_chroma, 4), calls=10),
            median_ms(lambda: mc.pred_bi_ref(*mc_chroma, 4))),
    }
    for what, (k_ms, p_ms) in more.items():
        log(f"{tag} {what} at 1080p: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    for name, (k_ms, p_ms) in times.items():
        shape = f" ({shapes_timed[name]})" if name in shapes_timed else ""
        dev_ms = f" (device {device[name]:.4f})" if name in device else ""
        lib_ms = ""
        if name in library:
            lib_dev = device[f"torch.cdist(p=1), B10 {name}'s library call"]
            lib_ms = f", torch.cdist(p=1) {library[name]:.4f} ms (device {lib_dev:.4f})"
        log(f"{tag} {name} at 1080p{shape}: kernel {k_ms:.4f} ms{dev_ms}, plain {p_ms:.3f} "
            f"ms{lib_ms}")
    # B17 and B19 run K1's products on one plane; B19's floor leaves out its
    # refinement and residual.
    tc_kernels = (("ssd_grid_plane", 1), ("ssd_grid_plane_multi", 4), ("search_mv", 1),
                  ("search_mv_dma", 1), ("encode_ctu_mega", 1))
    for name, k_planes in tc_kernels:
        floor = tc_floor_ms(n, k_planes, SEARCH_RANGE)
        log(f"{tag} {name}: the tensor-core design's own floor {floor:.4f} ms (the m16n8k32 "
            f"products it issues at 1,979 TOP/s), kernel at {floor / times[name][0]:.3f} of it")
    # The design floors at the card's own instruction rates, beside the
    # bounds (which stay at the published rates).
    from tools.b9_b15_phase_costs import instruction_rates
    rates = instruction_rates()
    mma_tops = rates["mma.sync m16n8k32 u8"]["tops"]
    vabs = rates["vabsdiff4.add"]["thread_instr_per_s"]
    log(f"{tag} the card's own rates (tools/b9_b15_phase_costs.py): mma.sync m16n8k32 u8 "
        f"{mma_tops:.1f} TOP/s; vabsdiff4.add {vabs / 1e12:.3f} T thread instructions/s "
        f"({vabs / (132 * 1.98e9):.1f} a clock an SM at 1.98 GHz; the bound assumes "
        f"{INT_INSTR_PER_S / (132 * 1.98e9):.0f})")
    for name, k_planes in tc_kernels:
        floor = tc_floor_ms(n, k_planes, SEARCH_RANGE) * 1979 / mma_tops
        log(f"{tag} {name}: design floor at mma.sync's own rate {floor:.4f} ms, kernel at "
            f"{floor / times[name][0]:.3f} of it")
    b9_shapes = {"sad_grid 510 CTUs, R=32": (n * num * num * 4096, times["sad_grid"][0]),
                 "sad_grid 8160 16x16 blocks, R=32": (
                     b8_r32[0].shape[0] * num * num * 256,
                     more["sad_grid 8160 16x16 blocks, R=32 (PU decision)"][0])}
    for what, (terms, k_ms) in b9_shapes.items():
        b_ms = terms / SAD_TERMS_PER_INSTR / INT_INSTR_PER_S * 1e3
        floor = terms / SAD_TERMS_PER_INSTR / vabs * 1e3
        log(f"{tag} {what}: bound {b_ms:.4f} ms (packed, at {INT_INSTR_PER_S / 1e12:.1f} T "
            f"instructions/s); design floor {floor:.4f} ms (its VABSDIFF4s at the card's "
            f"vabsdiff4 rate); kernel {k_ms:.4f} ms, at {floor / k_ms:.3f} of the floor")
    for what, base, k_ms in (("base_layout_decide 510 CTUs, base 8", 8,
                              more["base_layout_decide 510 CTUs, base 8"][0]),
                             ("base_layout_decide 510 CTUs, base 16", 16,
                              times["base_layout_decide"][0]),
                             ("base_layout_decide 510 CTUs, base 32", 32,
                              more["base_layout_decide 510 CTUs, base 32"][0]),
                             ("base_layout_decide_fc 510 CTUs (base 16)", 16,
                              times["base_layout_decide_fc"][0])):
        prods = b15_products(n, base, SEARCH_RANGE)
        floor = prods * 2 * 16 * 8 * 32 / (mma_tops * 1e12) * 1e3
        log(f"{tag} {what}: {prods} m16n8k32 products, design floor {floor:.4f} ms at "
            f"mma.sync's own rate; kernel {k_ms:.4f} ms, at {floor / k_ms:.3f} of the floor")
    # B8 at each path shape and B14 at each base: the m16n8k32 products each
    # issues (its tiling) at mma.sync's own rate, beside the bound (bytes in
    # and grids out at 3.35 TB/s, multiply-adds at 1,979 TOP/s).
    grid_rows = [(f"ssd_grid {name}", blocks, wins, nd, nd, k_ms)
                 for name, blocks, wins, nd, k_ms in (
        ("8160 16x16 blocks, R=16", *b8_r16, 33, times["ssd_grid"][0]),
        ("32640 8x8 blocks, R=16", *b8_8_r16, 33, more["ssd_grid 32640 8x8 blocks, R=16"][0]),
        ("510 16x16 decimated blocks, num 17 (pyramid coarse)", b9_src_c, b9_win_c, 17,
         more["ssd_grid 510 16x16 decimated blocks, num 17 (pyramid coarse level)"][0]),
        ("510 CTUs, num 7 (pyramid fine)", b_src, b9_win_f, 7,
         more["ssd_grid 510 CTUs, num 7 (pyramid fine level)"][0]),
        ("8160 16x16 blocks, R=32", *b8_r32, 65, more["ssd_grid 8160 16x16 blocks, R=32"][0]),
        ("510 CTUs, R=32", b_src, p_win, 65, more["ssd_grid 510 CTUs, R=32"][0]))]
    for what, blocks, wins, ndy, ndx, k_ms in grid_rows:
        nb, b = blocks.shape[0], blocks.shape[-1]
        prods = b8_products(nb, b, ndy, ndx)
        plan = b8_plan(b, nb, ndy, ndx)
        b_ms, b_by = bound(nbytes(blocks, wins) + nb * ndy * ndx * 4, 2 * nb * b * b * ndy * ndx)
        floor = prods * 2 * 16 * 8 * 32 / (mma_tops * 1e12) * 1e3
        log(f"{tag} {what}: {prods} m16n8k32 products ({plan['sb']} blocks of {plan['mb']} m "
            f"tiles x {plan['ntb']} n tiles a thread block, {plan['smem']} B), design floor "
            f"{floor:.4f} ms at mma.sync's own rate; bound {b_ms:.4f} ms ({b_by}); kernel "
            f"{k_ms:.4f} ms, at {floor / k_ms:.3f} of the floor and {b_ms / k_ms:.3f} of the bound")
    for base, k_ms in ((8, times["base_grids_ctu"][0]),
                       (16, more["base_grids_ctu 510 CTUs, base 16"][0]),
                       (32, more["base_grids_ctu 510 CTUs, base 32"][0])):
        prods = b14_products(n, base, SEARCH_RANGE)
        b_ms, b_by = bound(nbytes(b_src, p_win) + n * (64 // base) ** 2 * num * num * 4,
                           2 * n * num * num * 4096)
        floor = prods * 2 * 16 * 8 * 32 / (mma_tops * 1e12) * 1e3
        log(f"{tag} base_grids_ctu 510 CTUs, base {base}: {prods} "
            f"m16n8k32 products, design floor {floor:.4f} ms at mma.sync's own rate; bound "
            f"{b_ms:.4f} ms ({b_by}); kernel {k_ms:.4f} ms, at {floor / k_ms:.3f} of the floor "
            f"and {b_ms / k_ms:.3f} of the bound")

    sources = {
        "ssd_grid_plane": ("hevcasm_tpu_torch/csrc/ssd_grid_plane.cu",
                           "hevcasm_tpu/kernels/search_pallas.py:688"),
        "inter_ctu_fused_dma": ("hevcasm_tpu_torch/csrc/inter_fused.cu",
                                "hevcasm_tpu/kernels/interp_pallas.py:846"),
        "bi_ctu_fused_dma": ("hevcasm_tpu_torch/csrc/bi_fused.cu",
                             "hevcasm_tpu/kernels/interp_pallas.py:1020"),
        "refine_qpel_costmap": ("hevcasm_tpu_torch/csrc/costmap.cu",
                                "hevcasm_tpu/kernels/interp_pallas.py:291"),
        "refine_qpel_costmap_dma": ("hevcasm_tpu_torch/csrc/costmap.cu",
                                    "hevcasm_tpu/kernels/interp_pallas.py:451"),
        "base_grids_ctu": ("hevcasm_tpu_torch/csrc/base_grids.cu",
                           "hevcasm_tpu/kernels/search_pallas.py:1100"),
        "base_layout_decide": ("hevcasm_tpu_torch/csrc/base_grids.cu",
                               "hevcasm_tpu/kernels/search_pallas.py:1045"),
        "ssd_grid": ("hevcasm_tpu_torch/csrc/ssd_grid.cu",
                     "hevcasm_tpu/kernels/search_pallas.py:359"),
        "ssd_grid_plane_multi": ("hevcasm_tpu_torch/csrc/ssd_grid_plane.cu",
                                 "hevcasm_tpu/kernels/search_pallas.py:624"),
        "refine_quarter_pel_fused": ("hevcasm_tpu_torch/csrc/refine_fused.cu",
                                     "hevcasm_tpu/kernels/interp_pallas.py:164"),
        "inter_ctu_fused": ("hevcasm_tpu_torch/csrc/inter_fused.cu",
                            "hevcasm_tpu/kernels/interp_pallas.py:551"),
        "residual_pipeline_ctu": ("hevcasm_tpu_torch/csrc/residual_ctu.cu",
                                  "hevcasm_tpu/kernels/residual_pallas.py:184"),
        "sad_grid": ("hevcasm_tpu_torch/csrc/sad_grid.cu",
                     "hevcasm_tpu/kernels/sad_pallas.py:57"),
        "search_mv": ("hevcasm_tpu_torch/csrc/search_mv.cu",
                      "hevcasm_tpu/kernels/search_pallas.py:856"),
        "search_mv_dma": ("hevcasm_tpu_torch/csrc/search_mv.cu",
                          "hevcasm_tpu/kernels/search_pallas.py:1381"),
        "encode_ctu_mega": ("hevcasm_tpu_torch/csrc/mega.cu",
                            "hevcasm_tpu/kernels/mega_pallas.py:143"),
        "sad": ("hevcasm_tpu_torch/csrc/sad.cu", "hevcasm_tpu/kernels/sad_pallas.py:98"),
        "sad_multiref": ("hevcasm_tpu_torch/csrc/sad.cu",
                         "hevcasm_tpu/kernels/sad_pallas.py:130"),
        "pred_uni": ("hevcasm_tpu_torch/csrc/mc.cu", "hevcasm_tpu/kernels/mc_pallas.py:115"),
        "pred_bi": ("hevcasm_tpu_torch/csrc/mc.cu", "hevcasm_tpu/kernels/mc_pallas.py:174"),
        "base_layout_decide_fc": ("hevcasm_tpu_torch/csrc/base_grids.cu",
                                  "hevcasm_tpu/kernels/search_pallas.py:1269"),
        "chroma_p_fused": ("hevcasm_tpu_torch/csrc/chroma_fused.cu",
                           "none: the port's own (hevcasm_tpu codes chroma in plain ops, "
                           "hevcasm_tpu/encode/video.py)"),
        "intra_wave_fused": ("hevcasm_tpu_torch/csrc/intra_wave.cu",
                             "none: the port's own (hevcasm_tpu codes the wavefront I frame "
                             "in plain ops, hevcasm_tpu/encode/intra_wavefront.py)"),
    }
    # The least time for each timed call: bytes moved (inputs read once,
    # outputs written once) and multiply-adds, from the shapes it was timed
    # at.  SSD terms count as the correlation form's multiply-add.
    n16 = tiles16.shape[0]
    grid_terms = n * num * num * 4096
    decide_adds = n * sum(len(pu) for pu in lists16) * num * num
    costs = {
        "ssd_grid_plane": (nbytes(src, plane) + n * num * num * 4, 2 * grid_terms),
        "inter_ctu_fused_dma": (nbytes(src, padded, k2_offsets) + n * (4096 + 8 + 2 * 256),
                                n * (refine_ops(64) + residual_ops(8))),
        "bi_ctu_fused_dma": (nbytes(b_src, b_flat, b3_off0, b3_off1) + n * (4096 + 8 + 2 * 256),
                             n * (2 * refine_ops(64) + residual_ops(8))),
        "refine_qpel_costmap": (nbytes(tiles16, win16) + n16 * 64, n16 * refine_ops(16)),
        "refine_qpel_costmap_dma": (nbytes(tiles16, p_padded, starts16) + n16 * (64 + 23 * 23),
                                    n16 * refine_ops(16)),
        "base_grids_ctu": (nbytes(b_src, p_win) + n * 64 * num * num * 4, 2 * grid_terms),
        "base_layout_decide": (nbytes(b_src, p_win) + n * len(lists16) * 12,
                               2 * grid_terms + decide_adds),
        "ssd_grid": (nbytes(*b8_r16) + b8_r16[0].shape[0] * 33 * 33 * 4,
                     2 * b8_r16[0].shape[0] * 33 * 33 * 256),
        "ssd_grid_plane_multi": (nbytes(mr_src) + mr_view.shape[0] * mr_view[0].numel()
                                 + n * 4 * num * num * 4, 4 * 2 * grid_terms),
        "refine_quarter_pel_fused": (nbytes(mr_src, mr_win) + n * (4096 + 8),
                                     n * refine_ops(64)),
        "inter_ctu_fused": (nbytes(src, b16_win) + n * (4096 + 8 + 2 * 256),
                            n * (refine_ops(64) + residual_ops(8))),
        "residual_pipeline_ctu": (nbytes(b_src, b4_pred) + n * (4096 + 256),
                                  n * residual_ops(8)),
        "sad_grid": (nbytes(b_src, p_win) + n * num * num * 4,
                     grid_terms / SAD_TERMS_PER_INSTR, INT_INSTR_PER_S),
        "search_mv": (nbytes(src, win128) + n * 12, 2 * grid_terms),
        "search_mv_dma": (nbytes(src, padded, pos) + n * 12, 2 * grid_terms),
        "encode_ctu_mega": (nbytes(src, padded, pos) + n * (4096 + 12 + 4 + 256),
                            2 * grid_terms + n * (refine_ops(64) + residual_ops(8))),
        "sad": (nbytes(b_src, b10_ref) + n * 4, n * 4096 / SAD_TERMS_PER_INSTR,
                INT_INSTR_PER_S),
        "sad_multiref": (nbytes(mr_src, mr_tiles) + n * 4 * 4,
                         n * 4 * 4096 / SAD_TERMS_PER_INSTR, INT_INSTR_PER_S),
        "pred_uni": (nbytes(mc_luma[0], *mc_luma[2:4]) + n * 4096,
                     2 * n * mc_macs(64, 64, 8)),
        "pred_bi": (nbytes(*mc_luma) + n * 4096, 2 * 2 * n * mc_macs(64, 64, 8)),
    }
    costs["base_layout_decide_fc"] = costs["base_layout_decide"]
    # chroma_p_fused: four planes read, two written, the MVs and two counts;
    # each 32x32 block of each plane one 4-tap MC and a quarter of a CTU's
    # 4x4 residual.
    cf_blocks = 2 * cf_1080[-1].shape[0]
    costs["chroma_p_fused"] = (nbytes(*cf_1080) + 2 * cf_1080[0].numel() + 8,
                               cf_blocks * (2 * mc_macs(32, 32, 4) + residual_ops(4) // 4))
    # K2 (and B16, its kernel on gathered windows) and B3: the refinement's
    # and the residual stage's products at mma.sync's own rates, beside the
    # bound.
    mma16_pps = rates["mma.sync m16n8k16 s8"]["products_per_s"]
    mma32_pps = rates["mma.sync m16n8k32 u8"]["products_per_s"]
    log(f"{tag} the card's own rate of mma.sync m16n8k16 s8: "
        f"{rates['mma.sync m16n8k16 s8']['tops']:.1f} TOP/s")
    for name, refs in (("inter_ctu_fused_dma", 1), ("inter_ctu_fused", 1),
                       ("bi_ctu_fused_dma", 2)):
        k32, k16 = refine_tc_products(n, refs)
        k16 += residual_tc_products(n, 8)[0]      # the residual stage's
        b_ms, b_by = bound(*costs[name])
        k_ms = times[name][0]
        d_ms = device[name]
        floor = (k32 / mma32_pps + k16 / mma16_pps) * 1e3
        log(f"{tag} {name} 510 CTUs: {k32} m16n8k32 + {k16} m16n8k16 products "
            f"({(k32 + k16) // n} a CTU), design floor {floor:.4f} ms at mma.sync's own rates; "
            f"bound {b_ms:.4f} ms ({b_by}); kernel {k_ms:.4f} ms a call (device {d_ms:.4f}), "
            f"device at {floor / d_ms:.3f} of the floor and {b_ms / d_ms:.3f} of the bound"
            if d_ms else f"{tag} {name}: device time not measured")
    # B4 at each TU size: its products at mma.sync's own rates, plus the rest
    # of its instructions (quantizer, byte splits, loads, stores, shuffles)
    # at the CUDA cores' issue rate: each instance's SASS instructions,
    # which a warp runs once for its tile (the code has no loop).
    b4_all, b4_nop = (sass_counts(build, "residual_ctu_kernel", op) for op in (" ;", "NOP"))
    b4_sass = {f: (b4_all[f] - b4_nop[f], imma)
               for f, imma in sass_counts(build, "residual_ctu_kernel", "IMMA").items()}
    for tu, tr in b4_args:
        name = b4_name(tu, tr)
        k16, k32 = residual_tc_products(n, tu)
        instr, imma = next(v for f, v in b4_sass.items() if f"ILi{tu}ELb{tr}E" in f)
        warps = n * (64 // (32 if tu == 32 else 16)) ** 2
        t_mma = (k16 / mma16_pps + k32 / mma32_pps) * 1e3
        t_cores = (instr - imma) * warps * 32 / INT_INSTR_PER_S * 1e3
        b_ms, b_by = bound(nbytes(b_src, b4_pred) + n * (4096 + 4 * (64 // tu) ** 2),
                           n * residual_ops(tu))
        k_ms = (times if name == "residual_pipeline_ctu" else more)[name][0]
        d_ms = device[name]
        log(f"{tag} {name}: {k16} m16n8k16 + {k32} m16n8k32 products ({t_mma:.4f} ms at "
            f"mma.sync's own rates) and {instr - imma} other SASS instructions a warp's tile "
            f"x {warps} tiles ({t_cores:.4f} ms at {INT_INSTR_PER_S / 1e12:.1f} T thread "
            f"instructions/s): design floor {t_mma + t_cores:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}); kernel {k_ms:.4f} ms a call (device {d_ms:.4f}), device at "
            f"{(t_mma + t_cores) / d_ms:.3f} of the floor and {b_ms / d_ms:.3f} of the bound"
            if d_ms else f"{tag} {name}: device time not measured")
    # B5 and B6, luma and chroma: the m16n8k32 products of their tiling
    # (csrc/mc_tc.cuh) at mma.sync's own rate, plus the rest of each
    # instance's SASS instructions at the CUDA cores' issue rate, counted once
    # a warp task (a warp runs its step loop unrolled once; the staging loop,
    # a few 16-byte copies a thread, counted once), beside the bound and the
    # device time of a call (torch.profiler).
    mc_all, mc_nop = (sass_counts(build, "pred_kernel", op) for op in (" ;", "NOP"))
    mc_rows = (("pred_uni", "510 64x64 luma", mc_luma[0], None, 8, False),
               ("pred_bi", "510 64x64 luma", mc_luma[0], mc_luma[1], 8, True),
               ("pred_uni chroma", "1020 32x32 chroma", mc_chroma[0], None, 4, False),
               ("pred_bi chroma", "1020 32x32 chroma", mc_chroma[0], mc_chroma[1], 4, True))
    for name, what, w0, w1, taps, bi in mc_rows:
        nb, b = w0.shape[0], w0.shape[-1] - taps + 1
        inst = next(f for f in mc_all if f"ILi{taps}ELb{int(bi)}E" in f)
        instr = mc_all[inst] - mc_nop[inst] - mc_imma[inst]
        steps = -(-b // 16)
        tasks = -(-b // 16) * -(-steps // 4)          # strips x runs of 4 steps
        prods = mc_tc_products(nb, b, b, bi)
        t_mma = prods / mma32_pps * 1e3
        t_cores = instr * nb * tasks * 32 / INT_INSTR_PER_S * 1e3
        b_ms, b_by = bound(nbytes(*(w0, w1)[:1 + bi]) + nb * (16 if bi else 8) + nb * b * b,
                           2 * nb * mc_macs(b, b, taps) * (2 if bi else 1))
        d_ms = device[name]
        log(f"{tag} {name} {what}: {prods} m16n8k32 products ({t_mma:.4f} ms at mma.sync's "
            f"own rate) and {instr} other SASS instructions a warp task x {nb * tasks} tasks "
            f"({t_cores:.4f} ms at {INT_INSTR_PER_S / 1e12:.1f} T thread instructions/s): "
            f"design floor {t_mma + t_cores:.4f} ms; bound {b_ms:.4f} ms ({b_by}); device "
            f"{d_ms:.4f} ms a call, at {(t_mma + t_cores) / d_ms:.3f} of the floor and "
            f"{b_ms / d_ms:.3f} of the bound" if d_ms else
            f"{tag} {name} {what}: device time not measured")
    # B11, B12 and B13: the products of their tensor-core tilings (a warp's
    # tile below 64, K2's block core at 64) at mma.sync's own rates, beside
    # the bound and the device time, at each shape timed.
    n8 = tiles8.shape[0]
    tile_rows = (
        ("refine_quarter_pel_fused", "510 64x64 windows", 64, True,
         lambda: refine_quarter_pel_fused(mr_src, mr_win), times["refine_quarter_pel_fused"][0],
         costs["refine_quarter_pel_fused"]),
        ("refine_quarter_pel_fused", "8160 16x16 tiles", 16, True,
         lambda: refine_quarter_pel_fused(tiles16, win16),
         more["refine_quarter_pel_fused 8160 16x16 tiles"][0],
         (nbytes(tiles16, win16) + n16 * (256 + 8), n16 * refine_ops(16))),
        ("refine_qpel_costmap", "8160 16x16 tiles", 16, False,
         lambda: refine_qpel_costmap(tiles16, win16), times["refine_qpel_costmap"][0],
         costs["refine_qpel_costmap"]),
        ("refine_qpel_costmap", "510 64x64 tiles", 64, False,
         lambda: refine_qpel_costmap(b_src, p_win[:, 32:103, 32:103]),
         more["refine_qpel_costmap 510 64x64 tiles"][0],
         (nbytes(b_src, p_win[:, 32:103, 32:103]) + n * 64, n * refine_ops(64))),
        ("refine_qpel_costmap_dma", "8160 16x16 tiles", 16, False,
         lambda: refine_qpel_costmap_dma(tiles16, p_padded, starts16),
         times["refine_qpel_costmap_dma"][0], costs["refine_qpel_costmap_dma"]),
        ("refine_qpel_costmap_dma", "32640 8x8 tiles", 8, False,
         lambda: refine_qpel_costmap_dma(tiles8, p_padded, starts8),
         more["refine_qpel_costmap_dma 32640 8x8 tiles"][0],
         (nbytes(tiles8, p_padded, starts8) + n8 * (64 + 15 * 15), n8 * refine_ops(8))))
    for name, what, b, winner, fn, k_ms, cost in tile_rows:
        tiles_n = {64: n, 16: n16, 8: n8}[b]
        k32, k16 = refine_tile_products(tiles_n, b, winner)
        floor = (k32 / mma32_pps + k16 / mma16_pps) * 1e3
        b_ms, b_by = bound(*cost)
        d_ms = device_ms(fn)
        log(f"{tag} {name} {what}: {k32} m16n8k32 + {k16} m16n8k16 products, design floor "
            f"{floor:.4f} ms at mma.sync's own rates; bound {b_ms:.4f} ms ({b_by}); kernel "
            f"{k_ms:.4f} ms a call (device {d_ms:.4f}), device at {floor / d_ms:.3f} of the "
            f"floor and {b_ms / d_ms:.3f} of the bound" if d_ms else
            f"{tag} {name} {what}: device time not measured")
    # chroma_p_fused: each 32x32 block of each plane 4 MC tasks (a strip and
    # a step: 2 chunks of 2 horizontal products, 4 vertical) of 8 m16n8k32
    # products, and 4 residual tiles of 16 m16n8k16 (a quarter of a CTU's).
    k32 = cf_blocks * 4 * 8
    k16 = cf_blocks * residual_tc_products(1, 4)[0] // 4
    floor = (k32 / mma32_pps + k16 / mma16_pps) * 1e3
    b_ms, b_by = bound(*costs["chroma_p_fused"])
    d_ms = device["chroma_p_fused"]
    log(f"{tag} chroma_p_fused 1080p (1020 32x32 blocks): {k32} m16n8k32 + {k16} m16n8k16 "
        f"products, design floor {floor:.4f} ms at mma.sync's own rates; bound {b_ms:.4f} ms "
        f"({b_by}); kernel {times['chroma_p_fused'][0]:.4f} ms a call"
        + (f" (device {d_ms:.4f}), device at {floor / d_ms:.3f} of the floor and "
           f"{b_ms / d_ms:.3f} of the bound" if d_ms else ", device time not measured"))
    # intra_wave_fused: a frame is a chain of dependent launches, one a
    # wave, each a CTA a block (<= 60 of 132 SMs), so no byte or operation
    # count bounds it: its bound is the chain of as many dependent launches
    # at the gap that one-element torch kernels take behind a spin.
    one = torch.zeros(1, device=dev)

    def tiny_chain(k):
        for _ in range(k):
            one.add_(1)

    bounds = {}
    for what_w, plane_w, waves_w in (("1080p", cur, WAVES_1080P),
                                     ("4K", torch.as_tensor(rate_clip(1, H4K, W4K, 12)[0],
                                                            device=dev), WAVES_4K)):
        fn_w = functools.partial(encode_intra_frame_wavefront, plane_w, intra_cfg)
        chain_ms = unpaced_ms(lambda: tiny_chain(waves_w))
        frame_ms = unpaced_ms(fn_w)
        kernel_ms = kernel_device_ms(fn_w, "intra_wave_kernel", calls=5)
        paced = samples_ms(fn_w)
        host_ms = statistics.median(host_us(fn_w, calls=1) for _ in range(5)) / 1e3
        bounds[what_w] = (chain_ms, f"a chain of {waves_w} dependent launches")
        log(f"{tag} intra_wave_fused, a {what_w} wavefront I frame ({waves_w} waves): kernel "
            f"{kernel_ms:.4f} ms a frame, {kernel_ms / waves_w * 1e3:.2f} us a wave "
            f"(torch.profiler); the frame's work unpaced (behind a spin) {frame_ms:.4f} ms, "
            f"{frame_ms / waves_w * 1e3:.2f} us a wave; paced by the host "
            f"{statistics.median(paced):.4f} ms (host enqueue {host_ms:.4f} ms, "
            f"{host_ms / waves_w * 1e3:.2f} us a wave); bound {chain_ms:.4f} ms ({waves_w} "
            f"dependent one-element kernels behind a spin, "
            f"{chain_ms / waves_w * 1e3:.2f} us a launch), the unpaced frame at "
            f"{chain_ms / frame_ms:.3f} of it")
    kernels = []
    for name, (src_path, replaces) in sources.items():
        bound_ms, bound_by = (bounds["1080p"] if name == "intra_wave_fused"
                              else bound(*costs[name]))
        kernels.append({"name": name, "route": "cuda", "source": src_path,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err[name], "ms": times[name][0],
                        "plain_ms": times[name][1], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library.get(name)})
        log(f"{tag} {name}: bound {bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / times[name][0]:.3f} of it")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
