"""Scaling harness for BASELINE configs 4-5 (frames/s on 1 rank and on N),
the counterpart of hevcasm_tpu's ``bench_scaling.py``.

Config 4: a 1080p IPPP GOP of 1 + N frames, its P frames data-parallel over
the ``frames`` axis (open loop: the P frames depend on sources only).

Config 5: a 4K 32-frame closed-loop GOP, each frame's CTU-row bands over
the ``rows`` axis with halo exchange (the frame chain itself is sequential:
a conforming encoder references reconstructions).

Both encode with inter_impl="fused_dma" (K1's search, then K2), qp 32,
and run in one spawned world of N ranks: the same GOP on a mesh of rank 0
alone and on the N-rank mesh, timed over --reps repetitions after a warm-up
(best of them), each ending in a checksum of the reconstruction read by the
host, so that nothing is left in flight.  On a card the time is taken
between CUDA events on every rank (the slowest rank's counts); on the CPU by
the host clock.  frames/s = (T - 1) / t; efficiency = t_1 / (N t_N).

    python -m hevcasm_tpu_torch.parallel.scaling --ranks 2 --scale full --backend gloo
    python -m hevcasm_tpu_torch.parallel.scaling --ranks 4 --device cpu   # dryrun scale

Prints one JSON line per config with bench_scaling.py's keys plus
"cards", "backend", "timer" and "checksum" (the N-rank reconstruction's
sum, equal to the 1-rank one's, which the harness checks).  N ranks that
share fewer than N cards measure no scaling: their efficiency says how much
the sharded program costs on one card, not how it scales.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import launch

__all__ = ["clip", "run"]


def clip(rng: np.random.Generator, t: int, h: int, w: int) -> np.ndarray:
    """bench_scaling.py's content: a noise picture panned (1, 2) pixels a
    frame, drawn from ``rng`` (one generator of seed 0 for all configs, in
    their order, as bench_scaling.py draws them)."""
    base = rng.integers(0, 256, (h + 2 * t, w + 2 * t), dtype=np.uint8)
    return np.stack([base[i:i + h, 2 * i:2 * i + w] for i in range(t)])


def _shapes(config: int, scale: str, n: int):
    """(T, H, W, R, rows of the N-rank mesh) of a config at a scale."""
    if config == 4:
        return (1 + n, 1088, 1920, 32, 1) if scale == "full" else (1 + n, 256, 384, 8, 1)
    if scale == "full":
        return 32, 2176, 3840, 32, n
    rows = max(1, n // 2)
    return 6, 256 * rows, 384, 8, rows


def _timed(fn, reps: int, on_card: bool):
    """Best seconds of ``reps`` calls of fn after one warm-up, each ending in
    a host read of a checksum of its recon; every rank of the world joins
    each barrier.  Returns (seconds, checksum), (None, None) off the mesh
    (where fn returns None)."""
    import torch.distributed as dist

    def call():
        out = fn()
        return None if out is None else int(out["recon"].to(torch.int64).sum())

    checksum = call()
    best = float("inf")
    for _ in range(reps):
        dist.barrier()
        if on_card:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            checksum = call()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            checksum = call()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    dist.barrier()
    return (None, None) if checksum is None else (best, checksum)


def _rank_run(rank: int, world: int, configs, scale: str, reps: int, device: str):
    import torch.distributed as dist

    from ..encode.loop import EncodeConfig
    from .sharding import encode_gop_closed_loop_spatial, encode_gop_data_parallel, make_mesh

    on_card = torch.device(device).type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    rng = np.random.default_rng(0)
    results = []
    for config in configs:
        t, h, w, r, rows = _shapes(config, scale, world)
        cfg = EncodeConfig(search_range=r, qp=32, inter_impl="fused_dma")
        frames = torch.as_tensor(clip(rng, t, h, w), device=dev)
        mesh1 = make_mesh(1, 1, ranks=[0])
        if config == 4:
            meshn = make_mesh(world, 1)
            run = encode_gop_data_parallel
        else:
            meshn = make_mesh(1, rows, ranks=range(rows))
            run = encode_gop_closed_loop_spatial
        t1, sum1 = _timed(lambda: run(frames, mesh1, cfg), reps, on_card)
        tn, sumn = _timed(lambda: run(frames, meshn, cfg), reps, on_card)
        # The N-rank time is the slowest member's.
        tn_all = [None] * world
        dist.all_gather_object(tn_all, tn)
        results.append({"config": config, "t": t, "h": h, "w": w, "rows": rows,
                        "t1": t1, "tn": max(x for x in tn_all if x is not None),
                        "sum1": sum1, "sumn": sumn})
    return results


def run(ranks: int, configs=(4, 5), scale: str = "dryrun", reps: int = 3, device=None,
        backend: str | None = None) -> list[dict]:
    """Time configs on 1 rank and on ``ranks`` ranks in one spawned world;
    returns one dict a config (bench_scaling.py's keys, plus "cards",
    "backend", "timer" and "checksum")."""
    device = device or "cuda"
    on_card = torch.device(device).type == "cuda"
    backend = backend or launch.default_backend(device)
    outs = launch.spawn(_rank_run, ranks, backend=backend, device=device,
                        args=(tuple(configs), scale, reps, device),
                        timeout_s=3000)
    rank0 = outs[0]
    rows = []
    for res in rank0:
        if res["sum1"] != res["sumn"]:
            raise AssertionError(f"config {res['config']}: the {ranks}-rank reconstruction "
                                 f"differs from the 1-rank one ({res['sumn']} != {res['sum1']})")
        n_used = ranks if res["config"] == 4 else res["rows"]
        t1, tn, t = res["t1"], res["tn"], res["t"]
        desc = (f"{res['h']}x{res['w']} {t}-frame GOP dp over {n_used} ranks"
                if res["config"] == 4 else
                f"{res['h']}x{res['w']} {t}-frame closed-loop GOP, {n_used}-way spatial")
        rows.append({
            "config": res["config"], "desc": desc, "platform": "gpu" if on_card else "cpu",
            "scale": scale, "fps_1dev": (t - 1) / t1, "fps_ndev": (t - 1) / tn,
            "scaling_efficiency": t1 / (tn * n_used) if tn > 0 else 0.0,
            "cards": min(ranks, torch.cuda.device_count()) if on_card else 0,
            "backend": backend, "timer": "cuda_events" if on_card else "host_clock",
            "checksum": res["sumn"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hevcasm_tpu_torch.parallel.scaling")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--configs", default="4,5")
    ap.add_argument("--scale", choices=("dryrun", "full"), default="dryrun")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = ap.parse_args(argv)
    configs = [int(c) for c in args.configs.split(",") if c.strip()]
    if not configs:
        print(json.dumps({"error": "no configs selected"}))
        return 1
    for row in run(args.ranks, configs, args.scale, args.reps, args.device, args.backend):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
