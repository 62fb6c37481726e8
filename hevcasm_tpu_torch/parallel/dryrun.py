"""Dry run of the sharded encode on a world of N ranks, the counterpart of
hevcasm_tpu's ``dryrun_multichip``: the data-parallel GOP, a spatially
sharded frame under inter_impl="fused_dma", and the closed-loop spatial
GOP, at the same tiny shapes, each rank in its own process.

    python -m hevcasm_tpu_torch.parallel.dryrun 8 --device cpu   # gloo, no card
    python -m hevcasm_tpu_torch.parallel.dryrun 1                # nccl, the card

Prints ``dryrun_multichip ok on N ranks: ...``.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import launch

__all__ = ["dryrun_multichip"]


def _programs(rank: int, world: int, device: str, rows: int, gop, cur, ref, gop5):
    """The three sharded programs on this rank (hevcasm_tpu's shapes and
    configurations); returns the PSNRs and output shapes, None for the
    closed-loop GOP on a rank outside its mesh."""
    from ..encode.loop import EncodeConfig
    from .sharding import (encode_gop_closed_loop_spatial, encode_gop_data_parallel,
                           encode_inter_frame_spatial, make_mesh)

    mesh = make_mesh(frames=world // rows, rows=rows)
    cfg = EncodeConfig(search_range=4, qp=32)
    dp = encode_gop_data_parallel(gop, mesh, cfg, device=device)
    cfg_fast = EncodeConfig(search_range=4, qp=32, inter_impl="fused_dma")
    sp = encode_inter_frame_spatial(cur, ref, mesh, cfg_fast, device=device)
    mesh5 = make_mesh(frames=1, rows=rows, ranks=range(rows))
    cl = encode_gop_closed_loop_spatial(gop5, mesh5, cfg, device=device)
    return {"dp": (float(dp["psnr_db"][0]), tuple(dp["recon"].shape)),
            "spatial": (float(sp["psnr_db"]), tuple(sp["recon"].shape)),
            "closed": None if cl is None else (float(cl["psnr_db"][-1]),
                                               tuple(cl["recon"].shape))}


def dryrun_multichip(n: int, device=None, backend: str | None = None) -> dict:
    """Run the three sharded programs on a world of n ranks (spawned
    processes; device "cpu" or by default "cuda", where nccl takes a card
    a rank and gloo lets ranks share one), check their output shapes, print
    one line and return rank 0's PSNRs."""
    device = device or "cuda"
    rng = np.random.default_rng(0)
    rows = 2 if n % 2 == 0 else 1
    frames_ax = n // rows
    t, h, w = frames_ax + 1, 128 * rows, 128
    gop = rng.integers(0, 256, (t, h, w), dtype=np.uint8)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    gop5 = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    outs = launch.spawn(_programs, n, backend=backend, device=device,
                        args=(device, rows, gop, cur, ref, gop5), timeout_s=600)
    for rank, out in enumerate(outs):
        if out["dp"][1] != (t - 1, h, w) or out["spatial"][1] != (h, w):
            raise AssertionError(f"rank {rank}: output shapes {out}")
        if (out["closed"] is None) != (rank >= rows) or (
                out["closed"] is not None and out["closed"][1] != (3, h, w)):
            raise AssertionError(f"rank {rank}: closed-loop GOP {out['closed']}")
    psnr = {k: outs[0][k][0] for k in ("dp", "spatial", "closed")}
    print(f"dryrun_multichip ok on {n} ranks: dp psnr={psnr['dp']:.2f}dB "
          f"spatial psnr={psnr['spatial']:.2f}dB "
          f"closed-loop-spatial psnr={psnr['closed']:.2f}dB", flush=True)
    return psnr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hevcasm_tpu_torch.parallel.dryrun")
    ap.add_argument("ranks", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card, nccl a rank a card)")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
