"""Rank programs for tests/test_torch_parallel.py and test_torch_launch.py.

Each runs in a process of its own, started by hevcasm_tpu_torch.parallel.
launch.spawn, which imports this module by name there: it imports torch and
hevcasm_tpu_torch only, never jax.  The test files compute the JAX
package's results and compare.
"""

from __future__ import annotations

import os
import time

import torch.distributed as dist

from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.parallel import (encode_gop_closed_loop_spatial,
                                        encode_gop_data_parallel, encode_inter_frame_spatial,
                                        make_mesh, multihost, sharding)

CPU = "cpu"


def refusal(fn) -> str:
    """The ValueError message of fn(), or '' when it raised none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def two_ranks(rank: int, world: int, inputs: dict) -> dict:
    """Mesh (1, 2): spatial frames under several configurations, the
    closed-loop spatial GOP, the guards and the multihost functions."""
    import torch

    mesh = make_mesh(frames=1, rows=2)
    out = {"coordinate": tuple(mesh.get_coordinate()), "mesh_type": mesh.device_type,
           "threads": torch.get_num_threads(), "backend": dist.get_backend(),
           "rank_device": str(multihost.rank_device()), "tensor": torch.arange(3) + rank}
    cfg8 = EncodeConfig(search_range=8, qp=32)
    sharding.reset_wire_stats()
    out["rand"] = encode_inter_frame_spatial(*inputs["rand"], mesh, cfg8, device=CPU)
    out["halo_bytes"] = sharding.wire.halo_bytes
    out["dy6"] = encode_inter_frame_spatial(*inputs["dy6"], mesh, cfg8, device=CPU)
    for impl in ("fused_batched", "fused_dma", "mega"):
        cfg = EncodeConfig(search_range=4, qp=32, inter_impl=impl)
        out[impl] = encode_inter_frame_spatial(*inputs["fast"], mesh, cfg, device=CPU)
    out["gop"] = encode_gop_closed_loop_spatial(inputs["gop"], mesh, cfg8, device=CPU)
    cur, ref = inputs["rand"]
    out["refusals"] = {
        "pyramid": refusal(lambda: encode_inter_frame_spatial(
            cur, ref, mesh, EncodeConfig(search_range=8, me_strategy="pyramid"), device=CPU)),
        "pu_decision": refusal(lambda: encode_inter_frame_spatial(
            cur, ref, mesh, EncodeConfig(search_range=8, pu_decision=True), device=CPU)),
        "tu_sizes": refusal(lambda: encode_gop_closed_loop_spatial(
            inputs["gop"], mesh, EncodeConfig(search_range=8, tu_sizes=(8, 16)), device=CPU)),
        "bands": refusal(lambda: encode_inter_frame_spatial(
            cur[:192], ref[:192], mesh, cfg8, device=CPU)),
        "gop_bands": refusal(lambda: encode_gop_closed_loop_spatial(
            inputs["gop"][:, :192], mesh, cfg8, device=CPU)),
        "global_mesh": refusal(lambda: multihost.make_global_mesh(frames=3, rows=2)),
        "make_mesh": refusal(lambda: make_mesh(frames=2, rows=2)),
    }
    try:
        encode_inter_frame_spatial(cur, ref, mesh, cfg8)
        out["default_device"] = ""
    except RuntimeError as e:
        out["default_device"] = str(e)
    multihost.initialize()
    multihost.initialize(device=CPU)
    out["world_after_initialize"] = dist.get_world_size()
    gmesh = multihost.make_global_mesh(frames=1, rows=2)
    out["global_mesh"] = (gmesh.mesh_dim_names, gmesh.mesh.tolist(),
                          tuple(gmesh.get_coordinate()))
    return out


def four_ranks(rank: int, world: int, inputs: dict) -> dict:
    """Meshes (2, 2), (1, 4), (4, 1) and (1, 2) over ranks 0-1 of a world of
    four: the data-parallel GOP, four bands, and the guards."""
    out = {}
    mesh22 = make_mesh(frames=2, rows=2)
    out["dp"] = encode_gop_data_parallel(inputs["dp"], mesh22, EncodeConfig(search_range=4,
                                                                           qp=32), device=CPU)
    out["dp_refusal"] = refusal(lambda: encode_gop_data_parallel(
        inputs["dp"][:4], mesh22, EncodeConfig(search_range=4), device=CPU))
    mesh14 = make_mesh(frames=1, rows=4)
    out["bands4"] = encode_inter_frame_spatial(*inputs["bands4"], mesh14,
                                               EncodeConfig(search_range=8, qp=32), device=CPU)
    out["halo_refusal"] = refusal(lambda: encode_inter_frame_spatial(
        *inputs["bands4"], mesh14, EncodeConfig(search_range=64, qp=32), device=CPU))
    out["make_mesh_refusal"] = refusal(lambda: make_mesh(frames=3, rows=1))
    mesh41 = make_mesh(frames=4, rows=1)
    out["dp41"] = encode_gop_data_parallel(inputs["dp"], mesh41, EncodeConfig(search_range=4,
                                                                             qp=32), device=CPU)
    sub = make_mesh(frames=1, rows=2, ranks=[0, 1])
    out["subset"] = encode_inter_frame_spatial(*inputs["bands4"], sub,
                                               EncodeConfig(search_range=8, qp=32), device=CPU)
    gmesh = multihost.make_global_mesh(frames=2, rows=2)
    out["global_mesh"] = (gmesh.mesh.tolist(), tuple(gmesh.get_coordinate()))
    return out


def raise_in_rank(rank: int, world: int, which: int):
    """Rank ``which`` raises ValueError; the others wait at a barrier that
    never completes."""
    if rank == which:
        raise ValueError(f"refused in rank {rank}")
    dist.barrier()
    return rank


def exit_in_rank(rank: int, world: int, code: int):
    """Every rank leaves with exit code ``code`` and no result."""
    os._exit(code)


def sleep_in_rank(rank: int, world: int, seconds: float):
    time.sleep(seconds)
    return rank



def card_two_ranks(rank: int, world: int, inputs: dict) -> dict:
    """On the card, two ranks sharing it under gloo: the spatial frame, the
    closed-loop spatial GOP over mesh (1, 2) and the data-parallel GOP over
    mesh (2, 1) under fused_dma, each with its K1/K2 launches."""
    from hevcasm_tpu_torch.kernels import inter_fused, search

    cfg = EncodeConfig(search_range=8, qp=32, inter_impl="fused_dma")
    mesh_sp, mesh_dp = make_mesh(frames=1, rows=2), make_mesh(frames=2, rows=1)
    runs = {"spatial": lambda: encode_inter_frame_spatial(*inputs["spatial"], mesh_sp, cfg),
            "gop": lambda: encode_gop_closed_loop_spatial(inputs["gop"], mesh_sp, cfg),
            "dp": lambda: encode_gop_data_parallel(inputs["dp"], mesh_dp, cfg)}
    out = {"device": str(multihost.rank_device()), "mesh_type": mesh_sp.device_type}
    for name, fn in runs.items():
        search.ssd_grid_plane.launches = inter_fused.inter_ctu_fused_dma.launches = 0
        out[name] = fn()
        out[name + " launches"] = (search.ssd_grid_plane.launches,
                                   inter_fused.inter_ctu_fused_dma.launches)
    return out
