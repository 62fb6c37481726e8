"""Process bring-up for a multi-host world, the counterpart of
``hevcasm_tpu.parallel.multihost``.

The per-rank program is the same everywhere; what is multi-host-specific
is joining the process group and building the global mesh.  A 4K GOP then
runs through encode_gop_data_parallel / encode_inter_frame_spatial
unchanged: the ``frames`` axis moves whole reconstructed frames, which may
cross hosts, and the ``rows`` axis moves halo rows between neighbours,
which make_global_mesh keeps on one host by putting ``rows`` innermost.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .launch import check_backend, default_backend

__all__ = ["initialize", "make_global_mesh", "rank_device"]

#: How long init_process_group and each collective may wait for the others.
TIMEOUT = datetime.timedelta(minutes=10)

#: The device this rank runs on, set by initialize() and parallel.launch.
_DEVICE: torch.device | None = None


def rank_device() -> torch.device:
    """The device this rank runs on: the one initialize() or the launcher
    chose, else (a group made elsewhere) the current CUDA card under nccl
    and the CPU under gloo."""
    if _DEVICE is not None:
        return _DEVICE
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> None:
    """Join this process to a torch.distributed world.

    Idempotent: with a process group already made it returns at once.
    coordinator_address ("host:port"), num_processes and process_id name
    the world explicitly (a ``tcp://`` rendezvous; all three or none);
    otherwise the MASTER_ADDR / WORLD_SIZE / RANK environment that
    launchers set (``env://``); with neither, a world of 1.  ``device`` is
    where this rank runs: by default the CUDA card (LOCAL_RANK's, else the
    rank's modulo the cards; with no card it raises RuntimeError), or
    "cpu".  The backend is nccl for a CUDA device and gloo for the CPU
    unless named; nccl raises ValueError on a host with no card, and with
    more ranks on this host than cards where that count is known
    (LOCAL_WORLD_SIZE, or a world of 1); a world over several hosts without
    LOCAL_WORLD_SIZE leaves it to the choice of card.  Every failure of
    initialisation is raised."""
    global _DEVICE
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        init = {"init_method": f"tcp://{coordinator_address}",
                "world_size": int(num_processes), "rank": int(process_id)}
    elif all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        init = {"init_method": "env://", "world_size": int(os.environ["WORLD_SIZE"]),
                "rank": int(os.environ["RANK"])}
    else:
        init = {"store": dist.HashStore(), "world_size": 1, "rank": 0}
    if not 0 <= init["rank"] < init["world_size"]:
        raise ValueError(f"rank {init['rank']} outside a world of {init['world_size']}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run this rank on the CPU")
    backend = backend or default_backend(dev)
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    check_backend(backend, int(local_world) if local_world is not None
                  else 1 if init["world_size"] == 1 else None)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", init["rank"]))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=TIMEOUT, **init)
    _DEVICE = dev


def world_size() -> int:
    """The number of ranks in this process's world; RuntimeError without
    one."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize() or run "
                           "under parallel.launch.spawn first")
    return dist.get_world_size()


def mesh_over(ranks, frames: int, rows: int) -> DeviceMesh:
    """A (frames, rows) DeviceMesh over ``ranks`` (rank i of the list at
    (i // rows, i % rows)), with the rank device's type.  Every rank of the
    world must call it, also those outside the mesh."""
    world_size()
    ranks = list(ranks)
    if frames < 1 or rows < 1 or frames * rows != len(ranks):
        raise ValueError(f"mesh {frames}x{rows} != {len(ranks)} ranks")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(frames, rows)
    return DeviceMesh(rank_device().type, mesh, mesh_dim_names=("frames", "rows"))


def make_global_mesh(frames: int, rows: int) -> DeviceMesh:
    """A (frames, rows) mesh over every rank of the world.  ``rows`` is
    innermost, so rank i sits at (i // rows, i % rows): halo exchanges go
    between neighbouring ranks, which a launcher places on one host, and
    only whole frames cross hosts.  A size that is not the world's raises
    ValueError."""
    world = world_size()
    if frames * rows != world:
        raise ValueError(f"mesh {frames}x{rows} != {world} ranks")
    return mesh_over(range(world), frames, rows)
