"""Run a function on a world of N ranks under torch.distributed, one
process a rank.

JAX drives every device of a mesh from one process; torch.distributed runs
one process per rank.  ``spawn`` is the counterpart that lets the sharded
entry points run in a world of N: the tests (gloo worlds of CPU
processes), the dry run, the scaling harness and chip_smoke.py.

* Processes start with the ``spawn`` method, never ``fork``: the parent
  may hold a CUDA context, which a forked child cannot use.
* The ranks meet at a ``file://`` store in a fresh temporary directory, so
  launchers that run at the same time never contend for a TCP port.
* ``timeout_s`` bounds init_process_group and every collective (the
  process group's timeout) and the parent's wait for the results: a hung
  rank fails the call, it never hangs it.
* CPU ranks run torch on one thread.  CUDA ranks take card ``rank %
  device_count``, so under gloo several ranks may share one card.
* Each rank's result (tensors, numbers, and dicts, lists and tuples of
  them) crosses back as numpy.  A rank that raises or exits non-zero fails
  the call in the parent (torch.multiprocessing's exceptions, the rank's
  traceback in the message), and the other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

__all__ = ["spawn", "default_backend", "check_backend"]


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, ranks_on_host: int | None) -> None:
    """Refuse nccl on a host with no card, or with more ranks on this host
    than it has cards: NCCL takes one card a rank ("Duplicate GPU
    detected").  ``ranks_on_host`` is None where the count is not known (a
    multi-host world with no LOCAL_WORLD_SIZE); only the first refusal
    applies then.  The backend is never switched here; the caller names
    gloo to share a card."""
    if backend != "nccl":
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0 or (ranks_on_host is not None and ranks_on_host > cards):
        raise ValueError(
            f"nccl needs a card a rank: {ranks_on_host or 'some'} rank(s) on this host, "
            f"{cards} card(s); pass backend='gloo' to run several ranks on one card")


def _to_numpy(x):
    """A rank's result with every tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _rank_main(rank, world_size, backend, device_type, store_dir, timeout_s, fn, args,
               results):
    """One rank: join the world, run fn, send back (rank, result).  An
    exception goes to the parent by torch.multiprocessing's error file, and
    to ``failed.<rank>`` in store_dir with the time it was caught, written
    before this rank leaves the group."""
    from . import multihost

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    multihost._DEVICE = device
    dist.init_process_group(backend, init_method="file://" + os.path.join(store_dir, "store"),
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = _to_numpy(fn(rank, world_size, *args))
    except BaseException:
        with open(os.path.join(store_dir, f"failed.{rank}"), "w") as f:
            f.write(f"{time.monotonic_ns()}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    results.put((rank, pickle.dumps(out)))   # pickled here, so a failure raises in the rank


def _first_failure(store_dir: str, reported):
    """The exception of the rank that failed first.  A rank's failure makes
    its peers' collectives fail after it, and join() reports whichever
    failed rank it sees first; the ranks' own clock (monotonic, one host)
    orders them."""
    failed = []
    for name in os.listdir(store_dir):
        if name.startswith("failed."):
            with open(os.path.join(store_dir, name)) as f:
                when, trace = f.read().split("\n", 1)
            failed.append((int(when), int(name.split(".")[1]), trace))
    if not failed:
        return reported
    _, rank, trace = min(failed)
    if rank == reported.error_index:
        return reported
    return tmp.ProcessRaisedException(
        f"\n\n-- Process {rank} failed first, with the following error:\n{trace}", rank,
        None)


def spawn(fn, world_size: int, *, backend: str | None = None, device=None, args=(),
          timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in each of ``world_size`` new
    processes joined in one process group, and return their results, in
    rank order, with every tensor as numpy.

    fn must be importable by name (a module-level function).  device is
    where each rank runs: by default "cuda" (the cards; with none it raises
    RuntimeError), or "cpu"; backend defaults to nccl for "cuda" and gloo
    for "cpu", and nccl with more ranks than cards raises ValueError.
    Raises torch.multiprocessing's ProcessRaisedException when a rank
    raised (its message holds the traceback of the rank that failed first)
    and
    ProcessExitedException when a rank exits non-zero, after stopping the
    other ranks; TimeoutError when the ranks have not all finished within
    timeout_s seconds (every process is then killed)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    device_type = torch.device(device or "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    backend = backend or default_backend(device_type)
    check_backend(backend, world_size)
    results = tmp.get_context("spawn").Queue()
    store_dir = tempfile.mkdtemp(prefix="hevc_world_")
    deadline = time.monotonic() + timeout_s
    ctx = tmp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                              args=(world_size, backend, device_type, store_dir, timeout_s,
                                    fn, tuple(args), results))
    out = {}

    def drain():
        try:
            while True:
                rank, blob = results.get_nowait()
                out[rank] = pickle.loads(blob)
        except queue.Empty:
            pass

    try:
        # Read the results while the ranks run: a rank exits only once the
        # queue has taken what it put.  join() raises for a failed rank.
        try:
            while not ctx.join(timeout=0.5):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks of {world_size} did not finish within {timeout_s} s")
        except tmp.ProcessRaisedException as e:
            first = _first_failure(store_dir, e)
            if first is e:
                raise
            raise first from e
        drain()
        missing = sorted(set(range(world_size)) - set(out))
        if missing:
            raise RuntimeError(f"ranks {missing} exited with code 0 and sent no result")
        return [out[rank] for rank in range(world_size)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for f in ctx.error_files:           # torch.multiprocessing leaves them behind
            if os.path.exists(f):
                os.unlink(f)
        results.close()
        results.join_thread()
        shutil.rmtree(store_dir, ignore_errors=True)
