"""hevcasm_tpu_torch.parallel.launch and multihost on the CPU: a rank's
exception, a rank's exit code and a hung rank each fail the call in the
parent (three spawned gloo worlds, ~15 s on one worker), and the refusals
and the world of one need no spawned process."""

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import torch_testing  # noqa: F401
import torch_parallel_ranks as ranks
from hevcasm_tpu_torch.parallel import launch, multihost


def test_a_rank_exception_is_raised_in_the_parent():
    with pytest.raises(tmp.ProcessRaisedException, match="refused in rank 1") as info:
        launch.spawn(ranks.raise_in_rank, 2, device="cpu", args=(1,), timeout_s=120)
    assert info.value.error_index == 1
    assert "Traceback" in str(info.value) and "ValueError" in str(info.value)


def test_the_rank_that_failed_first_is_reported(tmp_path):
    """A peer whose collective broke after the failure is not reported."""
    (tmp_path / "failed.0").write_text("20\nRuntimeError: Connection reset by peer\n")
    (tmp_path / "failed.1").write_text("10\nValueError: refused in rank 1\n")
    (tmp_path / "store").write_text("")
    reported = tmp.ProcessRaisedException("RuntimeError: Connection reset", 0, 1234)
    first = launch._first_failure(str(tmp_path), reported)
    assert first.error_index == 1 and "refused in rank 1" in str(first)
    assert "failed first" in str(first)
    reported = tmp.ProcessRaisedException("ValueError: refused in rank 1", 1, 1234)
    assert launch._first_failure(str(tmp_path), reported) is reported


def test_a_rank_exit_code_fails_the_call():
    with pytest.raises(tmp.ProcessExitedException, match="exit code 3") as info:
        launch.spawn(ranks.exit_in_rank, 1, device="cpu", args=(3,), timeout_s=120)
    assert info.value.exit_code == 3


def test_a_hung_rank_times_out():
    with pytest.raises(TimeoutError, match="did not finish"):
        launch.spawn(ranks.sleep_in_rank, 1, device="cpu", args=(600,), timeout_s=10)


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"backend": "nccl", "device": "cpu"}, ValueError, "backend='gloo'"),
    ({"world_size": 0}, ValueError, "world_size"),
])
def test_spawn_refusals(kwargs, exc, match):
    args = {"world_size": 2, **kwargs}
    with pytest.raises(exc, match=match):
        launch.spawn(ranks.sleep_in_rank, args.pop("world_size"), args=(0,), **args)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_spawn_on_the_card_without_one(monkeypatch, device):
    """The ranks run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(ranks.sleep_in_rank, 1, device=device, args=(0,))


def test_initialize_refusals(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize(coordinator_address="localhost:1", device="cpu")
    with pytest.raises(ValueError, match="backend='gloo'"):
        multihost.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        multihost.initialize("localhost:1", 2, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_world,refused", [("8", False), (None, False), ("9", True)])
def test_initialize_nccl_over_several_hosts(monkeypatch, local_world, refused):
    """A world of 2 hosts x 8 cards: the ranks on this host are counted only
    where LOCAL_WORLD_SIZE says how many there are; the card is LOCAL_RANK's,
    else the rank's modulo the cards."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    try:
        if refused:
            with pytest.raises(ValueError, match="9 rank"):
                multihost.initialize("localhost:1", 16, 9, backend="nccl")
            assert calls == []
            return
        multihost.initialize("localhost:1", 16, 9, backend="nccl")
        assert calls == [(("nccl",), {"timeout": multihost.TIMEOUT,
                                      "init_method": "tcp://localhost:1", "world_size": 16,
                                      "rank": 9})]
        assert multihost._DEVICE == torch.device("cuda", 1)
    finally:
        multihost._DEVICE = None


def test_initialize_a_world_of_one_twice(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    try:
        multihost.initialize(device="cpu")
        multihost.initialize(device="cpu")
        multihost.initialize()      # already initialised: returns, whatever it is asked
        assert (dist.get_world_size(), dist.get_backend()) == (1, "gloo")
        mesh = multihost.make_global_mesh(1, 1)
        assert mesh.mesh_dim_names == ("frames", "rows") and mesh.mesh.tolist() == [[0]]
        with pytest.raises(ValueError, match="2x1"):
            multihost.make_global_mesh(2, 1)
    finally:
        dist.destroy_process_group()
        multihost._DEVICE = None


def test_meshes_need_a_group():
    from hevcasm_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    for make in (multihost.make_global_mesh, make_mesh):
        with pytest.raises(RuntimeError, match="no process group"):
            make(1, 1)
