"""hevcasm_tpu_torch.parallel.scaling (the counterpart of bench_scaling.py)
on a gloo world of two CPU processes at --scale dryrun: its JSON lines
carry bench_scaling.py's keys and more, and each config's reconstruction
checksum equals that of hevcasm_tpu's sharded program on the same clip.
One spawned world (~15 s on one worker)."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.parallel import (encode_gop_closed_loop_spatial, encode_gop_data_parallel,
                                  make_mesh)
import torch_testing  # noqa: F401
from hevcasm_tpu_torch.parallel import scaling

BENCH_SCALING_KEYS = {"config", "desc", "platform", "scale", "fps_1dev", "fps_ndev",
                      "scaling_efficiency"}


@pytest.fixture(scope="module")
def rows():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scaling.main(["--ranks", "2", "--scale", "dryrun", "--reps", "1", "--device",
                           "cpu"])
    assert rc == 0
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


def test_keys(rows):
    assert [r["config"] for r in rows] == [4, 5]
    for r in rows:
        assert set(r) == BENCH_SCALING_KEYS | {"cards", "backend", "timer", "checksum"}
        assert (r["platform"], r["cards"], r["backend"], r["timer"]) == (
            "cpu", 0, "gloo", "host_clock")
        assert r["fps_1dev"] > 0 and r["fps_ndev"] > 0 and r["scaling_efficiency"] > 0


def test_checksums_match_jax(rows):
    rng = np.random.default_rng(0)
    cfg = JaxConfig(search_range=8, qp=32, inter_impl="fused_dma")
    f4 = jnp.asarray(scaling.clip(rng, 3, 256, 384))
    want4 = encode_gop_data_parallel(f4, make_mesh(frames=2, rows=1), cfg)["recon"]
    f5 = jnp.asarray(scaling.clip(rng, 6, 256, 384))
    want5 = encode_gop_closed_loop_spatial(
        f5, make_mesh(frames=1, rows=1, devices=jax.devices()[:1]), cfg)["recon"]
    assert [r["checksum"] for r in rows] == [int(np.asarray(want4, np.int64).sum()),
                                             int(np.asarray(want5, np.int64).sum())]
    assert rows[0]["desc"] == "256x384 3-frame GOP dp over 2 ranks"
    assert rows[1]["desc"] == "256x384 6-frame closed-loop GOP, 1-way spatial"


def test_shapes_follow_bench_scaling():
    assert scaling._shapes(4, "full", 8) == (9, 1088, 1920, 32, 1)
    assert scaling._shapes(5, "full", 2) == (32, 2176, 3840, 32, 2)
    assert scaling._shapes(5, "dryrun", 8) == (6, 1024, 384, 8, 4)
