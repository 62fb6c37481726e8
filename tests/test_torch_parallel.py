"""hevcasm_tpu_torch.parallel against hevcasm_tpu.parallel on the CPU.

The port's sharded entry points run in gloo worlds of 2 and 4 CPU
processes (parallel.launch.spawn; the rank programs are in
tests/torch_parallel_ranks.py, which imports no jax); JAX's run on its
8-virtual-device CPU mesh.  Integers are bit-equal, PSNRs within 1e-3 dB.
Three spawned worlds in all (~25 s on one worker).
"""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_testing  # noqa: F401
import torch_parallel_ranks as ranks
from hevcasm_tpu import config as jax_config
from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.parallel import (encode_gop_closed_loop_spatial, encode_gop_data_parallel,
                                  encode_inter_frame_spatial, encode_p_frames_batch, make_mesh)
from hevcasm_tpu_torch import DEFAULT, Config, Tier
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.parallel import encode_p_frames_batch as port_p_frames_batch
from hevcasm_tpu_torch.parallel import dryrun, launch


def _clip(rng, t, h, w):
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t), dtype=np.uint8)
    return np.stack([base[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(t)])


def _inputs_two():
    rng = np.random.default_rng(0x48455643)
    rand = _clip(rng, 2, 256, 128)
    h, w, r = 256, 128, 8
    base = rng.integers(0, 256, (h + 2 * r, w + 2 * r), dtype=np.uint8)
    dy6 = (base[r + 6:r + 6 + h, r:r + w].copy(), base[r:r + h, r:r + w].copy())
    fast = (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h, w), dtype=np.uint8))
    return {"rand": (rand[1], rand[0]), "dy6": dy6, "fast": fast,
            "gop": _clip(rng, 4, 256, 128)}


def _inputs_four():
    rng = np.random.default_rng(7)
    bands = _clip(rng, 2, 256, 128)
    return {"dp": _clip(rng, 5, 128, 128), "bands4": (bands[1], bands[0])}


@pytest.fixture(scope="module")
def two():
    inputs = _inputs_two()
    return inputs, launch.spawn(ranks.two_ranks, 2, device="cpu", args=(inputs,),
                                timeout_s=300)


@pytest.fixture(scope="module")
def four():
    inputs = _inputs_four()
    return inputs, launch.spawn(ranks.four_ranks, 4, device="cpu", args=(inputs,),
                                timeout_s=300)


def _jax_spatial(cur, ref, frames, rows, cfg):
    mesh = make_mesh(frames=frames, rows=rows)
    sh = NamedSharding(mesh, P("rows", None))
    out = encode_inter_frame_spatial(jax.device_put(jnp.asarray(cur), sh),
                                     jax.device_put(jnp.asarray(ref), sh), mesh, cfg)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same(got: dict, want: dict, keys):
    assert set(got) >= set(keys)
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k == "psnr_db":
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-3, err_msg=k)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


SPATIAL_KEYS = ("recon", "sad", "nnz", "psnr_db")


@pytest.mark.parametrize("case", ["rand", "dy6"])
def test_spatial_frame_matches_jax(two, case):
    inputs, outs = two
    want = _jax_spatial(*inputs[case], 4, 2, JaxConfig(search_range=8, qp=32))
    assert set(outs[0][case]) == set(want) == set(SPATIAL_KEYS)
    for out in outs:
        _assert_same(out[case], want, SPATIAL_KEYS)


@pytest.mark.parametrize("impl", ["fused_batched", "fused_dma", "mega"])
def test_spatial_frame_under_inter_impl_matches_jax(two, impl):
    inputs, outs = two
    want = _jax_spatial(*inputs["fast"], 1, 2, JaxConfig(search_range=4, qp=32,
                                                         inter_impl=impl))
    for out in outs:
        _assert_same(out[impl], want, SPATIAL_KEYS)


def test_closed_loop_spatial_gop_matches_jax(two):
    inputs, outs = two
    want = encode_gop_closed_loop_spatial(jnp.asarray(inputs["gop"]), make_mesh(4, 2),
                                          JaxConfig(search_range=8, qp=32))
    for out in outs:
        _assert_same(out["gop"], {k: np.asarray(v) for k, v in want.items()},
                     ("recon", "psnr_db"))
        assert set(out["gop"]) == {"recon", "psnr_db"}


def test_halo_exchange_moves_only_boundary_rows(two):
    _, outs = two
    # rank 0 sends its last R + 3 rows down, rank 1 its first R + 4 up.
    assert [o["halo_bytes"] for o in outs] == [(8 + 3) * 128, (8 + 4) * 128]


@pytest.mark.parametrize("what,match", [
    ("pyramid", "me_strategy='full'"), ("pu_decision", "pu_decision"),
    ("tu_sizes", "pu_decision/tu_sizes"), ("bands", "whole"), ("gop_bands", "whole"),
    ("global_mesh", "3x2"), ("make_mesh", "2x2")])
def test_spatial_refusals(two, what, match):
    _, outs = two
    for out in outs:
        assert match in out["refusals"][what]


def test_entry_points_default_to_the_card(two):
    _, outs = two
    for out in outs:
        assert "no CUDA device" in out["default_device"]


def test_multihost_in_a_world_of_two(two):
    _, outs = two
    for rank, out in enumerate(outs):
        assert (out["threads"], out["backend"], out["rank_device"]) == (1, "gloo", "cpu")
        np.testing.assert_array_equal(out["tensor"], np.arange(3) + rank)
        assert out["world_after_initialize"] == 2
        assert out["global_mesh"] == (("frames", "rows"), [[0, 1]], (0, rank))
        assert out["coordinate"] == (0, rank) and out["mesh_type"] == "cpu"


def test_data_parallel_gop_matches_jax(four):
    inputs, outs = four
    cfg = JaxConfig(search_range=4, qp=32)
    want = encode_gop_data_parallel(jnp.asarray(inputs["dp"]), make_mesh(4, 2), cfg)
    want = {k: np.asarray(v) for k, v in want.items()}
    keys = ("recon", "mvs", "sad", "nnz", "psnr_db")
    assert set(want) == set(keys)
    for out in outs:
        assert set(out["dp"]) == set(keys)
        _assert_same(out["dp"], want, keys)
        _assert_same(out["dp41"], want, keys)


def test_four_bands_match_jax(four):
    inputs, outs = four
    want = _jax_spatial(*inputs["bands4"], 2, 4, JaxConfig(search_range=8, qp=32))
    for out in outs:
        _assert_same(out["bands4"], want, SPATIAL_KEYS)


def test_mesh_over_some_ranks(four):
    inputs, outs = four
    want = _jax_spatial(*inputs["bands4"], 4, 2, JaxConfig(search_range=8, qp=32))
    for rank, out in enumerate(outs):
        if rank < 2:
            _assert_same(out["subset"], want, SPATIAL_KEYS)
        else:
            assert out["subset"] is None
        assert out["global_mesh"] == ([[0, 1], [2, 3]], (rank // 2, rank % 2))


@pytest.mark.parametrize("what,match", [("halo_refusal", "taller than a band"),
                                        ("dp_refusal", "do not split"),
                                        ("make_mesh_refusal", "3x1")])
def test_four_rank_refusals(four, what, match):
    _, outs = four
    for out in outs:
        assert match in out[what]


def test_p_frames_batch_without_a_group(rng):
    frames = _clip(rng, 4, 128, 128)
    got = port_p_frames_batch(frames[1:], frames[:-1], EncodeConfig(search_range=4, qp=32),
                              device="cpu")
    want = encode_p_frames_batch(jnp.asarray(frames[1:]), jnp.asarray(frames[:-1]),
                                 JaxConfig(search_range=4, qp=32))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    _assert_same({k: v.numpy() for k, v in got.items()}, want, tuple(want))
    with pytest.raises(ValueError):
        port_p_frames_batch(frames[1:], frames[:-2], EncodeConfig(), device="cpu")


def test_config_and_default_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.Config)}
    pf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert list(pf) == list(jf)
    assert pf.pop("tiers") == Tier.ALL
    jf.pop("tiers")
    assert pf == jf
    assert DEFAULT == Config() and DEFAULT.mesh_frames == DEFAULT.mesh_rows == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT.mesh_rows = 2


def test_dryrun_matches_jax():
    from __graft_entry__ import dryrun_multichip as jax_dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_dryrun(4)
        psnr = dryrun.dryrun_multichip(4, device="cpu")
    jax_line, port_line = buf.getvalue().strip().splitlines()
    assert jax_line.replace("4 devices", "4 ranks") == port_line
    assert set(psnr) == {"dp", "spatial", "closed"}

