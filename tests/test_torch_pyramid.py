"""The pyramid search of hevcasm_tpu_torch (encode.motion.pyramid_search and
its 4x decimation) against hevcasm_tpu's on the CPU, for both metrics, at
R = 32, 16 and 8 (aligned and gathered coarse windows), with the CTU grid
given and not.  MVs and best scores must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.ops.sad import sad_grid as jax_sad_grid

from torch_testing import jax_once
from hevcasm_tpu_torch import Tier
from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.encode import motion as tmotion

H, W = 128, 192
JAX_GRID = {"sad": jax_sad_grid, "ssd": xla_opt.ssd_grid}


def frames(content, seed=0):
    """(cur, ref) uint8: "shift" moves noise by (6, -9) pixels, past the
    coarse level's first candidates; "pan" is a smooth picture panned by
    (13, 10) with noise, so the two levels disagree in places."""
    rng = np.random.default_rng(seed)
    if content == "shift":
        base = rng.integers(0, 256, (H + 64, W + 64), dtype=np.uint8)
        return base[38:38 + H, 23:23 + W].copy(), base[32:32 + H, 32:32 + W].copy()
    y, x = np.mgrid[0:H + 64, 0:W + 64].astype(np.float64)
    pic = 128 + 70 * np.sin(x / 9 + y / 13) + 40 * np.cos(x / 19 - y / 7)
    pic = np.clip(np.rint(pic + rng.normal(0, 6, pic.shape)), 0, 255).astype(np.uint8)
    return pic[45:45 + H, 42:42 + W].copy(), pic[32:32 + H, 32:32 + W].copy()


def jax_pyramid(content, r, metric, with_grid):
    def run():
        cur, ref = frames(content)
        src = jctu.tile_frame(jnp.asarray(cur), 64)
        padded = jctu.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
        pos = jmotion.ctu_positions(H // 64, W // 64, 64)
        mv, best = jmotion.pyramid_search(src, jnp.asarray(ref), padded, pos, r,
                                          grid_fn=JAX_GRID[metric],
                                          grid=(H // 64, W // 64) if with_grid else None)
        return np.asarray(mv), np.asarray(best)

    return jax_once((content, r, metric, with_grid), run)


@pytest.mark.parametrize("with_grid", [True, False])
@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("r", [32, 16, 8])
def test_pyramid_search_matches_jax(r, metric, with_grid):
    cur, ref = frames("pan")
    src = tctu.tile_frame(torch.as_tensor(cur), 64).contiguous()
    padded = tctu.pad_frame(torch.as_tensor(ref), r + 3, r + 4, r + 3, r + 4)
    pos = tmotion.ctu_positions(H // 64, W // 64, 64)
    mv, best = tmotion.pyramid_search(src, torch.as_tensor(ref), padded, pos, r,
                                      grid_fn=tmotion.grid_metric_fn(metric, Tier.REF),
                                      grid=(H // 64, W // 64) if with_grid else None)
    assert mv.dtype == best.dtype == torch.int32
    want_mv, want_best = jax_pyramid("pan", r, metric, with_grid)
    np.testing.assert_array_equal(mv.numpy(), want_mv)
    np.testing.assert_array_equal(best.numpy(), want_best)


@pytest.mark.parametrize("r", [32, 8])
def test_pyramid_finds_a_shift_beyond_the_fine_range(r):
    # (6, -9) lies outside +-3 of zero: only the coarse level can find it,
    # and at R = 8 the clip to +-(R - 3) holds the coarse MV in range.
    cur, ref = frames("shift")
    src = tctu.tile_frame(torch.as_tensor(cur), 64).contiguous()
    padded = tctu.pad_frame(torch.as_tensor(ref), r + 3, r + 4, r + 3, r + 4)
    pos = tmotion.ctu_positions(H // 64, W // 64, 64)
    mv, best = tmotion.pyramid_search(src, torch.as_tensor(ref), padded, pos, r,
                                      grid_fn=tmotion.grid_metric_fn("sad", Tier.REF),
                                      grid=(H // 64, W // 64))
    want_mv, want_best = jax_pyramid("shift", r, "sad", True)
    np.testing.assert_array_equal(mv.numpy(), want_mv)
    np.testing.assert_array_equal(best.numpy(), want_best)
    if r == 32:
        assert (mv.numpy() == [6, -9]).all()


@pytest.mark.parametrize("shape", [(128, 192), (3, 64, 64), (2, 2, 16, 8)])
def test_downsample4_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = tmotion._downsample4(torch.as_tensor(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmotion._downsample4(jnp.asarray(x))))
