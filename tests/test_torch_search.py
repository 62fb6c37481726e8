"""Integer motion search of hevcasm_tpu_torch against hevcasm_tpu on the CPU:
the plain version of kernel K1 (ssd_grid_plane) against the JAX kernel in
interpret mode and against the JAX SSD grid on gathered windows, and the
search functions of encode.motion with their first-minimum tie-break.
The kernel itself is held against its plain version in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.kernels.search_pallas import ssd_grid_plane as jax_ssd_grid_plane

from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.kernels import search
from hevcasm_tpu_torch.ops.ssd import ssd_grid


@pytest.fixture
def rng():
    return np.random.default_rng(0x4B31)


def gathered(plane, grid, r):
    """The (n, 64 + 2R, 64 + 2R) windows of a plane padded by R."""
    gr, gc = grid
    s = 64 + 2 * r
    return np.stack([plane[64 * i : 64 * i + s, 64 * j : 64 * j + s]
                     for i in range(gr) for j in range(gc)])


def test_plain_k1_matches_jax_kernel(rng):
    # The geometry of tests/test_search_pallas.py: a 2x4 grid at R = 32.
    gr, gc = 2, 4
    plane = rng.integers(0, 256, (gr * 64 + 64, gc * 64 + 64), dtype=np.uint8)
    src = rng.integers(0, 256, (gr * gc, 64, 64), dtype=np.uint8)
    want = np.asarray(jax_ssd_grid_plane(src, jnp.asarray(plane), (gr, gc), 65))
    got = search.ssd_grid_plane_ref(src, plane, (gr, gc), 65)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 65, 65)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid,r", [((2, 3), 8), ((1, 5), 8), ((3, 1), 4), ((1, 3), 32)])
def test_plain_k1_matches_jax_grid_at_any_width(rng, grid, r):
    # Odd grid widths and R < 32, which the TPU kernel does not take.
    gr, gc = grid
    plane = rng.integers(0, 256, (gr * 64 + 2 * r, gc * 64 + 2 * r), dtype=np.uint8)
    src = rng.integers(0, 256, (gr * gc, 64, 64), dtype=np.uint8)
    num = 2 * r + 1
    want = np.asarray(xla_opt.ssd_grid(src, gathered(plane, grid, r), num, num))
    got = search.ssd_grid_plane(src, plane, grid, num)    # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


def test_ssd_grid_matches_jax_reference(rng):
    src = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    win = rng.integers(0, 256, (3, 16 + 12, 16 + 6), dtype=np.uint8)
    want = np.asarray(xla_opt.ssd_grid_ref(jnp.asarray(src), jnp.asarray(win), 13, 7))
    np.testing.assert_array_equal(ssd_grid(src, win, 13, 7).numpy(), want)


def test_k1_wrapper_checks_and_counts(rng):
    src = torch.as_tensor(rng.integers(0, 256, (6, 64, 64), dtype=np.uint8))
    plane = torch.zeros((2 * 64 + 16, 3 * 64 + 16), dtype=torch.uint8)
    before = search.ssd_grid_plane.launches
    search.ssd_grid_plane(src, plane, (2, 3), 17)
    assert search.ssd_grid_plane.launches == before   # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="grid"):
        search.ssd_grid_plane(src, plane, (2, 2), 17)
    with pytest.raises(ValueError, match="num"):
        search.ssd_grid_plane(src, plane, (2, 3), 67)
    with pytest.raises(ValueError, match="smaller"):
        search.ssd_grid_plane(src, plane[:-1], (2, 3), 17)


def test_windows_match_jax(rng):
    plane = rng.integers(0, 256, (200, 300), dtype=np.uint8)
    pos = rng.integers(0, 150, (5, 2)).astype(np.int32)
    pos[0] = (199, 299)                          # clamped so the window fits
    want = jmotion.extract_windows(jnp.asarray(plane), jnp.asarray(pos), (40, 72))
    got = tmotion.extract_windows(plane, pos, (40, 72))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jmotion.extract_aligned_windows(jnp.asarray(plane), (3, 3), (2, 3), 32, 96)
    got = tmotion.extract_aligned_windows(torch.as_tensor(plane), (3, 3), (2, 3), 32, 96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmotion.ctu_positions(2, 3, 64).numpy(),
                                  np.asarray(jmotion.ctu_positions(2, 3, 64)))


def _jax_full_search(src, ref, r, grid):
    from hevcasm_tpu import registry as jregistry

    pl, pr = r + jmotion.PAD_L, r + jmotion.PAD_R
    padded = np.pad(ref, ((pl, pr), (pl, pr)), mode="edge")
    pos = jmotion.ctu_positions(*grid, 64)
    mv, best = jmotion.full_search(jnp.asarray(src), jnp.asarray(padded), pos, r,
                                   grid_fn=jregistry.get("ssd_grid"), grid=grid)
    return np.asarray(mv), np.asarray(best), padded


@pytest.mark.parametrize("content", ["constant", "random"])
@pytest.mark.parametrize("r", [8, 32])
def test_full_search_slab_matches_jax_full_search(rng, content, r):
    grid = (2, 3)
    h, w = 64 * grid[0], 64 * grid[1]
    if content == "constant":
        # Every candidate ties: the first minimum is (-R, -R).
        ref = np.full((h, w), 131, dtype=np.uint8)
    else:
        ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    src = tctu.tile_frame(torch.as_tensor(cur), 64)
    mv_j, best_j, padded = _jax_full_search(src.numpy(), ref, r, grid)
    mv_s, best_s = tmotion.full_search_slab(src, torch.as_tensor(padded), r, grid)
    pos = tmotion.ctu_positions(*grid, 64)
    mv_g, best_g = tmotion.full_search(src, torch.as_tensor(padded), pos, r, grid=grid)
    for mv, best in ((mv_s, best_s), (mv_g, best_g)):
        assert mv.dtype == torch.int32 and best.dtype == torch.int32
        np.testing.assert_array_equal(mv.numpy(), mv_j)
        np.testing.assert_array_equal(best.numpy(), best_j)
    if content == "constant":
        assert (mv_s == -r).all()


def test_first_min_takes_the_smallest_index():
    from hevcasm_tpu_torch.utils.tensor import first_min

    costs = torch.tensor([[5, 3, 3, 9], [7, 7, 7, 7], [4, 2, 8, 2]], dtype=torch.int32)
    idx, val = first_min(costs)
    assert idx.tolist() == [1, 0, 1] and val.tolist() == [3, 7, 2]
