"""Integer motion search of hevcasm_tpu_torch against hevcasm_tpu on the CPU:
the plain versions of kernels K1 (ssd_grid_plane), B7
(ssd_grid_plane_multi), B8 (ssd_grid) and B17 (search_mv, search_mv_dma)
against the JAX kernels in
interpret mode and against the JAX SSD grid on gathered windows, and the
search functions of encode.motion with their first-minimum tie-break.  The kernels themselves are held against their
plain versions in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.kernels.search_pallas import ssd_grid as jax_ssd_grid
from hevcasm_tpu.kernels.search_pallas import ssd_grid_plane as jax_ssd_grid_plane
from hevcasm_tpu.kernels.search_pallas import ssd_grid_plane_multi as jax_ssd_grid_plane_multi

from hevcasm_tpu_torch import Tier, registry
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


@pytest.mark.parametrize("b,ndy,ndx,extra", [(8, 17, 17, 0), (16, 9, 17, 5), (32, 13, 13, 0),
                                             (64, 9, 17, 0), (16, 17, 17, 0)])
def test_plain_b8_matches_jax_kernel(rng, b, ndy, ndx, extra):
    # hevcasm_tpu's Pallas ssd_grid in interpret mode; both take windows
    # wider than the grid needs (``extra``), and non-square grids.
    src = rng.integers(0, 256, (2, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (2, b + ndy - 1 + extra, b + ndx - 1 + extra), dtype=np.uint8)
    want = np.asarray(jax_ssd_grid(jnp.asarray(src), jnp.asarray(win), ndy, ndx))
    got = search.ssd_grid(src, win, ndy, ndx)             # CPU: the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, ndy, ndx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_b8_constant_window_ties_every_candidate(rng):
    src = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    win = np.full((3, 32, 32), 97, dtype=np.uint8)
    want = np.asarray(jax_ssd_grid(jnp.asarray(src), jnp.asarray(win), 17, 17))
    got = search.ssd_grid_ref(src, win, 17, 17)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got == got[:, :1, :1]).all())


def test_b8_wrapper_runs_the_plain_version_on_cpu_and_is_registered(rng):
    src = torch.as_tensor(rng.integers(0, 256, (4, 8, 8), dtype=np.uint8))
    win = torch.as_tensor(rng.integers(0, 256, (4, 24, 24), dtype=np.uint8))
    before = search.ssd_grid.launches
    got = search.ssd_grid(src, win, 17, 17)
    assert search.ssd_grid.launches == before            # a CPU tensor launches nothing
    assert torch.equal(got, ssd_grid(src, win, 17, 17))
    assert registry.get("ssd_grid", Tier.REF) is ssd_grid is search.ssd_grid_ref
    assert registry.tiers_of("ssd_grid") == Tier.REF | Tier.KERNEL
    assert tmotion.full_search.__defaults__[0] is search.ssd_grid


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


def test_plain_b7_matches_jax_kernel(rng):
    # tests/test_search_pallas.py's geometry: 2x2 CTUs, k = 3, R = 32.
    gr, gc, k = 2, 2, 3
    planes = rng.integers(0, 256, (k, gr * 64 + 64, gc * 64 + 64), dtype=np.uint8)
    src = rng.integers(0, 256, (gr * gc, 64, 64), dtype=np.uint8)
    want = np.asarray(jax_ssd_grid_plane_multi(src, jnp.asarray(planes), (gr, gc), 65))
    got = search.ssd_grid_plane_multi(src, planes, (gr, gc), 65)   # CPU: the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 3, 65, 65)
    np.testing.assert_array_equal(got.numpy(), want)


def test_b7_wrapper_checks_and_registry(rng):
    src = torch.as_tensor(rng.integers(0, 256, (6, 64, 64), dtype=np.uint8))
    planes = torch.zeros((2, 2 * 64 + 16, 3 * 64 + 16), dtype=torch.uint8)
    before = search.ssd_grid_plane_multi.launches
    got = search.ssd_grid_plane_multi(src, planes, (2, 3), 17)
    assert search.ssd_grid_plane_multi.launches == before
    assert torch.equal(got[:, 1], search.ssd_grid_plane(src, planes[1], (2, 3), 17))
    with pytest.raises(ValueError, match="planes"):
        search.ssd_grid_plane_multi(src, planes[0], (2, 3), 17)
    with pytest.raises(ValueError, match="smaller"):
        search.ssd_grid_plane_multi(src, planes[:, :-1], (2, 3), 17)
    assert registry.tiers_of("ssd_grid_plane_multi") == Tier.REF | Tier.KERNEL
    assert registry.get("ssd_grid_plane_multi", Tier.REF) is search.ssd_grid_plane_multi_ref


@pytest.mark.parametrize("r,metric", [(8, "ssd"), (32, "ssd"), (8, None)])
@pytest.mark.parametrize("joint", [True, False])
def test_full_search_multi_matches_jax(rng, r, metric, joint):
    # metric "ssd" takes the port's multi-plane route (B7's plain version
    # here), None the grid route; hevcasm_tpu on the CPU takes its grid
    # route.  One reference equals another by construction, so the joint
    # first minimum must take the lower index on the tie.
    from hevcasm_tpu import registry as jregistry

    grid, k = (2, 3), 3
    h, w = 64 * grid[0], 64 * grid[1]
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = [np.roll(cur, (2, -3), (0, 1)), rng.integers(0, 256, (h, w), dtype=np.uint8)]
    refs.append(refs[0].copy())
    pl, pr = r + jmotion.PAD_L, r + jmotion.PAD_R
    planes = np.stack([np.pad(p, ((pl, pr), (pl, pr)), mode="edge") for p in refs])
    src = tctu.tile_frame(torch.as_tensor(cur), 64)
    pos = jmotion.ctu_positions(*grid, 64)
    want = jmotion.full_search_multi(jnp.asarray(src.numpy()), jnp.asarray(planes), pos, r,
                                     grid_fn=jregistry.get("ssd_grid"), grid=grid,
                                     joint=joint, metric="ssd")
    got = tmotion.full_search_multi(src, torch.as_tensor(planes), np.asarray(pos), r,
                                    grid=grid, joint=joint, metric=metric)
    assert len(got) == len(want) == (3 if joint else 2)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if joint:
        assert not (got[1] == 2).any(), "a tie must go to the lower reference"


_JAX_B17 = {}


def b17_case(content):
    """192 x 256 (a 3 x 4 grid) at R = 32, as hevcasm_tpu's
    test_search_variants_match_full_search: random cur and ref, or a
    constant ref on which every candidate ties.  Returns the port's inputs
    (src, padded, pos, win) and hevcasm_tpu's (mv, best) of search_mv and
    of search_mv_dma, run in interpret mode once per content."""
    from hevcasm_tpu.encode import ctu as jctu
    from hevcasm_tpu.kernels.search_pallas import search_mv, search_mv_dma

    h, w, r = 192, 256, 32
    rng = np.random.default_rng(0xB17)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = (rng.integers(0, 256, (h, w), dtype=np.uint8) if content == "random"
           else np.full((h, w), 97, np.uint8))
    src = tctu.tile_frame(torch.as_tensor(cur), 64).contiguous()
    padded = tctu.pad_frame(torch.as_tensor(ref), r + 3, r + 4, r + 3, r + 4)
    pos = tmotion.ctu_positions(3, 4, 64)
    win = tmotion.extract_aligned_windows(padded, (3, 3), (3, 4), 64, 128)
    if content not in _JAX_B17:
        jsrc = jctu.tile_frame(jnp.asarray(cur), 64)
        jpad = jnp.asarray(padded.numpy())
        _JAX_B17[content] = {
            "mv": [np.asarray(o) for o in search_mv(jsrc, jnp.asarray(win.numpy()), 65,
                                                    group=3)],
            "dma": [np.asarray(o) for o in search_mv_dma(jsrc, jpad, jnp.asarray(pos.numpy()),
                                                         r)]}
    return (src, padded, pos, win), _JAX_B17[content]


@pytest.mark.parametrize("entry", ["mv", "dma"])
@pytest.mark.parametrize("content", ["random", "constant"])
def test_plain_b17_matches_jax_kernels(content, entry):
    (src, padded, pos, win), want = b17_case(content)
    if entry == "mv":
        got = search.search_mv_ref(src, win, 65)
    else:
        got = search.search_mv_dma_ref(src, padded, pos, 32)
    for g, w_ in zip(got, want[entry]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w_)
    if content == "constant":                 # every candidate ties: the first wins
        assert (got[0] == -32).all()


@pytest.mark.parametrize("r,grid", [(32, (2, 3)), (8, (1, 3)), (1, (2, 1))])
def test_b17_wrappers_equal_full_search_on_cpu_and_are_registered(rng, r, grid):
    gr, gc = grid
    cur = torch.as_tensor(rng.integers(0, 256, (64 * gr, 64 * gc), dtype=np.uint8))
    ref = torch.as_tensor(rng.integers(0, 256, (64 * gr, 64 * gc), dtype=np.uint8))
    src = tctu.tile_frame(cur, 64).contiguous()
    padded = tctu.pad_frame(ref, r + 3, r + 4, r + 3, r + 4)
    pos = tmotion.ctu_positions(gr, gc, 64)
    want = tmotion.full_search(src, padded, pos, r, grid=grid)
    win = tmotion.extract_windows(padded, pos + 3, 64 + 2 * r)
    before = (search.search_mv.launches, search.search_mv_dma.launches)
    for got in (search.search_mv(src, win, 2 * r + 1),
                search.search_mv_dma(src, padded, pos, r)):
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    assert (search.search_mv.launches, search.search_mv_dma.launches) == before
    for op in ("search_mv", "search_mv_dma"):
        assert registry.tiers_of(op) == Tier.REF | Tier.KERNEL
    assert registry.get("search_mv", Tier.REF) is search.search_mv_ref
    assert registry.get("search_mv_dma", Tier.REF) is search.search_mv_dma_ref
