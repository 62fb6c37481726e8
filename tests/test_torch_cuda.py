"""hevcasm_tpu_torch's CUDA kernels on a card, each against its plain
PyTorch version, bit for bit.  Every test is marked ``cuda`` and skips where
torch.cuda.is_available() is false: a CUDA kernel has no CPU mode.

This file imports neither jax nor hevcasm_tpu, so it also runs on a machine
that has only PyTorch; tests/conftest.py imports jax, so there run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from hevcasm_tpu_torch import Tier
from hevcasm_tpu_torch.encode import ctu as ctu_mod
from hevcasm_tpu_torch.encode import motion
from hevcasm_tpu_torch.encode.loop import (EncodeConfig, encode_inter_frame,
                                           encode_inter_frame_multiref)
from hevcasm_tpu_torch.encode.video import (YuvFrame, encode_b_frame_yuv,
                                            encode_inter_frame_yuv)
from hevcasm_tpu_torch.encode import partition
from hevcasm_tpu_torch import selftest
from hevcasm_tpu_torch.kernels import (base_grids, bi_fused, chroma_fused, costmap,
                                       inter_fused, mc, mega, residual_ctu, sad, search)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def random_u8(rng, shape, device):
    return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=device)


# ---- K1: ssd_grid_plane ------------------------------------------------------

@pytest.mark.parametrize("grid,r", [((2, 3), 8), ((3, 5), 32), ((1, 1), 1),
                                    ((2, 2), 17), ((17, 30), 32)])
def test_k1_matches_plain(cuda, grid, r):
    rng = np.random.default_rng(sum(grid) + r)
    gr, gc = grid
    plane = random_u8(rng, (gr * 64 + 2 * r, gc * 64 + 2 * r), cuda)
    src = random_u8(rng, (gr * gc, 64, 64), cuda)
    before = search.ssd_grid_plane.launches
    got = search.ssd_grid_plane(src, plane, grid, 2 * r + 1)
    assert search.ssd_grid_plane.launches == before + 1
    assert_bit_equal([got], [search.ssd_grid_plane_ref(src, plane, grid, 2 * r + 1)])


def test_k1_largest_sum_fits_int32(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    plane = torch.full((64 + 16, 128 + 16), 255, dtype=torch.uint8, device=cuda)
    got = search.ssd_grid_plane(src, plane, (1, 2), 17)
    assert int(got.min()) == int(got.max()) == 4096 * 255 * 255


def test_k1_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    plane = torch.zeros((64 + 16, 128 + 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        search.ssd_grid_plane(src.to(torch.int16), plane, (1, 2), 17)
    with pytest.raises(ValueError, match="contiguous"):
        search.ssd_grid_plane(src, plane[:, :-1], (1, 2), 17)


# ---- B7: ssd_grid_plane_multi ------------------------------------------------

@pytest.mark.parametrize("grid,r,k", [((2, 2), 32, 3), ((3, 5), 8, 2), ((1, 1), 1, 4),
                                      ((2, 3), 17, 1), ((17, 30), 32, 4)])
def test_b7_matches_plain(cuda, grid, r, k):
    rng = np.random.default_rng(sum(grid) + r + k)
    gr, gc = grid
    planes = random_u8(rng, (k, gr * 64 + 2 * r, gc * 64 + 2 * r), cuda)
    src = random_u8(rng, (gr * gc, 64, 64), cuda)
    before = search.ssd_grid_plane_multi.launches
    got = search.ssd_grid_plane_multi(src, planes, grid, 2 * r + 1)
    assert search.ssd_grid_plane_multi.launches == before + 1
    assert_bit_equal([got], [search.ssd_grid_plane_multi_ref(src, planes, grid, 2 * r + 1)])
    assert_bit_equal([got[:, -1]], [search.ssd_grid_plane(src, planes[-1].contiguous(), grid,
                                                          2 * r + 1)])


def test_b7_reads_a_view_of_larger_planes(cuda):
    # full_search_multi passes the loop's padded planes cut to R of padding.
    rng = np.random.default_rng(7)
    planes = random_u8(rng, (3, 2 * 64 + 2 * 8 + 7, 3 * 64 + 2 * 8 + 7), cuda)
    view = planes[:, 3:3 + 2 * 64 + 16, 3:3 + 3 * 64 + 16]
    src = random_u8(rng, (6, 64, 64), cuda)
    got = search.ssd_grid_plane_multi(src, view, (2, 3), 17)
    assert_bit_equal([got], [search.ssd_grid_plane_multi_ref(src, view.contiguous(), (2, 3),
                                                             17)])


def test_b7_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    planes = torch.zeros((2, 64 + 16, 128 + 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        search.ssd_grid_plane_multi(src, planes.to(torch.int16), (1, 2), 17)
    with pytest.raises(ValueError, match="contiguous"):
        search.ssd_grid_plane_multi(src, planes.transpose(1, 2), (1, 2), 17)
    with pytest.raises(ValueError, match="smaller"):
        search.ssd_grid_plane_multi(src, planes[:, :-1], (1, 2), 17)


@pytest.mark.parametrize("r", [1, 2, 31, 32])
@pytest.mark.parametrize("grid", [(1, 3), (2, 5)])
def test_k1_b7_tensor_core_tiling_at_every_edge_radius(cuda, r, grid):
    # R = 1, 2 (one m tile, one n tile), 31 (partial last k step and word)
    # and 32 (five m tiles, nine n tiles), on odd grid widths.
    rng = np.random.default_rng(100 * r + sum(grid))
    gr, gc = grid
    planes = random_u8(rng, (2, gr * 64 + 2 * r, gc * 64 + 2 * r), cuda)
    src = random_u8(rng, (gr * gc, 64, 64), cuda)
    num = 2 * r + 1
    assert_bit_equal([search.ssd_grid_plane(src, planes[1], grid, num)],
                     [search.ssd_grid_plane_ref(src, planes[1], grid, num)])
    assert_bit_equal([search.ssd_grid_plane_multi(src, planes, grid, num)],
                     [search.ssd_grid_plane_multi_ref(src, planes, grid, num)])


@pytest.mark.parametrize("src_value,plane_value,want", [(0, 255, 4096 * 255 * 255),
                                                         (255, 255, 0), (255, 0, 4096 * 255 * 255)])
@pytest.mark.parametrize("r", [1, 2, 31, 32])
def test_k1_b7_extremes_are_exact(cuda, r, src_value, plane_value, want):
    src = torch.full((3, 64, 64), src_value, dtype=torch.uint8, device=cuda)
    planes = torch.full((2, 64 + 2 * r, 3 * 64 + 2 * r), plane_value, dtype=torch.uint8,
                        device=cuda)
    got = [search.ssd_grid_plane(src, planes[0], (1, 3), 2 * r + 1),
           search.ssd_grid_plane_multi(src, planes, (1, 3), 2 * r + 1)]
    for g in got:
        assert int(g.min()) == int(g.max()) == want
    assert_bit_equal(got, [search.ssd_grid_plane_ref(src, planes[0], (1, 3), 2 * r + 1),
                           search.ssd_grid_plane_multi_ref(src, planes, (1, 3), 2 * r + 1)])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_b7_plane_views_at_every_k(cuda, k):
    # Views at an odd offset of larger planes: unaligned rows and plane starts.
    rng = np.random.default_rng(40 + k)
    r, grid = 32, (2, 3)
    big = random_u8(rng, (k + 1, 2 * 64 + 2 * r + 9, 3 * 64 + 2 * r + 11), cuda)
    view = big[1:, 3:3 + 2 * 64 + 2 * r, 5:5 + 3 * 64 + 2 * r]
    src = random_u8(rng, (6, 64, 64), cuda)
    got = search.ssd_grid_plane_multi(src, view, grid, 2 * r + 1)
    assert_bit_equal([got], [search.ssd_grid_plane_multi_ref(src, view, grid, 2 * r + 1)])
    for p in range(k):
        assert_bit_equal([got[:, p]], [search.ssd_grid_plane(src, view[p].contiguous(), grid,
                                                             2 * r + 1)])


@pytest.mark.parametrize("joint", [True, False])
def test_full_search_multi_launches_b7_and_matches_the_grid_route(cuda, joint):
    rng = np.random.default_rng(3)
    refs = random_u8(rng, (3, 128, 192), cuda)
    cur = random_u8(rng, (128, 192), cuda)
    src = ctu_mod.tile_frame(cur, 64).contiguous()
    planes = torch.stack([ctu_mod.pad_frame(p, 11, 12, 11, 12) for p in refs])
    pos = motion.ctu_positions(2, 3, 64, cuda)
    before = (search.ssd_grid_plane_multi.launches, search.ssd_grid.launches)
    got = motion.full_search_multi(src, planes, pos, 8, grid=(2, 3), joint=joint,
                                   metric="ssd")
    assert (search.ssd_grid_plane_multi.launches, search.ssd_grid.launches) == \
        (before[0] + 1, before[1])
    want = motion.full_search_multi(src, planes, pos, 8, grid_fn=search.ssd_grid_ref,
                                    grid=(2, 3), joint=joint)       # the grid route
    assert_bit_equal(got, want)


# ---- B8: ssd_grid ------------------------------------------------------------

@pytest.mark.parametrize("b,n,ndy,ndx,extra", [
    (8, 37, 65, 65, 0), (16, 21, 65, 65, 0), (16, 50, 33, 33, 3), (32, 5, 17, 9, 0),
    (64, 3, 65, 65, 0), (64, 2, 129, 129, 0), (8, 9, 5, 7, 2), (16, 8160, 33, 33, 0),
    (8, 32640, 33, 33, 0), (16, 510, 17, 17, 0), (64, 510, 7, 7, 0), (8, 3, 249, 249, 0),
    (64, 2, 193, 150, 1), (16, 7, 97, 161, 0)])
def test_b8_matches_plain(cuda, b, n, ndy, ndx, extra):
    # The path shapes (the PU decision's 8160 16x16 and 32640 8x8 blocks at
    # R = 16, the pyramid's two levels) and windows up to 256 wide, which
    # tile the m and n ranges over blocks.
    rng = np.random.default_rng(b + n + ndy)
    src = random_u8(rng, (n, b, b), cuda)
    win = random_u8(rng, (n, b + ndy - 1 + extra, b + ndx - 1 + extra + 11), cuda)
    win = win[:, :, :b + ndx - 1 + extra]              # rows further apart than wide
    before = search.ssd_grid.launches
    got = search.ssd_grid(src, win, ndy, ndx)
    assert search.ssd_grid.launches == before + 1
    assert_bit_equal([got], [search.ssd_grid_ref(src, win, ndy, ndx)])


def test_b8_constant_window_ties_and_largest_sum_fits_int32(cuda):
    rng = np.random.default_rng(8)
    src = random_u8(rng, (6, 16, 16), cuda)
    win = torch.full((6, 80, 80), 97, dtype=torch.uint8, device=cuda)
    got = search.ssd_grid(src, win, 65, 65)
    assert bool((got == got[:, :1, :1]).all())
    assert_bit_equal([got], [search.ssd_grid_ref(src, win, 65, 65)])
    zeros = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    got = search.ssd_grid(zeros, torch.full((2, 80, 80), 255, dtype=torch.uint8, device=cuda),
                          17, 17)
    assert int(got.min()) == int(got.max()) == 4096 * 255 * 255


@pytest.mark.parametrize("num", [1, 7, 17, 33, 65])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b8_tensor_core_tiling_at_every_block_side_and_count(cuda, b, num):
    # Windows cut from wider rows at an odd byte offset: unaligned rows and
    # base pointers; num_dy != num_dx as well.
    rng = np.random.default_rng(11 * b + num)
    n = 5
    src = random_u8(rng, (n, b, b), cuda)
    wide = random_u8(rng, (n, b + num + 2, b + num + 12), cuda)
    win = wide[:, 1:, 3:3 + b + num - 1]
    for ndy, ndx in ((num, num), (num, max(1, num - 6)), (max(1, num // 2), num)):
        before = search.ssd_grid.launches
        got = search.ssd_grid(src, win, ndy, ndx)
        assert search.ssd_grid.launches == before + 1
        assert_bit_equal([got], [search.ssd_grid_ref(src, win, ndy, ndx)])


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b8_extremes_at_every_block_side(cuda, b):
    for sv, wv in ((0, 255), (255, 0), (255, 255)):
        src = torch.full((3, b, b), sv, dtype=torch.uint8, device=cuda)
        win = torch.full((3, b + 64, b + 64), wv, dtype=torch.uint8, device=cuda)
        got = search.ssd_grid(src, win, 65, 65)
        assert int(got.min()) == int(got.max()) == b * b * (sv - wv) ** 2


def test_b8_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    win = torch.zeros((2, 32, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        search.ssd_grid(src.to(torch.int16), win, 17, 17)
    with pytest.raises(ValueError, match="b in"):
        search.ssd_grid(src[:, :12, :12].contiguous(), win, 17, 17)
    with pytest.raises(ValueError, match="window must be"):
        search.ssd_grid(src, win[:, :31], 17, 17)
    with pytest.raises(ValueError, match="256"):
        search.ssd_grid(src, torch.zeros((2, 300, 300), dtype=torch.uint8, device=cuda),
                        260, 260)
    with pytest.raises(ValueError, match="contiguous"):
        search.ssd_grid(src, win.transpose(1, 2), 17, 17)


# ---- B9: sad_grid ------------------------------------------------------------

@pytest.mark.parametrize("b,n,ndy,ndx,extra", [
    (8, 37, 65, 65, 0), (16, 21, 65, 65, 0), (16, 510, 17, 17, 0), (32, 5, 17, 9, 0),
    (64, 3, 65, 65, 0), (64, 510, 7, 7, 0), (64, 2, 129, 129, 0), (8, 9, 5, 7, 2),
    (16, 8160, 65, 65, 0)])
def test_b9_matches_plain(cuda, b, n, ndy, ndx, extra):
    rng = np.random.default_rng(b + n + ndy + 9)
    src = random_u8(rng, (n, b, b), cuda)
    win = random_u8(rng, (n, b + ndy - 1 + extra, b + ndx - 1 + extra + 11), cuda)
    win = win[:, :, :b + ndx - 1 + extra]              # rows further apart than wide
    before = sad.sad_grid.launches
    got = sad.sad_grid(src, win, ndy, ndx)
    assert sad.sad_grid.launches == before + 1
    assert_bit_equal([got], [sad.sad_grid_ref(src, win, ndy, ndx)])


def test_b9_constant_window_ties_and_largest_sum(cuda):
    rng = np.random.default_rng(9)
    src = random_u8(rng, (6, 16, 16), cuda)
    win = torch.full((6, 80, 80), 97, dtype=torch.uint8, device=cuda)
    got = sad.sad_grid(src, win, 65, 65)
    assert bool((got == got[:, :1, :1]).all())
    assert_bit_equal([got], [sad.sad_grid_ref(src, win, 65, 65)])
    zeros = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    got = sad.sad_grid(zeros, torch.full((2, 80, 80), 255, dtype=torch.uint8, device=cuda),
                       17, 17)
    assert int(got.min()) == int(got.max()) == 4096 * 255


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b8_b9_agree_where_the_square_is_the_absolute_value(cuda, b):
    # On 0/1 pixels d^2 == |d|: B8's and B9's grids are one grid.
    rng = np.random.default_rng(b)
    src = torch.as_tensor(rng.integers(0, 2, (7, b, b), dtype=np.uint8), device=cuda)
    win = torch.as_tensor(rng.integers(0, 2, (7, b + 32, b + 32), dtype=np.uint8), device=cuda)
    assert_bit_equal([sad.sad_grid(src, win, 33, 33)], [search.ssd_grid(src, win, 33, 33)])


@pytest.mark.parametrize("num", [1, 7, 17, 33, 65])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b9_packed_classes_at_every_block_side_and_count(cuda, b, num):
    # Windows cut from wider rows at an odd byte offset: unaligned rows and
    # base pointers, read through the byte-masked staging.
    rng = np.random.default_rng(7 * b + num)
    n = 5
    src = random_u8(rng, (n, b, b), cuda)
    wide = random_u8(rng, (n, b + num + 2, b + num + 12), cuda)
    win = wide[:, 1:, 3:3 + b + num - 1]
    before = sad.sad_grid.launches
    got = sad.sad_grid(src, win, num, num)
    assert sad.sad_grid.launches == before + 1
    assert_bit_equal([got], [sad.sad_grid_ref(src, win, num, num)])


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b9_extremes_at_every_block_side(cuda, b):
    for sv, wv in ((0, 255), (255, 0), (255, 255)):
        src = torch.full((3, b, b), sv, dtype=torch.uint8, device=cuda)
        win = torch.full((3, b + 64, b + 64), wv, dtype=torch.uint8, device=cuda)
        got = sad.sad_grid(src, win, 65, 65)
        assert int(got.min()) == int(got.max()) == b * b * abs(sv - wv)


def test_b9_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    win = torch.zeros((2, 32, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        sad.sad_grid(src.to(torch.int16), win, 17, 17)
    with pytest.raises(ValueError, match="b in"):
        sad.sad_grid(src[:, :12, :12].contiguous(), win, 17, 17)
    with pytest.raises(ValueError, match="window must be"):
        sad.sad_grid(src, win[:, :31], 17, 17)
    with pytest.raises(ValueError, match="256"):
        sad.sad_grid(src, torch.zeros((2, 300, 300), dtype=torch.uint8, device=cuda), 260, 260)
    with pytest.raises(ValueError, match="contiguous"):
        sad.sad_grid(src, win.transpose(1, 2), 17, 17)


# ---- B17: search_mv and search_mv_dma -----------------------------------------

def b17_case(grid, r, seed, device, constant=False):
    rng = np.random.default_rng(seed)
    gr, gc = grid
    cur = random_u8(rng, (64 * gr, 64 * gc), device)
    ref = (torch.full_like(cur, 97) if constant else random_u8(rng, (64 * gr, 64 * gc), device))
    src = ctu_mod.tile_frame(cur, 64).contiguous()
    padded = ctu_mod.pad_frame(ref, r + 3, r + 4, r + 3, r + 4)
    pos = motion.ctu_positions(gr, gc, 64, device)
    return src, padded, pos


@pytest.mark.parametrize("grid,r", [((3, 4), 32), ((2, 3), 8), ((1, 1), 1), ((2, 1), 17),
                                    ((17, 30), 32), ((1, 5), 31)])
def test_b17_matches_plain(cuda, grid, r):
    src, padded, pos = b17_case(grid, r, sum(grid) + r, cuda)
    want = search.search_mv_dma_ref(src, padded, pos, r)
    win = motion.extract_windows(padded, pos + 3, 64 + 2 * r)
    before = (search.search_mv.launches, search.search_mv_dma.launches)
    assert_bit_equal(search.search_mv_dma(src, padded, pos, r), want)
    assert_bit_equal(search.search_mv(src, win, 2 * r + 1), want)
    assert (search.search_mv.launches, search.search_mv_dma.launches) == \
        (before[0] + 1, before[1] + 1)
    assert_bit_equal(want, motion.full_search(src, padded, pos, r, grid_fn=search.ssd_grid_ref))


def test_b17_constant_plane_takes_the_first_candidate(cuda):
    src, padded, pos = b17_case((2, 3), 32, 1, cuda, constant=True)
    for got in (search.search_mv_dma(src, padded, pos, 32),
                search.search_mv(src, motion.extract_windows(padded, pos + 3, 128), 65)):
        assert bool((got[0] == -32).all())
        assert_bit_equal(got, search.search_mv_dma_ref(src, padded, pos, 32))


def test_b17_clamps_windows_past_the_plane_like_the_plain_version(cuda):
    src, padded, pos = b17_case((2, 2), 8, 2, cuda)
    far = (pos * 3 + 40).to(torch.int32)                   # starts past the plane's end
    assert_bit_equal(search.search_mv_dma(src, padded, far, 8),
                     search.search_mv_dma_ref(src, padded, far, 8))


def test_b17_rejects_what_it_does_not_take(cuda):
    src, padded, pos = b17_case((1, 2), 8, 3, cuda)
    win = motion.extract_windows(padded, pos + 3, 80)
    with pytest.raises(ValueError, match="1 <= R"):
        search.search_mv_dma(src, ctu_mod.pad_frame(padded, 40, 40, 40, 40), pos, 40)
    with pytest.raises(ValueError, match="num"):
        search.search_mv(src, win, 16)
    with pytest.raises(ValueError, match="windows must be"):
        search.search_mv(src, win[:, :79], 17)
    with pytest.raises(ValueError, match="contiguous"):
        search.search_mv(src, win.transpose(1, 2), 17)
    with pytest.raises(TypeError):
        search.search_mv_dma(src, padded.to(torch.int16), pos, 8)
    with pytest.raises(ValueError, match="int32"):
        search.search_mv_dma(src, padded, pos.long(), 8)


# ---- B19: encode_ctu_mega ------------------------------------------------------

MEGA_QARGS = (*EncodeConfig(qp=32).quant_params(False), *EncodeConfig(qp=32).dequant_params())


@pytest.mark.parametrize("grid,r", [((3, 4), 32), ((2, 3), 8), ((2, 2), 16), ((1, 3), 24),
                                    ((17, 30), 32)])
def test_b19_matches_plain(cuda, grid, r):
    src, padded, pos = b17_case(grid, r, sum(grid) + r + 19, cuda)
    before = mega.encode_ctu_mega.launches
    got = mega.encode_ctu_mega(src, padded, pos, r, *MEGA_QARGS)
    assert mega.encode_ctu_mega.launches == before + 1
    want = mega.encode_ctu_mega_ref(src, padded, pos, r, *MEGA_QARGS)
    assert_bit_equal(got, want)
    # The search is B17's and the refinement + residual K2's.
    assert_bit_equal(got[1:4:2], search.search_mv_dma_ref(src, padded, pos, r))


def test_b19_constant_plane_takes_the_first_candidate_and_fraction(cuda):
    src, padded, pos = b17_case((2, 3), 32, 4, cuda, constant=True)
    got = mega.encode_ctu_mega(src, padded, pos, 32, *MEGA_QARGS)
    assert bool((got[1] == -32).all()) and not bool(got[2].any())
    assert_bit_equal(got, mega.encode_ctu_mega_ref(src, padded, pos, 32, *MEGA_QARGS))


def test_b19_rejects_what_it_does_not_take(cuda):
    src, padded, pos = b17_case((1, 2), 8, 5, cuda)
    with pytest.raises(ValueError, match="8, 16, 24, 32"):
        mega.encode_ctu_mega(src, padded, pos, 12, *MEGA_QARGS)
    with pytest.raises(TypeError):
        mega.encode_ctu_mega(src, padded, pos.long(), 8, *MEGA_QARGS)
    with pytest.raises(ValueError, match="contiguous"):
        mega.encode_ctu_mega(src, padded.t(), pos, 8, *MEGA_QARGS)
    with pytest.raises(ValueError, match="shift"):
        mega.encode_ctu_mega(src, padded, pos, 8, MEGA_QARGS[0], 40, *MEGA_QARGS[2:])


# ---- K2: inter_ctu_fused_dma -------------------------------------------------

def k2_case(seed, r, qp, h, w, device):
    """A random frame, the loop's padded plane, and refine offsets for random
    MVs with the first CTU at offset (0, 0) and the last at the maximum."""
    rng = np.random.default_rng(seed)
    src = ctu_mod.tile_frame(random_u8(rng, (h, w), device), 64).contiguous()
    plane = ctu_mod.pad_frame(random_u8(rng, (h, w), device), r + 3, r + 4, r + 3, r + 4)
    mvs = rng.integers(-r, r + 1, (src.shape[0], 2)).astype(np.int32)
    mvs[0], mvs[-1] = (-r, -r), (r, r)
    pos = motion.ctu_positions(h // 64, w // 64, 64, device)
    offsets = (pos + torch.as_tensor(mvs, device=device) + r).to(torch.int32).contiguous()
    cfg = EncodeConfig(qp=qp, inter_impl="fused_dma")
    return src, plane, offsets, (*cfg.quant_params(False), *cfg.dequant_params())


@pytest.mark.parametrize("seed,r,qp,h,w", [
    (13, 8, 32, 128, 192), (2, 32, 0, 256, 320), (7, 32, 22, 192, 128),
    (9, 32, 51, 1088, 1920)])
def test_k2_matches_plain(cuda, seed, r, qp, h, w):
    src, plane, offsets, qargs = k2_case(seed, r, qp, h, w, cuda)
    before = inter_fused.inter_ctu_fused_dma.launches
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert inter_fused.inter_ctu_fused_dma.launches == before + 1
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))


def test_k2_constant_plane_takes_the_first_fraction(cuda):
    src, plane, offsets, qargs = k2_case(4, 8, 32, 128, 192, cuda)
    plane = torch.full_like(plane, 97)
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert int(got[1].abs().max()) == 0              # every fraction ties
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))


@pytest.mark.parametrize("invert", [False, True])
def test_k2_b16_adversarial_windows_reach_the_intermediate_extremes(cuda, invert):
    src, plane, offsets, qargs = k2_case(6, 32, 32, 192, 256, cuda)
    plane = chip_smoke.adversarial_plane(plane.shape, cuda, invert)
    src = (src > 127).to(torch.uint8) * 255
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))
    win = motion.extract_windows(plane, offsets, 71)
    assert_bit_equal(inter_fused.inter_ctu_fused(src, win, *qargs), got)
    assert_bit_equal(inter_fused.inter_ctu_fused_batched(src, win, *qargs, group=4), got)


def test_k2_rejects_what_it_does_not_take(cuda):
    src, plane, offsets, qargs = k2_case(1, 8, 32, 128, 192, cuda)
    with pytest.raises(TypeError):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets.long(), *qargs)
    with pytest.raises(ValueError, match="shift"):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets, qargs[0], 15, *qargs[2:])


# ---- B16: inter_ctu_fused and inter_ctu_fused_batched -------------------------

@pytest.mark.parametrize("seed,r,qp,h,w,extra", [
    (13, 8, 32, 128, 192, 0), (2, 32, 22, 256, 320, 57), (9, 32, 51, 1088, 1920, 0)])
def test_b16_matches_plain(cuda, seed, r, qp, h, w, extra):
    src, plane, offsets, qargs = k2_case(seed, r, qp, h, w, cuda)
    wide = ctu_mod.pad_frame(plane, 0, extra, 0, extra)
    win = motion.extract_windows(wide, offsets, 71 + extra)
    before = inter_fused.inter_ctu_fused.launches
    got = inter_fused.inter_ctu_fused(src, win, *qargs)
    assert inter_fused.inter_ctu_fused.launches == before + 1
    assert_bit_equal(got, inter_fused.inter_ctu_fused_ref(src, win, *qargs))
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs))
    for group in (4, 7):                                 # n % group != 0 for 6 and 510
        batched = inter_fused.inter_ctu_fused_batched(src, win, *qargs, group=group)
        assert_bit_equal(batched, got)
    assert inter_fused.inter_ctu_fused.launches == before + 3


def test_b16_rejects_what_it_does_not_take(cuda):
    src, plane, offsets, qargs = k2_case(1, 8, 32, 128, 192, cuda)
    win = motion.extract_windows(plane, offsets, 71)
    with pytest.raises(TypeError):
        inter_fused.inter_ctu_fused(src, win.to(torch.int16), *qargs)
    with pytest.raises(ValueError, match="contiguous"):
        inter_fused.inter_ctu_fused(src, win.transpose(1, 2), *qargs)
    with pytest.raises(ValueError, match="windows"):
        inter_fused.inter_ctu_fused(src, win[:, :70].contiguous(), *qargs)


# ---- B11: refine_quarter_pel_fused ---------------------------------------------

@pytest.mark.parametrize("b,n,extra", [(8, 37, 0), (16, 21, 3), (32, 5, 0), (64, 6, 9),
                                       (64, 510, 0), (16, 8160, 0)])
def test_b11_matches_plain(cuda, b, n, extra):
    rng = np.random.default_rng(b + n + extra)
    src = random_u8(rng, (n, b, b), cuda)
    win = random_u8(rng, (n, b + 7 + extra, b + 7 + 2 * extra), cuda)
    before = inter_fused.refine_quarter_pel_fused.launches
    got = inter_fused.refine_quarter_pel_fused(src, win)
    assert inter_fused.refine_quarter_pel_fused.launches == before + 1
    assert_bit_equal(got, inter_fused.refine_quarter_pel_fused_ref(src, win))


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b11_constant_windows_take_the_first_fraction(cuda, b):
    rng = np.random.default_rng(b)
    src = random_u8(rng, (9, b, b), cuda)
    win = torch.full((9, b + 7, b + 7), 97, dtype=torch.uint8, device=cuda)
    got = inter_fused.refine_quarter_pel_fused(src, win)
    assert int(got[1].abs().max()) == 0 and bool((got[0] == 97).all())
    assert_bit_equal(got, inter_fused.refine_quarter_pel_fused_ref(src, win))


def test_b11_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    win = torch.zeros((2, 23, 23), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        inter_fused.refine_quarter_pel_fused(src, win.to(torch.int16))
    with pytest.raises(ValueError, match="b in"):
        inter_fused.refine_quarter_pel_fused(src[:, :12, :12].contiguous(), win)
    with pytest.raises(ValueError, match="contiguous"):
        inter_fused.refine_quarter_pel_fused(src, win.transpose(1, 2))


# ---- B4: residual_pipeline_ctu ---------------------------------------------------

@pytest.mark.parametrize("tu,tr_type,qp,n", [(4, 0, 32, 7), (4, 1, 27, 7), (8, 0, 32, 7),
                                             (16, 0, 22, 7), (32, 0, 37, 7), (32, 0, 4, 3),
                                             (8, 0, 51, 510), (32, 0, 32, 510)])
def test_b4_matches_plain(cuda, tu, tr_type, qp, n):
    rng = np.random.default_rng(tu + qp + n)
    src = random_u8(rng, (n, 64, 64), cuda)
    pred = random_u8(rng, (n, 64, 64), cuda)
    cfg = EncodeConfig(qp=qp, tu=tu)
    qargs = (*cfg.quant_params(bool(tr_type)), *cfg.dequant_params())
    before = residual_ctu.residual_pipeline_ctu.launches
    got = residual_ctu.residual_pipeline_ctu(src, pred, *qargs, tu=tu, tr_type=tr_type)
    assert residual_ctu.residual_pipeline_ctu.launches == before + 1
    assert_bit_equal(got, residual_ctu.residual_pipeline_ctu_ref(src, pred, *qargs, tu=tu,
                                                                  tr_type=tr_type))


@pytest.mark.parametrize("qset", ["qp 32", *chip_smoke.RESIDUAL_EDGE_QARGS])
@pytest.mark.parametrize("tu,tr_type", [(4, 1), (4, 0), (8, 0), (16, 0), (32, 0)])
def test_b4_full_swing_and_quantizer_range_edges(cuda, tu, tr_type, qset):
    # tests/test_torch_residual_tc.py's cases: random, full-swing (255 over
    # 0 and the reverse, checkerboards, random 0/255) CTUs, at qp 32 and at
    # the quantizer parameters' range edges.
    src, pred = (torch.as_tensor(a, device=cuda)
                 for a in chip_smoke.residual_ctus(np.random.default_rng(tu + 5 * tr_type)))
    if qset in chip_smoke.RESIDUAL_EDGE_QARGS:
        qargs = chip_smoke.RESIDUAL_EDGE_QARGS[qset]
    else:
        cfg = EncodeConfig(qp=32, tu=tu)
        qargs = (*cfg.quant_params(bool(tr_type)), *cfg.dequant_params())
    before = residual_ctu.residual_pipeline_ctu.launches
    got = residual_ctu.residual_pipeline_ctu(src, pred, *qargs, tu=tu, tr_type=tr_type)
    assert residual_ctu.residual_pipeline_ctu.launches == before + 1
    assert_bit_equal(got, residual_ctu.residual_pipeline_ctu_ref(src, pred, *qargs, tu=tu,
                                                                  tr_type=tr_type))


@pytest.mark.parametrize("qset", list(chip_smoke.RESIDUAL_EDGE_QARGS))
def test_k2_and_b3_residual_at_quantizer_range_edges(cuda, qset):
    # K2's and B3's residual stage (residual_ctu8) at the quantizer's range
    # edges, on full-swing CTUs.
    # 128x192 frames: 6 CTUs, as many as residual_ctus gives.
    _, plane, offsets, _ = k2_case(3, 8, 32, 128, 192, cuda)
    _, flat, off0, off1, _ = b3_case(4, 8, 32, 128, 192, cuda)
    src = torch.as_tensor(chip_smoke.residual_ctus(np.random.default_rng(1))[0], device=cuda)
    qargs = chip_smoke.RESIDUAL_EDGE_QARGS[qset]
    assert_bit_equal(inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs),
                     inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))
    assert_bit_equal(bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs),
                     bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b4_matches_k2s_residual_stage(cuda):
    # B4 at 8x8 TUs and K2 share residual_core.cuh: the same CTUs coded
    # against the prediction K2 picks give the same recon and nnz.
    src, plane, offsets, qargs = k2_case(5, 8, 32, 128, 192, cuda)
    rec, frac, _, nnz, _ = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    pred, frac_b11, _ = inter_fused.refine_quarter_pel_fused(
        src, motion.extract_windows(plane, offsets, 71))
    assert torch.equal(frac, frac_b11)
    assert_bit_equal(residual_ctu.residual_pipeline_ctu(src, pred, *qargs), (rec, nnz))


def test_b4_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    qargs = (*EncodeConfig().quant_params(False), *EncodeConfig().dequant_params())
    with pytest.raises(TypeError):
        residual_ctu.residual_pipeline_ctu(src, src.to(torch.int16), *qargs)
    with pytest.raises(ValueError, match="DST"):
        residual_ctu.residual_pipeline_ctu(src, src, *qargs, tu=8, tr_type=1)
    with pytest.raises(ValueError, match="contiguous"):
        residual_ctu.residual_pipeline_ctu(src, src.transpose(1, 2), *qargs)


# ---- B3: bi_ctu_fused_dma ----------------------------------------------------

def b3_case(seed, r, qp, h, w, device, constant=False):
    """Two padded planes stacked by rows and refine offsets for random MVs,
    with the first CTU at offset 0 and the last at the maximum of each
    plane (offsets1 carries the lower plane's row offset)."""
    src, plane0, offsets0, qargs = k2_case(seed, r, qp, h, w, device)
    rng = np.random.default_rng(seed + 1)
    plane1 = ctu_mod.pad_frame(random_u8(rng, (h, w), device), r + 3, r + 4, r + 3, r + 4)
    if constant:
        plane0, plane1 = torch.full_like(plane0, 97), torch.full_like(plane1, 40)
    hp = plane0.shape[0]
    mvs = rng.integers(-r, r + 1, (src.shape[0], 2)).astype(np.int32)
    mvs[0], mvs[-1] = (-r, -r), (r, r)
    pos = motion.ctu_positions(h // 64, w // 64, 64, device)
    offsets1 = (pos + torch.as_tensor(mvs, device=device) + r
                + torch.tensor([hp, 0], dtype=torch.int32, device=device))
    flat = torch.cat([plane0, plane1]).contiguous()
    return src, flat, offsets0, offsets1.to(torch.int32).contiguous(), qargs


@pytest.mark.parametrize("seed,r,qp,h,w", [
    (13, 8, 32, 128, 192), (2, 32, 22, 256, 320), (7, 32, 37, 192, 128),
    (9, 32, 30, 1088, 1920)])
def test_b3_matches_plain(cuda, seed, r, qp, h, w):
    src, flat, off0, off1, qargs = b3_case(seed, r, qp, h, w, cuda)
    hp, wp = flat.shape[0] // 2, flat.shape[1]
    assert int(off0.min()) == 0 and tuple(off1[0].tolist()) == (hp, 0)
    assert tuple((off1[-1] + 71).tolist()) == (2 * hp, wp)
    before = bi_fused.bi_ctu_fused_dma.launches
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert bi_fused.bi_ctu_fused_dma.launches == before + 1
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_constant_planes_take_the_first_fractions(cuda):
    src, flat, off0, off1, qargs = b3_case(4, 8, 32, 128, 192, cuda, constant=True)
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert int(got[1].abs().max()) == int(got[2].abs().max()) == 0
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_clamps_starts_past_the_plane_like_the_plain_version(cuda):
    src, flat, off0, off1, qargs = b3_case(5, 8, 32, 128, 192, cuda)
    off1 = off1 + 9                                  # past the stacked plane's end
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


@pytest.mark.parametrize("invert", [False, True])
def test_b3_adversarial_windows_reach_the_intermediate_extremes(cuda, invert):
    src, flat, off0, off1, qargs = b3_case(6, 32, 32, 192, 256, cuda)
    hp = flat.shape[0] // 2
    flat = torch.cat([chip_smoke.adversarial_plane((hp, flat.shape[1]), cuda, invert),
                      chip_smoke.adversarial_plane((hp, flat.shape[1]), cuda, not invert)]).contiguous()
    src = (src > 127).to(torch.uint8) * 255
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_rejects_what_it_does_not_take(cuda):
    src, flat, off0, off1, qargs = b3_case(1, 8, 32, 128, 192, cuda)
    with pytest.raises(TypeError):
        bi_fused.bi_ctu_fused_dma(src, flat, off0, off1.long(), *qargs)
    with pytest.raises(ValueError, match="contiguous"):
        bi_fused.bi_ctu_fused_dma(src, flat[:, :-1], off0, off1, *qargs)


# ---- B12 and B13: refine_qpel_costmap and refine_qpel_costmap_dma ---------------

@pytest.mark.parametrize("b,n,extra", [(8, 37, 0), (16, 21, 0), (32, 5, 0), (64, 3, 0),
                                       (8, 64, 5), (16, 16, 9), (64, 2, 1)])
def test_b12_matches_plain(cuda, b, n, extra):
    rng = np.random.default_rng(b + n)
    src = random_u8(rng, (n, b, b), cuda)
    win = random_u8(rng, (n, b + 7 + extra, b + 7 + extra), cuda)
    before = costmap.refine_qpel_costmap.launches
    got = costmap.refine_qpel_costmap(src, win)
    assert costmap.refine_qpel_costmap.launches == before + 1
    assert_bit_equal([got], [costmap.refine_qpel_costmap_ref(src, win)])


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b12_constant_windows_tie_every_fraction(cuda, b):
    rng = np.random.default_rng(b)
    src = random_u8(rng, (9, b, b), cuda)
    win = torch.full((9, b + 7, b + 7), 97, dtype=torch.uint8, device=cuda)
    got = costmap.refine_qpel_costmap(src, win)
    assert bool((got == got[:, :1, :1]).all())
    assert_bit_equal([got], [costmap.refine_qpel_costmap_ref(src, win)])


def b13_case(b, n, seed, device, hp=200, wp=264):
    """Tiles, a plane and offsets with the first at (0, 0), the last at the
    largest start that fits, and one past the plane's end (clamped)."""
    rng = np.random.default_rng(seed)
    src = random_u8(rng, (n, b, b), device)
    plane = random_u8(rng, (hp, wp), device)
    offs = np.stack([rng.integers(0, hp - b - 6, n), rng.integers(0, wp - b - 6, n)], -1)
    offs[0], offs[-1], offs[n // 2] = (0, 0), (hp - b - 7, wp - b - 7), (hp, wp + 3)
    return src, plane, torch.as_tensor(offs.astype(np.int32), device=device)


@pytest.mark.parametrize("b,n", [(8, 97), (16, 33), (32, 7), (8, 1), (16, 8160)])
def test_b13_matches_plain(cuda, b, n):
    src, plane, offs = b13_case(b, n, b + n, cuda)
    before = costmap.refine_qpel_costmap_dma.launches
    got = costmap.refine_qpel_costmap_dma(src, plane, offs)
    assert costmap.refine_qpel_costmap_dma.launches == before + 1
    assert_bit_equal(got, costmap.refine_qpel_costmap_dma_ref(src, plane, offs))


def test_b13_constant_plane_ties_every_fraction(cuda):
    src, plane, offs = b13_case(16, 40, 3, cuda)
    plane = torch.full_like(plane, 40)
    cost, win = costmap.refine_qpel_costmap_dma(src, plane, offs)
    assert bool((cost == cost[:, :1, :1]).all()) and bool((win == 40).all())
    assert_bit_equal((cost, win), costmap.refine_qpel_costmap_dma_ref(src, plane, offs))


def test_b12_b13_reject_what_they_do_not_take(cuda):
    src, plane, offs = b13_case(16, 4, 1, cuda)
    with pytest.raises(TypeError):
        costmap.refine_qpel_costmap_dma(src, plane, offs.long())
    with pytest.raises(ValueError, match="contiguous"):
        costmap.refine_qpel_costmap_dma(src, plane[:, :-1], offs)
    with pytest.raises(ValueError):
        costmap.refine_qpel_costmap_dma(src[:, :8, :8].contiguous(), plane[:12], offs)


# ---- B11, B12 and B13 on the tensor cores: every side, layouts and extremes -------

TILE_COUNTS = {8: 33, 16: 17, 32: 9, 64: 5}


def refine_windows(b, n, seed, device, layout, content):
    """Sources and gathered windows for B11/B12: exactly (n, b+7, b+7) (the
    last window ends where its allocation does), or a view of a larger
    stack with odd strides and an unaligned first byte; random content or
    the planes that drive the horizontal pass to 22440 / -6120."""
    rng = np.random.default_rng(seed)
    w = b + 7
    if content == "random":
        src = random_u8(rng, (n, b, b), device)
        big = random_u8(rng, (n, w + 5, w + 9), device)
    else:
        src = torch.as_tensor(np.where(rng.random((n, b, b)) < 0.5, 0, 255).astype(np.uint8),
                              device=device)
        plane = chip_smoke.adversarial_plane((w + 5, n * (w + 9)), device,
                                             content.endswith("inverted"))
        big = plane.reshape(w + 5, n, w + 9).transpose(0, 1).contiguous()
    win = big[:, 2:2 + w, 3:3 + w]
    return src, (win.contiguous() if layout == "exact" else win)


@pytest.mark.parametrize("b", [8, 16, 32, 64])
@pytest.mark.parametrize("layout", ["exact", "strided"])
@pytest.mark.parametrize("content", ["random", "adversarial", "adversarial inverted"])
def test_b11_b12_tensor_cores_at_every_side_and_layout(cuda, b, layout, content):
    src, win = refine_windows(b, TILE_COUNTS[b], b + len(content), cuda, layout, content)
    assert (win.stride(0) == (b + 7) ** 2) == (layout == "exact")
    assert_bit_equal(inter_fused.refine_quarter_pel_fused(src, win),
                     inter_fused.refine_quarter_pel_fused_ref(src, win))
    assert_bit_equal([costmap.refine_qpel_costmap(src, win)],
                     [costmap.refine_qpel_costmap_ref(src, win)])


@pytest.mark.parametrize("b", [8, 16, 32])
@pytest.mark.parametrize("content", ["random", "adversarial", "adversarial inverted", "constant"])
def test_b13_tensor_cores_at_every_side(cuda, b, content):
    n = TILE_COUNTS[b]
    src, plane, offs = b13_case(b, n, 7 * b, cuda, hp=3 * b + 20, wp=4 * b + 30)
    if content == "constant":
        plane = torch.full_like(plane, 40)
    elif content != "random":
        plane = chip_smoke.adversarial_plane(plane.shape, cuda, content.endswith("inverted"))
        src = torch.where(src < 128, 0, 255).to(torch.uint8)
    cost, win = costmap.refine_qpel_costmap_dma(src, plane, offs)
    assert_bit_equal((cost, win), costmap.refine_qpel_costmap_dma_ref(src, plane, offs))
    if content == "constant":
        assert bool((cost == cost[:, :1, :1]).all())


# ---- B14 and B15: base_grids_ctu and base_layout_decide --------------------------

DEFAULT_LAYOUTS = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")


def b14_case(n, r, seed, device, strided=False):
    """CTUs and their (64 + 2R)^2 windows; ``strided`` cuts the windows out
    of wider rows, as a view."""
    rng = np.random.default_rng(seed)
    src = random_u8(rng, (n, 64, 64), device)
    size = 64 + 2 * r
    win = random_u8(rng, (n, size, size + (13 if strided else 0)), device)
    return src, win[:, :, :size]


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("n,r,strided", [(3, 32, False), (2, 8, True), (1, 1, False),
                                         (7, 17, False), (2, 2, True), (3, 31, True),
                                         (510, 32, False)])
def test_b14_matches_plain(cuda, base, n, r, strided):
    # R = 1, 2, 31 and 32: one m tile and n tile, a part k step, the edges
    # of the tensor-core tiling; 510 CTUs: a 1080p frame.
    src, win = b14_case(n, r, base + n + r, cuda, strided)
    before = base_grids.base_grids_ctu.launches
    got = base_grids.base_grids_ctu(src, win, base)
    assert base_grids.base_grids_ctu.launches == before + 1
    assert_bit_equal([got], [base_grids.base_grids_ctu_ref(src, win, base)])


def pu_lists(base):
    layouts = DEFAULT_LAYOUTS if base <= 16 else DEFAULT_LAYOUTS[:4]
    return partition._pu_lists(layouts, base)


def odd_pu_lists(base):
    """PUs that are no rectangle: a diagonal, a corner pair, every third."""
    k = 64 // base
    return (tuple(i * k + i for i in range(k)), (0, k * k - 1), tuple(range(0, k * k, 3)))


@pytest.mark.parametrize("base,lists", [(16, "default"), (32, "default"), (8, "default"),
                                        (16, "rows"), (8, "odd"), (16, "odd"), (32, "odd")])
@pytest.mark.parametrize("n,r", [(5, 32), (2, 8), (3, 1), (3, 2), (2, 31)])
def test_b15_matches_plain(cuda, base, lists, n, r):
    # R = 1, 2, 31 and 32: one m tile and n tile, a part k step, and the
    # edges of the tensor-core tiling; odd R on windows cut from wider rows.
    src, win = b14_case(n, r, base + n + r, cuda, strided=r % 2 == 1)
    k = 64 // base
    lists = {"default": pu_lists(base), "odd": pu_lists(base) + odd_pu_lists(base),
             "rows": tuple(tuple(range(i * k, i * k + k)) for i in range(k))}[lists]
    before = base_grids.base_layout_decide.launches
    got = base_grids.base_layout_decide(src, win, base, lists)
    assert base_grids.base_layout_decide.launches == before + 1
    assert_bit_equal([got], [base_grids.base_layout_decide_ref(src, win, base, lists)])


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("r", [1, 2, 31, 32])
def test_b15_flat_windows_take_the_first_candidate(cuda, base, r):
    src, win = b14_case(2, r, base + r, cuda)
    win = torch.full_like(win, 97)
    got = base_grids.base_layout_decide(src, win, base, pu_lists(base))
    assert bool((got[:, :, :2] == -r).all())
    assert_bit_equal([got], [base_grids.base_layout_decide_ref(src, win, base, pu_lists(base))])


def test_b14_b15_constant_window_ties_every_candidate(cuda):
    src, win = b14_case(4, 32, 0, cuda)
    win = torch.full_like(win, 97)
    got = base_grids.base_layout_decide(src, win, 16, pu_lists(16))
    assert bool((got[:, :, :2] == -32).all())
    assert_bit_equal([got], [base_grids.base_layout_decide_ref(src, win, 16, pu_lists(16))])
    assert_bit_equal([base_grids.base_grids_ctu(src, win, 32)],
                     [base_grids.base_grids_ctu_ref(src, win, 32)])


@pytest.mark.parametrize("base", [8, 16, 32])
def test_b14_extremes_are_exact(cuda, base):
    for sv, wv in ((0, 255), (255, 0), (255, 255)):
        src = torch.full((2, 64, 64), sv, dtype=torch.uint8, device=cuda)
        win = torch.full((2, 128, 128), wv, dtype=torch.uint8, device=cuda)
        got = base_grids.base_grids_ctu(src, win, base)
        assert int(got.min()) == int(got.max()) == base * base * (sv - wv) ** 2


def test_b15_largest_sum_fits_int32(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    win = torch.full((2, 128, 128), 255, dtype=torch.uint8, device=cuda)
    got = base_grids.base_layout_decide(src, win, 16, pu_lists(16))
    assert int(got[:, -1, 2].min()) == 4096 * 255 * 255


def test_b14_b15_reject_what_they_do_not_take(cuda):
    src, win = b14_case(2, 32, 1, cuda)
    with pytest.raises(TypeError):
        base_grids.base_grids_ctu(src.to(torch.int16), win, 16)
    with pytest.raises(ValueError, match="contiguous"):
        base_grids.base_grids_ctu(src.transpose(1, 2), win, 16)
    with pytest.raises(ValueError):
        base_grids.base_layout_decide(src, win, 16, ((16,),))


# ---- the slice -------------------------------------------------------------------

def pan_frames(h, w, seed=0):
    """A smooth picture panned by (2.25, 3.25) pixels, and the reference."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def picture(dy, dx):
        yy, xx = y + dy, x + dx
        v = 128 + 70 * np.sin(xx / 11 + yy / 17) + 40 * np.cos(xx / 23 - yy / 9)
        return np.clip(np.rint(v + rng.normal(0, 1.5, v.shape)), 0, 255).astype(np.uint8)

    return picture(2.25, 3.25), picture(0, 0)


@pytest.mark.parametrize("h,w,r", [(128, 256, 32), (128, 192, 8), (192, 320, 32)])
@pytest.mark.parametrize("impl", ["fused_dma", "stages"])
def test_card_matches_cpu(cuda, h, w, r, impl):
    cur, ref = pan_frames(h, w)
    kw = dict(refine_impl="ref", residual_impl="ref") if impl == "stages" else {}
    cfg = EncodeConfig(search_range=r, qp=32, inter_impl=impl, **kw)
    before = (search.ssd_grid_plane.launches, inter_fused.inter_ctu_fused_dma.launches)
    on_card = encode_inter_frame(torch.as_tensor(cur, device=cuda),
                                 torch.as_tensor(ref, device=cuda), cfg)
    assert search.ssd_grid_plane.launches == before[0] + 1
    assert inter_fused.inter_ctu_fused_dma.launches == before[1] + (impl == "fused_dma")
    on_cpu = encode_inter_frame(cur, ref, cfg, tiers=Tier.REF, device="cpu")
    for k in ("recon", "mvs", "sad", "nnz"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k
    assert abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) <= 1e-3


@pytest.mark.parametrize("r,kw", [(48, {}), (8, dict(search_impl="grid"))])
def test_grid_search_runs_b8_and_matches_cpu(cuda, r, kw):
    cur, ref = pan_frames(128, 192)
    cfg = EncodeConfig(search_range=r, qp=32, **kw)
    before = (search.ssd_grid.launches, search.ssd_grid_plane.launches)
    on_card = encode_inter_frame(torch.as_tensor(cur, device=cuda),
                                 torch.as_tensor(ref, device=cuda), cfg)
    assert (search.ssd_grid.launches, search.ssd_grid_plane.launches) == \
        (before[0] + 1, before[1])
    on_cpu = encode_inter_frame(cur, ref, cfg, device="cpu")
    for k in ("recon", "mvs", "sad", "nnz"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k
    assert abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) <= 1e-3


def yuv_clip(h, w, device, seed=0):
    """(ref0, cur, ref1) 4:2:0 frames of a panned picture on ``device``."""
    frames = []
    for t in range(3):
        luma = pan_frames(h, w, seed)[0] if t == 1 else pan_frames(h, w, seed + t)[1]
        rng = np.random.default_rng(seed + 10 * t)
        chroma = [random_u8(rng, (h // 2, w // 2), device) for _ in range(2)]
        frames.append(YuvFrame(torch.as_tensor(luma, device=device), *chroma))
    return frames


@pytest.mark.parametrize("h,w,r", [(128, 192, 8), (192, 256, 32)])
@pytest.mark.parametrize("impl", ["fused_dma", "stages"])
@pytest.mark.parametrize("kind", ["P", "B"])
def test_yuv_frames_on_card_match_plain_and_cpu(cuda, h, w, r, impl, kind):
    ref0, cur, ref1 = yuv_clip(h, w, cuda)
    cfg = EncodeConfig(search_range=r, qp=32, inter_impl=impl)
    counts = (search.ssd_grid_plane, inter_fused.inter_ctu_fused_dma,
              bi_fused.bi_ctu_fused_dma)
    before = [k.launches for k in counts]

    def run(frames, **kw):
        if kind == "P":
            return encode_inter_frame_yuv(frames[1], frames[0], cfg, **kw)
        return encode_b_frame_yuv(frames[1], frames[0], frames[2], cfg, **kw)

    on_card = run((ref0, cur, ref1))
    fused = impl == "fused_dma"
    want = {"P": (1, fused, 0), "B": (2, 0, fused)}[kind]
    assert [k.launches - b for k, b in zip(counts, before)] == list(want)
    plain = run((ref0, cur, ref1), tiers=Tier.REF)
    on_cpu = run([YuvFrame(*(p.cpu() for p in f)) for f in (ref0, cur, ref1)])
    keys = [k for k in on_card if k != "recon" and not k.startswith("psnr")]
    for other in (plain, on_cpu):
        for a, b in zip(on_card["recon"], other["recon"]):
            assert torch.equal(a.cpu(), b.cpu())
        for k in keys:
            assert torch.equal(on_card[k].cpu(), other[k].cpu()), k
        for k in on_card:
            if k.startswith("psnr"):
                assert abs(float(on_card[k]) - float(other[k])) <= 1e-3, k


RDO_VARIANTS = {
    "pu": dict(pu_decision=True),
    "six": dict(pu_decision=True, pu_layouts=tuple(partition.PU_LAYOUTS)),
    "tu": dict(tu_sizes=(4, 8, 16, 32)),
    "pu+tu": dict(pu_decision=True, tu_sizes=(4, 8, 16, 32)),
}


@pytest.mark.parametrize("r", [32, 8])
@pytest.mark.parametrize("variant", list(RDO_VARIANTS))
def test_rdo_frame_on_card_matches_plain_and_cpu(cuda, r, variant):
    cur, ref = pan_frames(128, 192)
    cur[64:, :96] = np.roll(cur[64:, :96], (3, -2), (0, 1))      # a second motion
    cfg = EncodeConfig(search_range=r, qp=32, **RDO_VARIANTS[variant])
    counts = {"decide": base_grids.base_layout_decide, "grids": base_grids.base_grids_ctu,
              "costmap_dma": costmap.refine_qpel_costmap_dma, "k1": search.ssd_grid_plane,
              "b8": search.ssd_grid}
    before = {k: f.launches for k, f in counts.items()}
    on_card = encode_inter_frame(torch.as_tensor(cur, device=cuda),
                                 torch.as_tensor(ref, device=cuda), cfg)
    got = {k: f.launches - before[k] for k, f in counts.items()}
    pu = cfg.pu_decision
    want = {"decide": int(pu and r == 32 and variant != "six"),
            "grids": int(pu and r == 32 and variant == "six"),
            "costmap_dma": int(pu), "k1": int(not pu), "b8": int(pu and r != 32)}
    assert got == want
    plain = encode_inter_frame(torch.as_tensor(cur, device=cuda),
                               torch.as_tensor(ref, device=cuda), cfg, tiers=Tier.REF)
    on_cpu = encode_inter_frame(cur, ref, cfg, device="cpu")
    assert set(on_card) == set(plain) == set(on_cpu)
    for other in (plain, on_cpu):
        for k in on_card:
            if k == "psnr_db":
                assert abs(float(on_card[k]) - float(other[k])) <= 1e-3
            else:
                assert torch.equal(on_card[k].cpu(), other[k].cpu()), k


# ---- the multi-reference P frame and the fused configurations ---------------------

def counts():
    return {"k1": search.ssd_grid_plane, "b7": search.ssd_grid_plane_multi,
            "b8": search.ssd_grid, "k2": inter_fused.inter_ctu_fused_dma,
            "b16": inter_fused.inter_ctu_fused, "b11": inter_fused.refine_quarter_pel_fused,
            "b4": residual_ctu.residual_pipeline_ctu, "b3": bi_fused.bi_ctu_fused_dma,
            "b9": sad.sad_grid, "b17": search.search_mv, "b17dma": search.search_mv_dma,
            "b19": mega.encode_ctu_mega, "b13": costmap.refine_qpel_costmap_dma,
            "b14": base_grids.base_grids_ctu, "b15": base_grids.base_layout_decide,
            "b10": sad.sad, "b10mr": sad.sad_multiref, "b5": mc.pred_uni,
            "b5batched": mc.pred_uni_batched, "b6": mc.pred_bi,
            "b6batched": mc.pred_bi_batched, "b18": base_grids.base_layout_decide_fc}


def launched(fn):
    """fn()'s result and the launches of every kernel during it."""
    before = {k: f.launches for k, f in counts().items()}
    out = fn()
    return out, {k: f.launches - before[k] for k, f in counts().items() if f.launches > before[k]}


def assert_same_outputs(got, want):
    assert set(got) == set(want)
    for k in got:
        if k.startswith("psnr"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-3, k
        elif k == "recon" and isinstance(got[k], tuple):
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a.cpu(), b.cpu())
        else:
            assert torch.equal(got[k].cpu(), want[k].cpu()), k


def multiref_frames(h, w, seed=5):
    """cur and three references: cur moved by (1, -2) with noise on its
    right half, the panned reference, and cur moved by (-2, 3) with noise
    on its left half, so the left CTUs pick reference 0 and the right ones
    reference 2."""
    cur, ref = pan_frames(h, w)
    noise = np.random.default_rng(seed).integers(-40, 41, cur.shape)
    left = np.roll(cur, (1, -2), (0, 1)).astype(np.int32)
    left[:, w // 2:] += noise[:, w // 2:]
    right = np.roll(cur, (-2, 3), (0, 1)).astype(np.int32)
    right[:, :w // 2] += noise[:, :w // 2]
    refs = [np.clip(p, 0, 255).astype(np.uint8) for p in (left, ref, right)]
    return cur, np.stack(refs)


MULTIREF = {
    "stages": (dict(), {"b7": 1}),
    "fused": (dict(inter_impl="fused"), {"b7": 1, "b16": 1}),
    "fused_batched": (dict(inter_impl="fused_batched", fused_group=4), {"b7": 1, "b16": 1}),
    "fused_dma": (dict(inter_impl="fused_dma"), {"b7": 1, "k2": 1}),
    "fused_refine+pallas": (dict(fused_refine=True, residual_impl="pallas"),
                            {"b7": 1, "b11": 1, "b4": 1}),
    "mega": (dict(inter_impl="mega"), {"b7": 1}),
}


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("variant", list(MULTIREF))
def test_multiref_on_card_matches_plain_and_cpu(cuda, r, variant):
    cur, refs = multiref_frames(128, 192)
    kw, want = MULTIREF[variant]
    cfg = EncodeConfig(search_range=r, qp=32, **kw)
    on_card, got = launched(lambda: encode_inter_frame_multiref(cur, refs, cfg))
    assert got == want
    assert on_card["recon"].device.type == "cuda"
    plain = encode_inter_frame_multiref(cur, refs, cfg, tiers=Tier.REF)
    on_cpu = encode_inter_frame_multiref(cur, refs, cfg, device="cpu")
    assert_same_outputs(on_card, plain)
    assert_same_outputs(on_card, on_cpu)
    assert len(torch.unique(on_card["ref_idx"])) > 1


FUSED = {
    "fused": (dict(inter_impl="fused"), {"k1": 1, "b16": 1}),
    "fused_batched": (dict(inter_impl="fused_batched", fused_group=4), {"k1": 1, "b16": 1}),
    "fused_refine": (dict(fused_refine=True), {"k1": 1, "b11": 1}),
    "pallas": (dict(residual_impl="pallas"), {"k1": 1, "b4": 1}),
}


@pytest.mark.parametrize("variant", list(FUSED))
@pytest.mark.parametrize("kind", ["luma", "P"])
def test_fused_configurations_on_card_match_plain_and_cpu(cuda, kind, variant):
    kw, want = FUSED[variant]
    cfg = EncodeConfig(search_range=8, qp=32, **kw)
    if kind == "luma":
        cur, ref = pan_frames(128, 192)
        frames = ((torch.as_tensor(cur, device=cuda), torch.as_tensor(ref, device=cuda)),
                  (torch.as_tensor(cur), torch.as_tensor(ref)))
        run = encode_inter_frame
    else:
        ref0, cur, _ = yuv_clip(128, 192, cuda)
        frames = ((cur, ref0), tuple(YuvFrame(*(p.cpu() for p in f)) for f in (cur, ref0)))
        run = encode_inter_frame_yuv
    on_card, got = launched(lambda: run(*frames[0], cfg))
    assert got == want
    assert_same_outputs(on_card, run(*frames[0], cfg, tiers=Tier.REF))
    assert_same_outputs(on_card, run(*frames[1], cfg))


@pytest.mark.parametrize("kw,want", [
    (dict(residual_impl="pallas"), {"k1": 2, "b4": 1}),
    (dict(search_impl="grid"), {"b7": 1}),
    (dict(search_impl="grid", inter_impl="fused"), {"b7": 1, "b3": 1}),
])
def test_b_frame_on_card_runs_b4_and_b7(cuda, kw, want):
    ref0, cur, ref1 = yuv_clip(128, 192, cuda)
    cfg = EncodeConfig(search_range=8, qp=32, **kw)
    on_card, got = launched(lambda: encode_b_frame_yuv(cur, ref0, ref1, cfg))
    assert got == want
    assert_same_outputs(on_card, encode_b_frame_yuv(cur, ref0, ref1, cfg, tiers=Tier.REF))
    cpu = [YuvFrame(*(p.cpu() for p in f)) for f in (cur, ref0, ref1)]
    assert_same_outputs(on_card, encode_b_frame_yuv(*cpu, cfg))


def test_numpy_input_runs_on_the_card_by_default(cuda):
    cur, ref = pan_frames(128, 192)
    cfg = EncodeConfig(search_range=8, qp=32)
    out = encode_inter_frame(cur, ref, cfg)
    assert out["recon"].device.type == "cuda"
    assert_same_outputs(out, encode_inter_frame(cur, ref, cfg, device="cpu"))


# ---- every search configuration ----------------------------------------------------

SEARCH_PATHS = {
    "sad": ("luma", dict(me_metric="sad"), {"b9": 1}),
    "sad fused_dma": ("luma", dict(me_metric="sad", inter_impl="fused_dma"), {"b9": 1, "k2": 1}),
    "pyramid": ("luma", dict(me_strategy="pyramid", inter_impl="fused_dma"), {"b8": 2, "k2": 1}),
    "pyramid sad": ("luma", dict(me_strategy="pyramid", me_metric="sad",
                                 inter_impl="fused_dma"), {"b9": 2, "k2": 1}),
    "mv": ("luma", dict(search_impl="mv", inter_impl="fused_dma"), {"b17": 1, "k2": 1}),
    "dma": ("luma", dict(search_impl="dma", inter_impl="fused_dma"), {"b17dma": 1, "k2": 1}),
    "mega": ("luma", dict(inter_impl="mega"), {"b19": 1}),
    "mega R=8": ("luma", dict(inter_impl="mega", search_range=8), {"b19": 1}),
    "tu_sizes dma": ("luma", dict(tu_sizes=(8, 16), search_impl="dma"), {"b17dma": 1}),
    "tu_sizes pyramid sad": ("luma", dict(tu_sizes=(8, 16), me_strategy="pyramid",
                                          me_metric="sad"), {"b9": 2}),
    "pu_decision sad": ("luma", dict(pu_decision=True, me_metric="sad"), {"b9": 1, "b13": 1}),
    "yuv P sad": ("P", dict(me_metric="sad", inter_impl="fused_dma"), {"b9": 1, "k2": 1}),
    "yuv P pyramid": ("P", dict(me_strategy="pyramid"), {"b8": 2}),
    "yuv P mega": ("P", dict(inter_impl="mega"), {"k1": 1}),
    "yuv B sad": ("B", dict(me_metric="sad", inter_impl="fused_dma"), {"b9": 1, "b3": 1}),
    "multiref sad": ("multiref", dict(me_metric="sad", inter_impl="fused_dma"),
                     {"b9": 1, "k2": 1}),
}


@pytest.mark.parametrize("path", list(SEARCH_PATHS))
def test_search_configurations_on_card_launch_their_kernels_and_match_plain_and_cpu(
        cuda, path):
    kind, kw, want = SEARCH_PATHS[path]
    cfg = EncodeConfig(**{"search_range": 32, "qp": 32, **kw})
    if kind == "luma":
        cur, ref = pan_frames(128, 192)
        frames = ((torch.as_tensor(cur, device=cuda), torch.as_tensor(ref, device=cuda)),
                  (torch.as_tensor(cur), torch.as_tensor(ref)))
        run = encode_inter_frame
    elif kind == "multiref":
        cur, refs = multiref_frames(128, 192)
        frames = ((torch.as_tensor(cur, device=cuda), torch.as_tensor(refs, device=cuda)),
                  (torch.as_tensor(cur), torch.as_tensor(refs)))
        run = encode_inter_frame_multiref
    else:
        ref0, cur, ref1 = yuv_clip(128, 192, cuda)
        on_card = (cur, ref0) if kind == "P" else (cur, ref0, ref1)
        frames = (on_card, tuple(YuvFrame(*(p.cpu() for p in f)) for f in on_card))
        run = encode_inter_frame_yuv if kind == "P" else encode_b_frame_yuv
    out, got = launched(lambda: run(*frames[0], cfg))
    assert got == want
    assert_same_outputs(out, run(*frames[0], cfg, tiers=Tier.REF))
    assert_same_outputs(out, run(*frames[1], cfg))


# ---- C.1: the grid ops' 2-D and 4-D inputs through B8 and B9 ------------------------

@pytest.mark.parametrize("src_shape,win_shape", [((64, 64), (80, 80)), ((32, 32), (63, 65)),
                                                 ((2, 3, 16, 16), (2, 3, 40, 40))])
@pytest.mark.parametrize("op", ["ssd_grid", "sad_grid"])
def test_b8_b9_take_2d_and_4d_input(cuda, src_shape, win_shape, op):
    rng = np.random.default_rng(len(src_shape) + win_shape[-1])
    src, win = random_u8(rng, src_shape, cuda), random_u8(rng, win_shape, cuda)
    ndy, ndx = win_shape[-2] - src_shape[-2] + 1, win_shape[-1] - src_shape[-1] + 1
    kernel, plain = {"ssd_grid": (search.ssd_grid, search.ssd_grid_ref),
                     "sad_grid": (sad.sad_grid, sad.sad_grid_ref)}[op]
    before = kernel.launches
    got = kernel(src, win, ndy, ndx)
    assert kernel.launches == before + 1
    assert tuple(got.shape) == (*src_shape[:-2], ndy, ndx)
    assert_bit_equal([got], [plain(src, win, ndy, ndx)])


# ---- B10: sad and sad_multiref ------------------------------------------------------

@pytest.mark.parametrize("w,h", selftest.PARTITIONS)
def test_b10_matches_plain_on_strided_views(cuda, w, h):
    rng = np.random.default_rng(w * 100 + h)
    src = random_u8(rng, (128, 128), cuda)[:h, :w]
    ref = random_u8(rng, (128, 128), cuda)[1:1 + h, 1:1 + w]     # rows 128 bytes apart
    refs = random_u8(rng, (4, 128, 128), cuda)[:, :h, :w]
    got, n = launched(lambda: (sad.sad(src, ref), sad.sad_multiref(src, refs)))
    assert n == {"b10": 1, "b10mr": 1}
    assert tuple(got[0].shape) == () and tuple(got[1].shape) == (4,)
    assert_bit_equal(got, [sad.sad_ref(src, ref), sad.sad_multiref_ref(src, refs)])


@pytest.mark.parametrize("n,k,h,w", [(510, 4, 64, 64), (37, 1, 8, 4), (5, 7, 48, 64),
                                     (3, 2, 12, 16), (0, 3, 8, 8)])
def test_b10_matches_plain_on_batches(cuda, n, k, h, w):
    rng = np.random.default_rng(n + k + h + w)
    src = random_u8(rng, (n, h, w), cuda)
    refs = random_u8(rng, (n, k, h, w + 5), cuda)[..., :w]
    assert_bit_equal([sad.sad(src, refs[:, 0]), sad.sad_multiref(src, refs)],
                     [sad.sad_ref(src, refs[:, 0]), sad.sad_multiref_ref(src, refs)])
    lead = random_u8(rng, (2, 3, h, w), cuda)
    assert_bit_equal([sad.sad(lead, lead.flip(0))], [sad.sad_ref(lead, lead.flip(0))])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("w,h", selftest.PARTITIONS)
def test_b10_every_partition_and_k_on_both_paths(cuda, w, h, aligned):
    # Aligned: rows 64 bytes apart at offset 0, the 16-byte path where w is
    # a multiple of 16; misaligned: views at (1, 1) and (1, 2), the byte path.
    rng = np.random.default_rng(w * 1000 + h * 10 + aligned)
    y0, x0, x1 = (0, 0, 0) if aligned else (1, 1, 2)
    src = random_u8(rng, (5, 66, 80), cuda)[:, y0:y0 + h, x0:x0 + w]
    for k in range(1, 9):
        refs = random_u8(rng, (5, k, 66, 80), cuda)[..., y0:y0 + h, x1:x1 + w]
        got, n = launched(lambda: (sad.sad(src, refs[:, 0]), sad.sad_multiref(src, refs)))
        assert n == {"b10": 1, "b10mr": 1}
        assert_bit_equal(got, [sad.sad_ref(src, refs[:, 0]), sad.sad_multiref_ref(src, refs)])


@pytest.mark.parametrize("k", [1, 4, 8])
def test_b10_frame_blocks(cuda, k):
    # The 510 64x64 blocks of a 1080p frame, contiguous (the packed path),
    # against k references, and the same blocks as 64x48 views.
    rng = np.random.default_rng(510 + k)
    src = random_u8(rng, (510, 64, 64), cuda)
    refs = random_u8(rng, (510, k, 64, 64), cuda)
    for s, r in ((src, refs), (src[..., :48], refs[..., :48])):
        assert_bit_equal([sad.sad(s, r[:, -1]), sad.sad_multiref(s, r)],
                         [sad.sad_ref(s, r[:, -1]), sad.sad_multiref_ref(s, r)])


def test_b10_largest_sums_and_rejects_what_it_does_not_take(cuda):
    zeros = torch.zeros((3, 64, 64), dtype=torch.uint8, device=cuda)
    full = torch.full((3, 2, 64, 64), 255, dtype=torch.uint8, device=cuda)
    assert int(sad.sad(zeros, full[:, 0]).min()) == 4096 * 255
    assert int(sad.sad_multiref(zeros, full).min()) == 4096 * 255
    with pytest.raises(TypeError):
        sad.sad(zeros.to(torch.int16), zeros.to(torch.int16))
    with pytest.raises(ValueError, match="one shape"):
        sad.sad(zeros, zeros[:, :8])
    with pytest.raises(ValueError, match="refs"):
        sad.sad_multiref(zeros, full[:, :, :8])


# ---- B5 and B6: pred_uni and pred_bi ------------------------------------------------

def mc_fracs(rng, n, taps, cuda):
    p = 4 if taps == 8 else 8
    return [torch.as_tensor(rng.integers(0, p, (n,)).astype(np.int32), device=cuda)
            for _ in range(4)]


@pytest.mark.parametrize("taps", [8, 4])
@pytest.mark.parametrize("w,h", [(64, 64), (32, 16), (16, 16), (8, 4)])
def test_b5_b6_match_plain_at_the_selftest_shapes(cuda, taps, w, h):
    w, h = w * taps // 8, h * taps // 8
    rng = np.random.default_rng(taps * 1000 + w + h)
    p = 4 if taps == 8 else 8
    # Windows as views into wider rows, so rows are further apart than wide.
    win0 = random_u8(rng, (p * p, h + taps - 1, w + taps + 9), cuda)[..., :w + taps - 1]
    win1 = random_u8(rng, (p * p, h + taps - 1, w + taps - 1), cuda)
    xf = torch.arange(p * p, device=cuda, dtype=torch.int32) % p     # every (xf, yf)
    yf = torch.arange(p * p, device=cuda, dtype=torch.int32) // p
    got, n = launched(lambda: [mc.pred_uni(win0, xf, yf, taps),
                               mc.pred_bi(win0, win1, xf, yf, yf, xf, taps)])
    assert n == {"b5": 1, "b6": 1}
    assert_bit_equal(got, [mc.pred_uni_ref(win0, xf, yf, taps),
                           mc.pred_bi_ref(win0, win1, xf, yf, yf, xf, taps)])
    for xfi, yfi in [(0, 0), (1, 0), (0, 1), (2, 3), (p - 1, p - 1)]:
        assert_bit_equal([mc.pred_uni(win0[0], xfi, yfi, taps),
                          mc.pred_bi(win0[0], win1[0], xfi, yfi, yfi, xfi, taps)],
                         [mc.pred_uni_ref(win0[0], xfi, yfi, taps),
                          mc.pred_bi_ref(win0[0], win1[0], xfi, yfi, yfi, xfi, taps)])


@pytest.mark.parametrize("taps,n,b", [(8, 510, 64), (4, 1020, 32), (8, 33, 128), (4, 7, 2)])
def test_b5_b6_match_plain_at_frame_shapes(cuda, taps, n, b):
    rng = np.random.default_rng(taps + n + b)
    w0 = random_u8(rng, (n, b + taps - 1, b + taps - 1), cuda)
    w1 = random_u8(rng, (n, b + taps - 1, b + taps - 1), cuda)
    fr = mc_fracs(rng, n, taps, cuda)
    got, launches = launched(lambda: [mc.pred_uni_batched(w0, fr[0], fr[1], b, b, taps),
                                      mc.pred_bi_batched(w0, w1, *fr, b, b, taps)])
    assert launches == {"b5batched": 1, "b6batched": 1}
    assert_bit_equal(got, [mc.pred_uni_batched_ref(w0, fr[0], fr[1], b, b, taps),
                           mc.pred_bi_batched_ref(w0, w1, *fr, b, b, taps)])


def test_b5_b6_leading_axes_numpy_fractions_and_out_of_range(cuda):
    rng = np.random.default_rng(56)
    win = random_u8(rng, (2, 3, 11, 15), cuda)
    xf = rng.integers(0, 4, (6,)).astype(np.int32)
    got = mc.pred_uni(win, xf, 2)
    assert tuple(got.shape) == (2, 3, 4, 8)
    assert_bit_equal([got], [mc.pred_uni_ref(win.reshape(6, 11, 15), torch.as_tensor(
        xf, device=cuda), 2).reshape(2, 3, 4, 8)])
    # A device fraction out of range is taken modulo the phase count.
    wide = torch.tensor([5, -3, 9, 2, 4, 7], dtype=torch.int32, device=cuda)
    assert_bit_equal([mc.pred_uni(win, wide, wide, 8), mc.pred_bi(win, win, wide, 1, 0, wide, 8)],
                     [mc.pred_uni(win, wide % 4, wide % 4, 8),
                      mc.pred_bi(win, win, wide % 4, 1, 0, wide % 4, 8)])
    with pytest.raises(ValueError, match="outside"):
        mc.pred_uni(win, 4, 0, 8)
    with pytest.raises(ValueError, match="outside"):
        mc.pred_bi(win, win, 0, 0, 8, 0, 4)
    with pytest.raises(ValueError, match="fractions for"):
        mc.pred_uni(win, torch.zeros(5, dtype=torch.int32, device=cuda), 0)
    with pytest.raises(TypeError):
        mc.pred_uni(win.to(torch.int16), 0, 0)
    wide_rows = torch.zeros((1, 11, 8007), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mc.pred_bi_batched(wide_rows, wide_rows, 0, 0, 0, 0, 4, 8000)


# The tensor-core tiling's edges (csrc/mc_tc.cuh): strips of 16 columns and
# steps of 16 rows, masked past the block; odd widths (byte stores), a
# block over several strips and several warps' runs of steps, tiny blocks
# (a CTA of one warp), 128x128.
MC_GEOMETRY = [(5, 3, 7), (33, 17, 9), (48, 40, 5), (2, 4, 13), (1, 1, 6), (4, 8, 9),
               (128, 128, 3), (80, 72, 4), (16, 8, 31), (7, 65, 2)]


@pytest.mark.parametrize("taps", [8, 4])
@pytest.mark.parametrize("w,h,n", MC_GEOMETRY)
def test_b5_b6_tiling_edges_match_plain(cuda, taps, w, h, n):
    rng = np.random.default_rng(taps * 7 + w * 3 + h + n)
    p = 4 if taps == 8 else 8
    wins = random_u8(rng, (2, n, h + taps + 2, w + taps + 12), cuda)
    w0, w1 = wins[0, :, 1:, 3:], wins[1]               # rows and blocks strided, unaligned
    fr = mc_fracs(rng, n, taps, cuda)
    got, launches = launched(lambda: [mc.pred_uni_batched(w0, fr[0], fr[1], h, w, taps),
                                      mc.pred_bi_batched(w0, w1, *fr, h, w, taps)])
    assert launches == {"b5batched": 1, "b6batched": 1}
    assert_bit_equal(got, [mc.pred_uni_batched_ref(w0, fr[0], fr[1], h, w, taps),
                           mc.pred_bi_batched_ref(w0, w1, *fr, h, w, taps)])
    # One fraction for every block: an int, and a one-element tensor.
    one = torch.tensor([p - 1], dtype=torch.int32, device=cuda)
    assert_bit_equal([mc.pred_uni_batched(w0, 1, one, h, w, taps),
                      mc.pred_bi_batched(w0, w1, one, 0, p - 1, one, h, w, taps)],
                     [mc.pred_uni_batched_ref(w0, 1, p - 1, h, w, taps),
                      mc.pred_bi_batched_ref(w0, w1, p - 1, 0, p - 1, p - 1, h, w, taps)])


@pytest.mark.parametrize("taps", [8, 4])
def test_b5_b6_full_swing_content(cuda, taps):
    # Full-swing content at every fraction: 0/255 checkerboards and stripes,
    # and for each horizontal fraction rows that put 255 under its positive
    # (or negative) taps and 0 under the others, which drive the int16
    # intermediate's hi byte to its ends (KERNEL8 f = 2: 22440 and -6120).
    p = 4 if taps == 8 else 8
    kern = np.array([[0, 0, 0, 64, 0, 0, 0, 0], [-1, 4, -10, 58, 17, -5, 1, 0],
                     [-1, 4, -11, 40, 40, -11, 4, -1], [0, 1, -5, 17, 58, -10, 4, -1]]) \
        if taps == 8 else np.array([[0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2],
                                    [-6, 46, 28, -4], [-4, 36, 36, -4], [-4, 28, 46, -6],
                                    [-2, 16, 54, -4], [-2, 10, 58, -2]])
    size = 32 + taps - 1
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    planes = [((yy + xx) & 1) * 255, (xx & 1) * 255, (yy & 1) * 255, ((yy >> 1) + xx & 1) * 255]
    planes += [255 - q for q in planes]
    blocks = [(q, xf, yf) for q in planes for xf in range(p) for yf in range(p)]
    blocks += [(np.broadcast_to((sign * kern[xf][xx % taps] > 0) * 255, (size, size)), xf, yf)
               for sign in (1, -1) for xf in range(p) for yf in range(p)]
    win = torch.as_tensor(np.stack([b[0] for b in blocks]).astype(np.uint8), device=cuda)
    xf = torch.tensor([b[1] for b in blocks], dtype=torch.int32, device=cuda)
    yf = torch.tensor([b[2] for b in blocks], dtype=torch.int32, device=cuda)
    w1 = win.flip(0)
    assert_bit_equal([mc.pred_uni(win, xf, yf, taps), mc.pred_bi(win, w1, xf, yf, yf, xf, taps)],
                     [mc.pred_uni_ref(win, xf, yf, taps),
                      mc.pred_bi_ref(win, w1, xf, yf, yf, xf, taps)])


# ---- B18: base_layout_decide_fc ------------------------------------------------------

@pytest.mark.parametrize("n", [3, 17, 510])
def test_b18_matches_b15_at_base_16_and_plain(cuda, n):
    src, win = b14_case(n, 32, n, cuda, strided=n == 17)
    got, launches = launched(lambda: base_grids.base_layout_decide_fc(src, win, pu_lists(16)))
    assert launches == {"b18": 1}
    assert_bit_equal([got], [base_grids.base_layout_decide(src, win, 16, pu_lists(16))])
    assert_bit_equal([got], [base_grids.base_layout_decide_fc_ref(src, win, pu_lists(16))])


def test_b18_takes_the_tpu_kernels_geometry_only(cuda):
    src, win = b14_case(2, 8, 1, cuda)
    with pytest.raises(ValueError, match="128"):
        base_grids.base_layout_decide_fc(src, win, pu_lists(16))


# ---- the self-test on the card -------------------------------------------------------

SELFTEST_LAUNCHES = {"b10mr": 23, "b10": 23, "b9": 3, "b8": 3, "b5": 32, "b6": 4, "b11": 2,
                     "b4": 2}


def test_selftest_on_the_card_passes_and_launches_each_kernel_once_a_case(cuda, capsys):
    errors, got = launched(lambda: selftest.main(time_it=False))
    assert errors == 0
    assert got == SELFTEST_LAUNCHES
    out = capsys.readouterr().out
    assert "self test passed" in out and "KERNEL:ok" in out and "MISMATCH" not in out


# ---- rate control: the device-q C entries of K2 (and B16) and B3 ----------------------

def device_q(qargs, device):
    """The five quantizer parameters as 0-d int32 tensors on the card."""
    return tuple(torch.tensor(q, dtype=torch.int32, device=device) for q in qargs)


def rate_entries(device, qp):
    """(name, wrapper, plain version, operands) of K2, B16 and B3 at qp."""
    src, plane, offsets, qargs = k2_case(5, 32, qp, 256, 320, device)
    _, flat, off0, off1, _ = b3_case(5, 32, qp, 256, 320, device)
    win = motion.extract_windows(plane, offsets, 71).contiguous()
    return qargs, [
        ("k2", inter_fused.inter_ctu_fused_dma, inter_fused.inter_ctu_fused_dma_ref,
         (src, plane, offsets)),
        ("b16", inter_fused.inter_ctu_fused, inter_fused.inter_ctu_fused_ref, (src, win)),
        ("b3", bi_fused.bi_ctu_fused_dma, bi_fused.bi_ctu_fused_dma_ref,
         (src, flat, off0, off1))]


@pytest.mark.parametrize("qp", [10, 32, 49])
def test_rate_device_q_entries_equal_host_int_entries_and_plain(cuda, qp):
    from hevcasm_tpu_torch.ops.quantize import range_flag

    qargs, entries = rate_entries(cuda, qp)
    for name, fn, ref, args in entries:
        flag = range_flag(cuda)
        before = fn.device_q_launches
        got, launches = launched(lambda: fn(*args, *device_q(qargs, cuda), range_flag=flag))
        assert launches == {name: 1} and fn.device_q_launches == before + 1, name
        assert int(flag) == 0, name
        assert_bit_equal(got, fn(*args, *qargs))
        assert_bit_equal(got, ref(*args, *qargs))
        assert_bit_equal(got, ref(*args, *device_q(qargs, cuda), range_flag=flag))
        assert int(flag) == 0, name


@pytest.mark.parametrize("bad,bit", [(dict(qshift=28), 2), (dict(dshift=0), 8),
                                     (dict(qscale=0, qoffset=1 << 15), 5)])
def test_rate_range_flag_set_by_parameters_out_of_range(cuda, bad, bit):
    from hevcasm_tpu_torch.ops.quantize import range_flag

    good, entries = rate_entries(cuda, 32)
    names = ("qscale", "qshift", "qoffset", "dscale", "dshift")
    qargs = tuple(bad.get(k, q) for k, q in zip(names, good))
    for name, fn, _, args in entries:
        flag = range_flag(cuda)
        out = fn(*args, *device_q(qargs, cuda), range_flag=flag)
        assert int(flag) == bit, name
        # The refinement needs no quantizer: its fractions are still written.
        assert torch.equal(out[1], fn(*args, *good)[1]), name
        with pytest.raises(ValueError, match="outside"):     # no flag: read at once
            fn(*args, *device_q(qargs, cuda))


@pytest.mark.parametrize("kw,b_frames,need", [
    (dict(inter_impl="fused_dma"), False, {"k1": 4, "k2": 4}),
    (dict(inter_impl="fused"), False, {"k1": 4, "b16": 4}),
    (dict(fused_refine=True), False, {"k1": 4, "b11": 4}),
    (dict(inter_impl="fused_dma"), True, {"k1": 6, "k2": 2, "b3": 2})])
def test_rate_gop_on_card_equals_plain_and_cpu_without_host_reads(cuda, kw, b_frames, need):
    from hevcasm_tpu_torch.encode import rate
    from hevcasm_tpu_torch.ops.quantize import raise_on_flag, range_flag

    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 256, (5, 128, 192), dtype=np.uint8), device=cuda)
    frames = ((frames.int() + frames.roll(1, 2).int()) // 2).to(torch.uint8)
    cfg = EncodeConfig(search_range=8, **kw)
    flag = range_flag(cuda)
    target = torch.tensor(4000.0, device=cuda)
    qp0 = torch.tensor(30, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, launches = launched(lambda: rate._gop_rc_body(frames, target, qp0, cfg, 10, 49,
                                                           b_frames, Tier.ALL, flag))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    raise_on_flag(flag)
    assert launches == need
    plain = rate.encode_gop_rate_controlled(frames, 4000.0, 30, cfg, b_frames=b_frames,
                                            tiers=Tier.REF)
    on_cpu = rate.encode_gop_rate_controlled(frames.cpu(), 4000.0, 30, cfg,
                                             b_frames=b_frames)
    for want in (plain, on_cpu):
        for k in ("recon", "bits", "qp"):
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
        assert float((got["psnr_db"].cpu() - want["psnr_db"].cpu()).abs().max()) <= 1e-3


# ---- intra frames and the GOPs -------------------------------------------------------

def smooth_clip(t, h, w, seed=0):
    """Smoothed noise panned (2, 3) pixels a frame, with +-3 of noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    out = np.stack([base[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(t)])
    return np.clip(np.rint(out + rng.integers(-3, 4, out.shape)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("content", ["random", "extremes", "constant"])
def test_intra_decision_n32_on_card_equals_cpu(cuda, content):
    from hevcasm_tpu_torch.kernels import intra_matrix

    rng = np.random.default_rng(3)
    m = intra_matrix.CHUNK + 5                       # two chunks
    draw = {"random": lambda *s: rng.integers(0, 256, s, dtype=np.uint8),
            "extremes": lambda *s: (rng.integers(0, 2, s) * 255).astype(np.uint8),
            "constant": lambda *s: np.full(s, 77, np.uint8)}[content]
    args = [draw(m, 32, 32), draw(m, 64), draw(m, 64), draw(m), draw(m, 64), draw(m, 64),
            draw(m)]
    on_cpu = intra_matrix.intra_mode_decision_t(*map(torch.as_tensor, args))
    got, launches = launched(lambda: intra_matrix.intra_mode_decision_t(
        *(torch.as_tensor(a, device=cuda) for a in args)))
    assert launches == {}
    assert_bit_equal(got, [t.to(cuda) for t in on_cpu])
    mm = intra_matrix.pred_intra_all_modes_mm(*(torch.as_tensor(a, device=cuda)
                                                for a in args[1:]))
    assert torch.equal(mm.cpu(), intra_matrix.pred_intra_all_modes_mm(
        *map(torch.as_tensor, args[1:])))


@pytest.mark.parametrize("n,h,w", [(32, 128, 192), (16, 128, 192), (32, 192, 64)])
def test_intra_frames_on_card_equal_cpu_and_the_wavefront_reads_nothing(cuda, n, h, w):
    from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu_torch.encode.loop import encode_intra_frame
    from hevcasm_tpu_torch.encode.video import encode_intra_frame_yuv

    cfg = EncodeConfig(intra_block=n, qp=27)
    cur = torch.as_tensor(smooth_clip(1, h, w)[0], device=cuda)
    out, launches = launched(lambda: encode_intra_frame(cur, cfg))
    assert launches == {}
    assert_same_outputs(out, encode_intra_frame(cur.cpu(), cfg))
    encode_intra_frame_wavefront(cur, cfg)          # the wave tables, once per shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, launches = launched(lambda: encode_intra_frame_wavefront(cur, cfg))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert launches == {}
    assert_same_outputs(out, encode_intra_frame_wavefront(cur.cpu(), cfg))
    chroma = torch.as_tensor(smooth_clip(2, h // 2, w // 2, seed=1), device=cuda)
    yuv = YuvFrame(cur, chroma[0], chroma[1])
    assert_same_outputs(encode_intra_frame_yuv(yuv, cfg),
                        encode_intra_frame_yuv(YuvFrame(*(p.cpu() for p in yuv)), cfg))


GOP_LAUNCHES = {"IPPP": {"k1": 4, "k2": 4}, "IBPBP": {"k1": 6, "k2": 2, "b3": 2}}


def assert_same_gop(got, want):
    assert set(got) == set(want)
    for k in got:
        if k.startswith("psnr"):
            assert float((got[k].cpu() - want[k].cpu()).abs().max()) <= 1e-3, k
        elif k == "nnz":
            assert type(got[k]) is int and got[k] == want[k]
        elif isinstance(got[k], tuple):
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a.cpu(), b.cpu()), k
        else:
            assert torch.equal(got[k].cpu(), want[k].cpu()), k


def gop_call(entry, frames, cfg, tiers=Tier.ALL):
    """One of the GOP entry points on (T, H, W) luma and (T, H/2, W/2)
    chroma planes."""
    from hevcasm_tpu_torch.encode import loop, video

    yuv = YuvFrame(*frames)
    wavefront = dataclasses.replace(cfg, intra_mode="wavefront")
    return {"gop": lambda: loop.encode_gop(yuv.y, cfg, tiers),
            "gop wavefront": lambda: loop.encode_gop(yuv.y, wavefront, tiers),
            "gop_yuv": lambda: video.encode_gop_yuv(yuv, cfg, tiers=tiers),
            "gop_yuv b": lambda: video.encode_gop_yuv(yuv, cfg, True, tiers),
            "closed_loop": lambda: video.encode_gop_closed_loop(yuv.y, cfg, 5, tiers),
            "closed_loop_yuv": lambda: video.encode_gop_closed_loop_yuv(yuv, cfg, tiers),
            "closed_loop_yuv_b": lambda: video.encode_gop_closed_loop_yuv_b(yuv, cfg, tiers),
            }[entry]()


@pytest.mark.parametrize("entry,structure", [
    ("gop", "IPPP"), ("gop wavefront", "IPPP"), ("gop_yuv", "IPPP"), ("gop_yuv b", "IBPBP"),
    ("closed_loop", "IPPP"), ("closed_loop_yuv", "IPPP"), ("closed_loop_yuv_b", "IBPBP")])
def test_gops_on_card_launch_their_kernels_and_equal_plain_and_cpu(cuda, entry, structure):
    frames = [torch.as_tensor(smooth_clip(5, h, w, seed), device=cuda)
              for (h, w), seed in (((128, 192), 0), ((64, 96), 1), ((64, 96), 2))]
    cfg = EncodeConfig(search_range=8, inter_impl="fused_dma")
    got, launches = launched(lambda: gop_call(entry, frames, cfg))
    assert launches == GOP_LAUNCHES[structure]
    assert_same_gop(got, gop_call(entry, frames, cfg, Tier.REF))
    assert_same_gop(got, gop_call(entry, [f.cpu() for f in frames], cfg))


# ---- chroma_p_fused: a P frame's chroma, both planes, in one launch -----------------

def chroma_case(rng, shape, device, r=32):
    """Four random (h, w) planes and MVs (n, 2) int32 whose windows reach
    the plain version's padding at search range r, every fraction."""
    h, w = shape
    reach = r // 2 + 1
    planes = [random_u8(rng, shape, device) for _ in range(4)]
    mv = rng.integers(-8 * reach, 8 * (reach + 1) + 8, (h // 32 * (w // 32), 2))
    return planes, torch.as_tensor(mv, dtype=torch.int32, device=device)


@pytest.mark.parametrize("shape", [(64, 96), (544, 960), (1088, 1920)],
                         ids=["2x3", "1080p", "4K"])
@pytest.mark.parametrize("qp", [35, 34, 33, 22])
def test_chroma_p_fused_matches_plain(cuda, shape, qp):
    rng = np.random.default_rng(shape[0] + qp)
    planes, mv = chroma_case(rng, shape, cuda)
    cfg = EncodeConfig(qp=qp)
    before = chroma_fused.chroma_p_fused.launches
    got = chroma_fused.chroma_p_fused(*planes, mv, cfg)
    assert chroma_fused.chroma_p_fused.launches == before + 1
    assert_bit_equal(got, chroma_fused.chroma_p_fused_ref(*planes, mv, cfg))
    cpu = chroma_fused.chroma_p_fused_ref(*(p.cpu() for p in planes), mv.cpu(), cfg)
    assert_bit_equal([g.cpu() for g in got], cpu)


@pytest.mark.parametrize("pattern", ["checkerboard", "stripes"])
def test_chroma_p_fused_full_swing(cuda, pattern):
    h, w = 128, 192
    y, x = np.mgrid[:h, :w]
    pats = ([(y + x) & 1, ((y >> 1) + (x >> 1)) & 1, (y + x + 1) & 1, ((y >> 1) + x) & 1]
            if pattern == "checkerboard" else [x & 1, y & 1, (x >> 1) & 1, (y >> 2) & 1])
    planes = [torch.as_tensor((255 * p).astype(np.uint8), device=cuda) for p in pats]
    _, mv = chroma_case(np.random.default_rng(1), (h, w), cuda)
    for qp in (35, 22):
        cfg = EncodeConfig(qp=qp)
        assert_bit_equal(chroma_fused.chroma_p_fused(*planes, mv, cfg),
                         chroma_fused.chroma_p_fused_ref(*planes, mv, cfg))


def test_chroma_p_fused_other_layouts(cuda):
    # Planes that are views (rows wider than the plane, an odd offset) and
    # int64 MVs go through the full checks, to the same integers.
    rng = np.random.default_rng(9)
    planes, mv = chroma_case(rng, (128, 192), cuda)
    wide = [random_u8(rng, (130, 200), cuda) for _ in range(4)]
    for v, p in zip(wide, planes):
        v[1:129, 3:195] = p
    views = [v[1:129, 3:195] for v in wide]
    cfg = EncodeConfig(qp=33)
    assert chroma_fused._fast(views, (mv,), cfg) is None
    assert chroma_fused._fast(planes, (mv.long(),), cfg) is None
    want = chroma_fused.chroma_p_fused_ref(*planes, mv, cfg)
    assert_bit_equal(chroma_fused.chroma_p_fused(*views, mv.long(), cfg), want)
    assert_bit_equal(chroma_fused.chroma_p_fused(*planes, mv, cfg), want)


def test_chroma_p_fused_rejects_what_it_does_not_take(cuda):
    planes, mv = chroma_case(np.random.default_rng(2), (64, 96), cuda)
    cfg = EncodeConfig(qp=33)
    with pytest.raises(TypeError):
        chroma_fused.chroma_p_fused(*planes[:3], planes[3].to(torch.int16), mv, cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_p_fused(*(p[:48] for p in planes), mv[:4], cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_p_fused(*planes, mv[:5], cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_p_fused(*planes, mv, EncodeConfig(ctu=32, qp=33, search_range=8))
    with pytest.raises(ValueError):
        chroma_fused.chroma_p_fused(*planes[:3], planes[3].cpu(), mv, cfg)


def test_yuv_p_frame_1080p_takes_chroma_p_fused_once_and_equals_plain(cuda):
    # encode_inter_frame_yuv with Tier.ALL against Tier.REF on a 1920x1088
    # 4:2:0 pair: one launch of the kernel, none on the plain path, the
    # same integers.
    ref0, cur, _ = yuv_clip(1088, 1920, cuda)
    cfg = EncodeConfig(search_range=32, qp=35, inter_impl="fused_dma")
    before = chroma_fused.chroma_p_fused.launches
    out = encode_inter_frame_yuv(cur, ref0, cfg)
    assert chroma_fused.chroma_p_fused.launches == before + 1
    plain = encode_inter_frame_yuv(cur, ref0, cfg, tiers=Tier.REF)
    assert chroma_fused.chroma_p_fused.launches == before + 1
    assert_same_outputs(out, plain)


@pytest.mark.parametrize("entry,p_frames", [
    ("gop", 0), ("gop_yuv", 4), ("gop_yuv b", 2), ("closed_loop_yuv", 4),
    ("closed_loop_yuv_b", 2)])
def test_chroma_p_fused_runs_once_a_yuv_p_frame(cuda, entry, p_frames):
    frames = [torch.as_tensor(smooth_clip(5, h, w, seed), device=cuda)
              for (h, w), seed in (((128, 192), 0), ((64, 96), 1), ((64, 96), 2))]
    cfg = EncodeConfig(search_range=8, inter_impl="fused_dma")
    before = chroma_fused.chroma_p_fused.launches
    gop_call(entry, frames, cfg)
    assert chroma_fused.chroma_p_fused.launches == before + p_frames
    ref0, cur, ref1 = yuv_clip(128, 192, cuda)
    encode_b_frame_yuv(cur, ref0, ref1, cfg)
    assert chroma_fused.chroma_p_fused.launches == before + p_frames


def test_selftest_chroma_suite_on_the_card(cuda, capsys):
    before = chroma_fused.chroma_p_fused.launches
    assert selftest.main(time_it=False, suites=["chroma_p_fused"]) == 0
    assert chroma_fused.chroma_p_fused.launches == before + 2
    out = capsys.readouterr().out
    assert out.count("KERNEL:ok") == 2 and "MISMATCH" not in out


# ---- chroma_b_fused: a B frame's chroma, both planes, in one launch -----------------

def chroma_b_case(rng, shape, device, r=32):
    """Six random (h, w) planes (cur, ref0, ref1; cb and cr each) and two
    MV arrays whose windows reach the plain version's padding."""
    planes, mv0 = chroma_case(rng, shape, device, r)
    more, mv1 = chroma_case(rng, shape, device, r)
    return planes + more[:2], [mv0, mv1]


@pytest.mark.parametrize("shape", [(64, 96), (544, 960), (1088, 1920)],
                         ids=["2x3", "1080p", "4K"])
@pytest.mark.parametrize("qp", [32, 35, 22])
def test_chroma_b_fused_matches_plain(cuda, shape, qp):
    rng = np.random.default_rng(shape[1] + qp)
    planes, mvs = chroma_b_case(rng, shape, cuda)
    cfg = EncodeConfig(qp=qp)
    before = chroma_fused.chroma_b_fused.launches
    got = chroma_fused.chroma_b_fused(*planes, *mvs, cfg)
    assert chroma_fused.chroma_b_fused.launches == before + 1
    assert_bit_equal(got, chroma_fused.chroma_b_fused_ref(*planes, *mvs, cfg))
    cpu = chroma_fused.chroma_b_fused_ref(*(p.cpu() for p in planes), *(m.cpu() for m in mvs),
                                          cfg)
    assert_bit_equal([g.cpu() for g in got], cpu)


@pytest.mark.parametrize("pattern", ["checkerboard", "stripes"])
def test_chroma_b_fused_full_swing(cuda, pattern):
    h, w = 128, 192
    y, x = np.mgrid[:h, :w]
    pats = ([(y + x) & 1, ((y >> 1) + (x >> 1)) & 1, (y + x + 1) & 1, ((y >> 1) + x) & 1,
             (y + (x >> 1)) & 1, ((y >> 1) + (x >> 1) + 1) & 1]
            if pattern == "checkerboard" else
            [x & 1, y & 1, (x >> 1) & 1, (y >> 2) & 1, (x >> 2) & 1, (y >> 1) & 1])
    planes = [torch.as_tensor((255 * p).astype(np.uint8), device=cuda) for p in pats]
    _, mvs = chroma_b_case(np.random.default_rng(1), (h, w), cuda)
    for qp in (32, 22):
        cfg = EncodeConfig(qp=qp)
        assert_bit_equal(chroma_fused.chroma_b_fused(*planes, *mvs, cfg),
                         chroma_fused.chroma_b_fused_ref(*planes, *mvs, cfg))


def test_chroma_b_fused_other_layouts(cuda):
    # Planes that are views (rows wider than the plane, an odd offset) and
    # int64 MVs go through the full checks, to the same integers.
    rng = np.random.default_rng(19)
    planes, mvs = chroma_b_case(rng, (128, 192), cuda)
    wide = [random_u8(rng, (130, 200), cuda) for _ in range(6)]
    for v, p in zip(wide, planes):
        v[1:129, 3:195] = p
    views = [v[1:129, 3:195] for v in wide]
    cfg = EncodeConfig(qp=32)
    assert chroma_fused._fast(views, mvs, cfg) is None
    assert chroma_fused._fast(planes, [mvs[0], mvs[1].long()], cfg) is None
    want = chroma_fused.chroma_b_fused_ref(*planes, *mvs, cfg)
    assert_bit_equal(chroma_fused.chroma_b_fused(*views, mvs[0].long(), mvs[1], cfg), want)
    assert_bit_equal(chroma_fused.chroma_b_fused(*planes, *mvs, cfg), want)


def test_chroma_b_fused_rejects_what_it_does_not_take(cuda):
    planes, mvs = chroma_b_case(np.random.default_rng(2), (64, 96), cuda)
    cfg = EncodeConfig(qp=32)
    with pytest.raises(TypeError):
        chroma_fused.chroma_b_fused(*planes[:5], planes[5].to(torch.int16), *mvs, cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_b_fused(*(p[:48] for p in planes), mvs[0][:4], mvs[1][:4], cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_b_fused(*planes, mvs[0], mvs[1][:5], cfg)
    with pytest.raises(TypeError):
        chroma_fused.chroma_b_fused(*planes, mvs[0], mvs[1].float(), cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_b_fused(*planes, *mvs, EncodeConfig(ctu=32, qp=32, search_range=8))
    with pytest.raises(ValueError):
        chroma_fused.chroma_b_fused(*planes[:5], planes[5].cpu(), *mvs, cfg)


def test_yuv_b_frame_1080p_takes_chroma_b_fused_once_and_equals_plain(cuda):
    # encode_b_frame_yuv with Tier.ALL against Tier.REF on a 1920x1088
    # 4:2:0 triple: one launch of the kernel, none on the plain path, the
    # same integers.
    ref0, cur, ref1 = yuv_clip(1088, 1920, cuda)
    cfg = EncodeConfig(search_range=32, qp=32, inter_impl="fused_dma")
    before = chroma_fused.chroma_b_fused.launches
    out = encode_b_frame_yuv(cur, ref0, ref1, cfg)
    assert chroma_fused.chroma_b_fused.launches == before + 1
    plain = encode_b_frame_yuv(cur, ref0, ref1, cfg, tiers=Tier.REF)
    assert chroma_fused.chroma_b_fused.launches == before + 1
    assert_same_outputs(out, plain)


@pytest.mark.parametrize("entry,b_frames", [
    ("gop", 0), ("gop_yuv", 0), ("gop_yuv b", 2), ("closed_loop_yuv", 0),
    ("closed_loop_yuv_b", 2)])
def test_chroma_b_fused_runs_once_a_yuv_b_frame(cuda, entry, b_frames):
    frames = [torch.as_tensor(smooth_clip(5, h, w, seed), device=cuda)
              for (h, w), seed in (((128, 192), 0), ((64, 96), 1), ((64, 96), 2))]
    cfg = EncodeConfig(search_range=8, inter_impl="fused_dma")
    before = chroma_fused.chroma_b_fused.launches
    gop_call(entry, frames, cfg)
    assert chroma_fused.chroma_b_fused.launches == before + b_frames
    ref0, cur, ref1 = yuv_clip(128, 192, cuda)
    encode_inter_frame_yuv(cur, ref0, cfg)
    assert chroma_fused.chroma_b_fused.launches == before + b_frames
    encode_b_frame_yuv(cur, ref0, ref1, dataclasses.replace(cfg, ctu=32, inter_impl="stages"))
    assert chroma_fused.chroma_b_fused.launches == before + b_frames


def test_selftest_chroma_b_suite_on_the_card(cuda, capsys):
    before = chroma_fused.chroma_b_fused.launches
    assert selftest.main(time_it=False, suites=["chroma_b_fused"]) == 0
    assert chroma_fused.chroma_b_fused.launches == before + 2
    out = capsys.readouterr().out
    assert out.count("KERNEL:ok") == 2 and "MISMATCH" not in out


# ---- chroma_pu_fused: the RD P frame's chroma, an MV a PU tile ----------------------

def chroma_pu_case(rng, shape, k, device, r=32):
    """Four random (h, w) planes and an MV field (n, k, k, 2) int32 whose
    windows reach the plain version's padding at search range r, every
    fraction."""
    planes, _ = chroma_case(rng, shape, device, r)
    n = shape[0] // 32 * (shape[1] // 32)
    reach = r // 2 + 1
    field = rng.integers(-8 * reach, 8 * (reach + 1) + 8, (n, k, k, 2))
    return planes, torch.as_tensor(field, dtype=torch.int32, device=device)


@pytest.mark.parametrize("shape", [(64, 96), (544, 960), (1088, 1920)],
                         ids=["2x3", "1080p", "4K"])
@pytest.mark.parametrize("k", chroma_fused.PU_TILES)
@pytest.mark.parametrize("qp", [35, 22])
def test_chroma_pu_fused_matches_plain(cuda, shape, k, qp):
    rng = np.random.default_rng(shape[0] + 10 * k + qp)
    planes, field = chroma_pu_case(rng, shape, k, cuda)
    cfg = EncodeConfig(qp=qp)
    before = chroma_fused.chroma_pu_fused.launches
    got = chroma_fused.chroma_pu_fused(*planes, field, cfg)
    assert chroma_fused.chroma_pu_fused.launches == before + 1
    assert_bit_equal(got, chroma_fused.chroma_p_fused_ref(*planes, field, cfg))
    cpu = chroma_fused.chroma_p_fused_ref(*(p.cpu() for p in planes), field.cpu(), cfg)
    assert_bit_equal([g.cpu() for g in got], cpu)


@pytest.mark.parametrize("pattern", ["checkerboard", "stripes"])
def test_chroma_pu_fused_full_swing_and_views(cuda, pattern):
    # 0/255 content, then planes that are views and an int64 field, to the
    # same integers.
    h, w = 128, 192
    y, x = np.mgrid[:h, :w]
    pats = ([(y + x) & 1, ((y >> 1) + (x >> 1)) & 1, (y + x + 1) & 1, ((y >> 1) + x) & 1]
            if pattern == "checkerboard" else [x & 1, y & 1, (x >> 1) & 1, (y >> 2) & 1])
    planes = [torch.as_tensor((255 * p).astype(np.uint8), device=cuda) for p in pats]
    _, field = chroma_pu_case(np.random.default_rng(3), (h, w), 8, cuda)
    for qp in (35, 22):
        cfg = EncodeConfig(qp=qp)
        want = chroma_fused.chroma_p_fused_ref(*planes, field, cfg)
        assert_bit_equal(chroma_fused.chroma_pu_fused(*planes, field, cfg), want)
        wide = [torch.zeros((h + 2, w + 8), dtype=torch.uint8, device=cuda) for _ in planes]
        for v, p in zip(wide, planes):
            v[1:h + 1, 3:w + 3] = p
        views = [v[1:h + 1, 3:w + 3] for v in wide]
        assert_bit_equal(chroma_fused.chroma_pu_fused(*views, field.long(), cfg), want)


def test_chroma_pu_fused_rejects_what_it_does_not_take(cuda):
    planes, field = chroma_pu_case(np.random.default_rng(4), (64, 96), 8, cuda)
    cfg = EncodeConfig(qp=33)
    with pytest.raises(ValueError):
        chroma_fused.chroma_pu_fused(*planes, field[:, :3, :3].contiguous(), cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_pu_fused(*planes, field[:5], cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_pu_fused(*planes, field[:, 0, 0], cfg)
    with pytest.raises(TypeError):
        chroma_fused.chroma_pu_fused(*planes, field.float(), cfg)
    with pytest.raises(TypeError):
        chroma_fused.chroma_pu_fused(*planes[:3], planes[3].to(torch.int16), field, cfg)
    with pytest.raises(ValueError):
        chroma_fused.chroma_pu_fused(*planes, field, EncodeConfig(ctu=32, qp=33, search_range=8))


@pytest.mark.parametrize("kw,counts", [
    (dict(pu_decision=True, pu_layouts=tuple(partition.PU_LAYOUTS), tu_sizes=(4, 8, 16, 32)),
     {"b14": 1, "b13": 1, "pu": 1, "p": 0}),
    (dict(pu_decision=True, tu_sizes=(4, 8, 16, 32)), {"b14": 0, "b13": 1, "pu": 1, "p": 0}),
    (dict(tu_sizes=(4, 8, 16, 32)), {"b14": 0, "b13": 0, "pu": 0, "p": 1})])
def test_yuv_rd_frame_1080p_on_card_equals_plain(cuda, kw, counts):
    # encode_inter_frame_yuv's RD P frame with Tier.ALL against Tier.REF on
    # a 1920x1088 4:2:0 pair: B14 (six layouts) or B15, B13, and one launch
    # of chroma_pu_fused for the PU decision's field (chroma_p_fused for one
    # MV a CTU); the same integers as the plain path, and its luma
    # encode_inter_frame's.
    ref0, cur, _ = yuv_clip(1088, 1920, cuda)
    cfg = EncodeConfig(search_range=32, qp=35, **kw)
    kernels = {"b14": base_grids.base_grids_ctu, "b13": costmap.refine_qpel_costmap_dma,
               "pu": chroma_fused.chroma_pu_fused, "p": chroma_fused.chroma_p_fused}
    before = {k: f.launches for k, f in kernels.items()}
    out = encode_inter_frame_yuv(cur, ref0, cfg)
    assert {k: f.launches - before[k] for k, f in kernels.items()} == counts
    plain = encode_inter_frame_yuv(cur, ref0, cfg, tiers=Tier.REF)
    assert_same_outputs(out, plain)
    luma = encode_inter_frame(cur.y, ref0.y, cfg)
    assert torch.equal(out["recon"].y, luma["recon"]) and torch.equal(out["mvs"], luma["mvs"])


# ---- intra_wave_fused: a wave of the closed-loop I frame in one launch --------------

def wave_tables(cur, n=32):
    """The wavefront's operands for plane ``cur``: its non-empty spans, the
    tables, the source blocks in wave order and a fresh canvas."""
    from hevcasm_tpu_torch.encode import intra_wavefront

    h, w = cur.shape
    spans, order, refs, lav, aav, cav = intra_wavefront._schedule(h, w, n, cur.device)
    src = ctu_mod.tile_frame(cur, n).index_select(0, order)
    canvas = torch.full((h * w,), intra_wavefront.UNAVAILABLE, dtype=torch.uint8,
                        device=cur.device)
    return [(s, e) for s, e in spans if s < e], (order, refs, lav, aav, cav), src, canvas


@pytest.mark.parametrize("shape,waves", [((1088, 1920), 126), ((2176, 3840), 254)],
                         ids=["1080p", "4K"])
def test_intra_wave_fused_frame_equals_plain_a_launch_a_wave(cuda, shape, waves):
    from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu_torch.kernels import intra_wave

    h, w = shape
    cur = torch.as_tensor(smooth_clip(1, h, w, seed=h)[0], device=cuda)
    cfg = EncodeConfig(qp=32)
    before = intra_wave.intra_wave_fused.launches
    got = encode_intra_frame_wavefront(cur, cfg)
    assert intra_wave.intra_wave_fused.launches == before + waves
    plain = encode_intra_frame_wavefront(cur, cfg, Tier.REF)
    assert intra_wave.intra_wave_fused.launches == before + waves
    assert_same_outputs(got, plain)


@pytest.mark.parametrize("content", ["random", "full swing"])
@pytest.mark.parametrize("qp,strong", [(22, True), (37, False), (32, True)])
def test_intra_wave_fused_modes_and_nnz_wave_by_wave(cuda, content, qp, strong):
    from hevcasm_tpu_torch.kernels import intra_wave

    rng = np.random.default_rng(qp)
    h, w = 1088, 1920
    frame = (rng.integers(0, 256, (h, w)) if content == "random"
             else 255 * rng.integers(0, 2, (h // 4, w // 4)).repeat(4, 0).repeat(4, 1))
    cur = torch.as_tensor(frame.astype(np.uint8), device=cuda)
    cfg = EncodeConfig(qp=qp, strong_intra_smoothing=strong)
    spans, tabs, src, canvas = wave_tables(cur)
    outs = []
    for wave in (intra_wave.intra_wave_fused, intra_wave.intra_wave_ref):
        canvas_w = canvas.clone()
        nnz = torch.zeros((), dtype=torch.int32, device=cuda)
        modes = torch.full((tabs[0].shape[0],), -1, dtype=torch.int32, device=cuda)
        for s, e in spans:
            wave(canvas_w, src, *tabs, s, e, nnz, cfg, modes)
        outs.append((canvas_w, nnz, modes))
    assert_bit_equal(*outs)
    assert int((outs[0][2] < 0).sum()) == 0
    if content == "random":
        assert int(torch.unique(outs[0][2]).numel()) > 4


@pytest.mark.parametrize("entry", ["closed_loop_yuv", "closed_loop_yuv_b"])
def test_closed_loop_gops_take_intra_wave_fused_and_equal_plain(cuda, entry):
    from hevcasm_tpu_torch.kernels import intra_wave

    frames = [torch.as_tensor(smooth_clip(3, h, w, seed), device=cuda)
              for (h, w), seed in (((1088, 1920), 0), ((544, 960), 1), ((544, 960), 2))]
    cfg = EncodeConfig(search_range=32, inter_impl="fused_dma")
    before = intra_wave.intra_wave_fused.launches
    got = gop_call(entry, frames, cfg)
    assert intra_wave.intra_wave_fused.launches == before + 126
    assert_same_gop(got, gop_call(entry, frames, cfg, Tier.REF))


def test_intra_wave_fused_rejects_what_it_does_not_take(cuda):
    from hevcasm_tpu_torch.kernels import intra_wave

    cur = torch.as_tensor(smooth_clip(1, 64, 96)[0], device=cuda)
    spans, tabs, src, canvas = wave_tables(cur)
    nnz = torch.zeros((), dtype=torch.int32, device=cuda)
    cfg = EncodeConfig(qp=32)
    s, e = spans[0]
    with pytest.raises(ValueError):
        intra_wave.intra_wave_fused(canvas, src, *tabs, s, e, nnz, EncodeConfig(tu=4))
    with pytest.raises(ValueError):
        intra_wave.intra_wave_fused(canvas, src, *tabs, 0, tabs[0].shape[0] + 1, nnz, cfg)
    with pytest.raises(ValueError):
        intra_wave.intra_wave_fused(canvas, src, *tabs, s, e, nnz.long(), cfg)
    with pytest.raises(ValueError):
        intra_wave.intra_wave_fused(canvas[1:], src, *tabs, s, e, nnz, cfg)
    with pytest.raises(ValueError):
        intra_wave.intra_wave_fused(canvas, src.cpu(), *tabs, s, e, nnz, cfg)


# ---- the sharded entry points (hevcasm_tpu_torch.parallel) ------------------

def sharded_inputs():
    rng = np.random.default_rng(17)
    clip = smooth_clip(5, 256, 128, 3)
    return {"spatial": (clip[1], clip[0]), "gop": clip[:3],
            "dp": rng.integers(0, 256, (5, 128, 192), dtype=np.uint8)}


def test_sharded_world_of_one_under_nccl_equals_single_card(cuda):
    """A world of 1 under nccl in this process (mesh 1x1): the spatial
    frame, the closed-loop spatial GOP and the data-parallel GOP on the
    card equal the single-card entry points, with K1 and K2 launched."""
    import torch.distributed as dist

    from hevcasm_tpu_torch.encode import video
    from hevcasm_tpu_torch.parallel import (encode_gop_closed_loop_spatial,
                                            encode_gop_data_parallel,
                                            encode_inter_frame_spatial, make_mesh, multihost)

    inputs = sharded_inputs()
    cfg = EncodeConfig(search_range=8, qp=32, inter_impl="fused_dma")
    assert not dist.is_initialized()
    multihost.initialize()
    try:
        assert (dist.get_backend(), dist.get_world_size()) == ("nccl", 1)
        mesh = make_mesh(1, 1)
        assert mesh.device_type == "cuda"
        got, launches = launched(lambda: encode_inter_frame_spatial(*inputs["spatial"], mesh,
                                                                    cfg))
        assert launches == {"k1": 1, "k2": 1}
        want = encode_inter_frame(*inputs["spatial"], cfg)
        for k in ("recon", "sad", "nnz"):
            assert torch.equal(got[k], want[k]), k
        assert got["recon"].device.type == "cuda"
        gop = encode_gop_closed_loop_spatial(inputs["gop"], mesh, cfg)
        want = video.encode_gop_closed_loop(inputs["gop"], cfg, 3)
        assert torch.equal(gop["recon"], want["recon"])
        dp = encode_gop_data_parallel(inputs["dp"], mesh, cfg)
        for t in range(4):
            one = encode_inter_frame(inputs["dp"][t + 1], inputs["dp"][t], cfg)
            for k in ("recon", "mvs", "sad", "nnz"):
                assert torch.equal(dp[k][t], one[k]), (t, k)
    finally:
        dist.destroy_process_group()
        multihost._DEVICE = None


def test_sharded_two_ranks_on_one_card_under_gloo(cuda):
    """Two ranks sharing the card under gloo (nccl refuses two ranks on one
    card): each equals the single-card entry points, with its own K1/K2
    launches."""
    import torch_parallel_ranks as ranks
    from hevcasm_tpu_torch.encode import video
    from hevcasm_tpu_torch.parallel import launch

    with pytest.raises(ValueError, match="backend='gloo'"):
        launch.spawn(ranks.card_two_ranks, 2, backend="nccl", device="cuda")
    inputs = sharded_inputs()
    outs = launch.spawn(ranks.card_two_ranks, 2, backend="gloo", device="cuda",
                        args=(inputs,), timeout_s=600)
    cfg = EncodeConfig(search_range=8, qp=32, inter_impl="fused_dma")
    sp = encode_inter_frame(*inputs["spatial"], cfg)
    gop = video.encode_gop_closed_loop(inputs["gop"], cfg, 3)
    dp = [encode_inter_frame(inputs["dp"][t + 1], inputs["dp"][t], cfg) for t in range(4)]
    for out in outs:
        assert (out["device"], out["mesh_type"]) == ("cuda:0", "cuda")
        assert out["spatial launches"] == (1, 1) and out["gop launches"] == (2, 2)
        assert out["dp launches"] == (2, 2)
        for k in ("recon", "sad", "nnz"):
            np.testing.assert_array_equal(out["spatial"][k], sp[k].cpu().numpy())
        np.testing.assert_array_equal(out["gop"]["recon"], gop["recon"].cpu().numpy())
        for t in range(4):
            for k in ("recon", "mvs", "sad", "nnz"):
                np.testing.assert_array_equal(out["dp"][k][t], dp[t][k].cpu().numpy())
