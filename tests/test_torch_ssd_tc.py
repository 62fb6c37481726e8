"""The tensor-core form of kernels K1 and B7 (csrc/ssd_grid_plane.cu) on the
CPU: a torch int64 mirror of the kernel's decomposition, with its tiling,

    out = S + E - 2 * sum_y A_y @ B_y,

where A_y is the staged window (m16 tiles of dy, k32 steps of columns, rows
beyond the window zero) and B_y the Toeplitz band of source row y, built
lane by lane from the 10 words of the padded source row that the kernel's
fragments take, with the k steps the kernel skips left out.  It is held
bit for bit against hevcasm_tpu's SSD grids.  The mirror is test code: the
package's plain version of K1 and B7 stays ``ssd_grid_plane_ref``.  The
kernel itself is held against that plain version in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.kernels.search_pallas import ssd_grid_plane as jax_ssd_grid_plane
from hevcasm_tpu.kernels.search_pallas import ssd_grid_plane_multi as jax_ssd_grid_plane_multi

import torch_testing  # noqa: F401
from hevcasm_tpu_torch.kernels import search

CTU = 64
MAX_MT, MAX_NT, MAX_KS = 5, 9, 4
OFF, ZW = 32, 32                 # source byte 0 at Z byte OFF; Z words a row
WS = 32 * MAX_KS + 16            # staged window row stride


def tiling(r):
    num, wide = 2 * r + 1, CTU + 2 * r
    return num, wide, -(-num // 16), -(-num // 8), -(-wide // 32)


def computed_steps(r):
    """The (k step, n tile) pairs the kernel runs: 32 ks - 8 nt in [-24,
    64], ks < KS, nt < NT."""
    _, _, _, nt_count, ks_count = tiling(r)
    return [(ks, nt) for ks in range(ks_count) for nt in range(nt_count)
            if -24 <= 32 * ks - 8 * nt <= 64]


def lane_words():
    """(32, 10, 4) byte indices into Z_y of each lane's 10 words: word i is
    the pair s_z[y][zq + 2i] (Z words zq + 2i and zq + 2i + 1) shifted right
    by zsh bits, as the kernel computes zq and zsh."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    zq = ((OFF + 4 * t - g) >> 2) - 2
    zsh = ((OFF + 4 * t - g) & 3) * 8
    i = np.arange(10)
    first = 4 * (zq[:, None] + 2 * i[None]) + zsh[:, None] // 8      # (32, 10)
    return first[..., None] + np.arange(4)


ZERO = 4 * ZW                     # an index past Z_y: the constant 0 word


def b_tile_index(ks, nt):
    """(32, 8) indices into Z_y (ZERO for a zero byte) of B_y's fragment at
    k step ks and n tile nt, put back in place from the lanes' registers:
    b0 holds k = 4t + byte, b1 k = 16 + 4t + byte, both at n = g."""
    words = lane_words()
    d = 32 * ks - 8 * nt
    idx = np.full((32, 8), ZERO, dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, dd in ((0, d), (1, d + 16)):
            if -8 <= dd <= 64:
                idx[16 * reg + 4 * t: 16 * reg + 4 * t + 4, g] = words[lane, (dd + 8) // 8]
    return idx


def a_tile_rows_cols():
    """Row and column offsets, in a 16 x 32 A tile, that the ldmatrix.x4
    registers of each lane hold, put back in place: lane L gives the
    address of row L & 15, byte 16 (L >> 4); register j of lane L is row
    L >> 2 (+ 8 for j odd), word L & 3 (+ 4 for j >= 2) of the tile."""
    rows = np.zeros((16, 32), dtype=np.int64)
    cols = np.zeros((16, 32), dtype=np.int64)
    for lane in range(32):
        for j in range(4):
            mat = j                                    # matrix j from lanes 8j..8j+7
            addr_lane = 8 * mat + (lane >> 2)          # the lane that gave its row
            row, col0 = addr_lane & 15, 16 * (addr_lane >> 4)
            fr = (lane >> 2) + 8 * (j & 1)             # the A fragment's row
            fc = 4 * (lane & 3) + 16 * (j >> 1)        # and first column
            for b in range(4):
                rows[fr, fc + b] = row
                cols[fr, fc + b] = col0 + 4 * (lane & 3) + b
    return rows, cols


def mirror(src, planes, grid, r):
    """The kernel's arithmetic in int64: src (n, 64, 64), planes (k, Hp,
    Wp) uint8 -> (n, k, 2R+1, 2R+1)."""
    num, wide, mt_count, nt_count, ks_count = tiling(r)
    wrows = CTU - 1 + 16 * mt_count
    gr, gc = grid
    n = src.shape[0]
    s = torch.as_tensor(src).long()
    # Z rows: s at OFF .. OFF + 63 and zeros around, plus the ZERO byte.
    z = torch.zeros((n, CTU, 4 * ZW + 1), dtype=torch.int64)
    z[:, :, OFF:OFF + CTU] = s
    s_total = (s * s).sum(dim=(1, 2))
    steps = computed_steps(r)
    b_idx = torch.as_tensor(np.stack([b_tile_index(ks, nt) for ks, nt in steps]))
    a_rows, a_cols = (torch.as_tensor(v) for v in a_tile_rows_cols())
    out = []
    for plane in torch.as_tensor(planes).long():
        win = torch.zeros((n, wrows, WS), dtype=torch.int64)
        for i in range(n):
            rr, cc = divmod(i, gc)
            win[i, :wide, :wide] = plane[CTU * rr: CTU * rr + wide, CTU * cc: CTU * cc + wide]
        # E: column sums of squares over 64 rows, then 64 of them across dx.
        sq = win[:, :wide, :wide] ** 2
        cs = sq.unfold(1, CTU, 1).sum(-1)[:, :num]                   # (n, num, wide)
        e = cs.unfold(2, CTU, 1).sum(-1)[:, :, :num]                 # (n, num, num)
        # C: warp mt's tiles, dy rows 16 mt .. 16 mt + 15 of every n tile.
        c = torch.zeros((n, mt_count, 16, nt_count, 8), dtype=torch.int64)
        m_rows = 16 * torch.arange(mt_count)[:, None, None] + a_rows
        for y in range(CTU):
            zy = z[:, y]                                             # (n, 129)
            a_steps = {ks: win[:, y + m_rows, 32 * ks + a_cols] for ks, _ in steps}
            for j, (ks, nt) in enumerate(steps):
                b = zy[:, b_idx[j]]                                  # (n, 32, 8)
                c[:, :, :, nt] += a_steps[ks] @ b[:, None]           # (n, MT, 16, 8)
        c = c.reshape(n, 16 * mt_count, 8 * nt_count)
        out.append(s_total[:, None, None] + e - 2 * c[:, :num, :num])
    return torch.stack(out, dim=1)


def gathered(plane, grid, r):
    gr, gc = grid
    size = CTU + 2 * r
    return np.stack([plane[CTU * i: CTU * i + size, CTU * j: CTU * j + size]
                     for i in range(gr) for j in range(gc)])


@pytest.mark.parametrize("r", [1, 2, 8, 17, 31, 32])
def test_fragments_rebuild_the_toeplitz_band_and_skip_only_zero_steps(r):
    # Every (k step, n tile) pair: the lanes' registers give B_y's tile
    # B[j][dx] = Z[OFF + j - dx]; the pairs the kernel skips are all zero.
    _, _, _, nt_count, ks_count = tiling(r)
    z = np.arange(1, 4 * ZW + 2, dtype=np.int64)
    z[:OFF] = z[OFF + CTU:] = 0
    z[ZERO] = 0
    steps = computed_steps(r)
    for ks in range(ks_count):
        for nt in range(nt_count):
            j = 32 * ks + np.arange(32)[:, None]
            dx = 8 * nt + np.arange(8)[None, :]
            want = np.where((j - dx >= 0) & (j - dx < CTU), z[np.clip(OFF + j - dx, 0, ZERO)], 0)
            if (ks, nt) in steps:
                np.testing.assert_array_equal(z[b_tile_index(ks, nt)], want)
            else:
                assert not want.any(), (ks, nt)


def test_ldmatrix_registers_are_the_a_fragment():
    rows, cols = a_tile_rows_cols()
    np.testing.assert_array_equal(rows, np.repeat(np.arange(16)[:, None], 32, 1))
    np.testing.assert_array_equal(cols, np.repeat(np.arange(32)[None, :], 16, 0))


def test_tensor_work_is_about_twice_the_useful_multiply_adds():
    # At R = 32: 5 m tiles x 26 pairs of 16 x 8 x 32 a source row.
    pairs = computed_steps(32)
    assert len(pairs) == 26
    issued = 5 * len(pairs) * 16 * 8 * 32
    assert 1.9 <= issued / (65 * 65 * 64) <= 2.0


def test_mirror_matches_jax_kernel():
    # tests/test_search_pallas.py's geometry: a 2x4 grid at R = 32.
    rng = np.random.default_rng(0x7C1)
    gr, gc = 2, 4
    plane = rng.integers(0, 256, (gr * 64 + 64, gc * 64 + 64), dtype=np.uint8)
    src = rng.integers(0, 256, (gr * gc, 64, 64), dtype=np.uint8)
    want = np.asarray(jax_ssd_grid_plane(src, jnp.asarray(plane), (gr, gc), 65))
    np.testing.assert_array_equal(mirror(src, plane[None], (gr, gc), 32)[:, 0].numpy(), want)


def test_mirror_matches_jax_multi_plane_kernel():
    rng = np.random.default_rng(0x7C2)
    gr, gc, k = 1, 2, 3
    planes = rng.integers(0, 256, (k, gr * 64 + 64, gc * 64 + 64), dtype=np.uint8)
    src = rng.integers(0, 256, (gr * gc, 64, 64), dtype=np.uint8)
    want = np.asarray(jax_ssd_grid_plane_multi(src, jnp.asarray(planes), (gr, gc), 65))
    np.testing.assert_array_equal(mirror(src, planes, (gr, gc), 32).numpy(), want)


@pytest.mark.parametrize("gc", [1, 3, 5])
@pytest.mark.parametrize("r", [1, 8, 17, 31, 32])
def test_mirror_matches_jax_grid_at_any_width(r, gc):
    rng = np.random.default_rng(100 * r + gc)
    grid = (1, gc)
    plane = rng.integers(0, 256, (64 + 2 * r, gc * 64 + 2 * r), dtype=np.uint8)
    src = rng.integers(0, 256, (gc, 64, 64), dtype=np.uint8)
    num = 2 * r + 1
    want = np.asarray(xla_opt.ssd_grid(src, gathered(plane, grid, r), num, num))
    np.testing.assert_array_equal(mirror(src, plane[None], grid, r)[:, 0].numpy(), want)


@pytest.mark.parametrize("r", [2, 32])
def test_mirror_on_a_constant_plane_ties_every_candidate(r):
    rng = np.random.default_rng(r)
    src = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    plane = np.full((64 + 2 * r, 3 * 64 + 2 * r), 97, dtype=np.uint8)
    got = mirror(src, plane[None], (1, 3), r)[:, 0]
    num = 2 * r + 1
    want = np.asarray(xla_opt.ssd_grid(src, gathered(plane, (1, 3), r), num, num))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got == got[:, :1, :1]).all())


@pytest.mark.parametrize("src_value,plane_value,want", [(0, 255, 4096 * 255 * 255),
                                                         (255, 255, 0), (255, 0, 4096 * 255 * 255)])
@pytest.mark.parametrize("r", [1, 32])
def test_mirror_extremes_stay_in_int32(r, src_value, plane_value, want):
    src = np.full((2, 64, 64), src_value, dtype=np.uint8)
    plane = np.full((64 + 2 * r, 128 + 2 * r), plane_value, dtype=np.uint8)
    got = mirror(src, plane[None], (1, 2), r)
    assert int(got.min()) == int(got.max()) == want < 2 ** 31
    plain = search.ssd_grid_plane_ref(src, plane, (1, 2), 2 * r + 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), plain.numpy())
