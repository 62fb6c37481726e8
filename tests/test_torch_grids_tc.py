"""The tensor-core forms of kernels B14 (csrc/base_grids.cu) and B8
(csrc/ssd_grid.cu) on the CPU: int64 mirrors of each kernel's tiling, held
against hevcasm_tpu.

Both multiply narrow bands (csrc/ssd_tc_core.cuh narrow_products): one m16
tile of dy against a band BW bytes wide whose first column is 16-aligned in
the staged window, the lanes' BW / 8 + 2 band words, only the (k step, n
tile) pairs with 32 ks - 8 nt in [-24, BW].  B14's block is (CTU, m tile);
warp w keeps sub-block column q = w mod k and loops over its sub-blocks
(p, q), its band taken from K1's Z at the column o = BASE q rounded down to
16 (BW = max(BASE, 16)), each word masked to the sub-block's columns.  B8's
block holds SB source blocks, MB m tiles of each and up to 9 n tiles (the
C entry's make_plan; chip_smoke.b8_plan), Z_y narrow (s[y] at byte 16, b /
4 + 8 word pairs).  E is the column sums of BASE (or b) rows of w^2, then
B14's exclusive prefix of them along each row (E the difference of two
entries BASE apart) or B8's sums of b of them; S is the sum of s^2; only
the candidates (dy, dx < num) reach the output.

Every entry of the tiles that is no candidate is poisoned with SSD 0 before
the epilogue, below every real SSD, so that only dy, dx < num can reach the
output.  The products run in int64, exact here (every sum is below 2^31).
The mirrors are test code: the package's plain versions stay
``base_grids_ctu_ref`` and ``ops.ssd.ssd_grid``, and the kernels are held
against them on the card in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from hevcasm_tpu.encode import partition as jax_partition
from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.kernels.search_pallas import base_grids_ctu as jax_base_grids_ctu

from hevcasm_tpu_torch.ops.ssd import ssd_grid as port_ssd_grid

from test_torch_ssd_tc import a_tile_rows_cols

CTU = 64
TILE = 16
WS = 144                         # B14's staged window row stride
MAX_NT = 9


def meets(bw, ks, nt):
    return -24 <= 32 * ks - 8 * nt <= bw


def step_meets(bw, ks):
    return any(meets(bw, ks, nt) for nt in range(MAX_NT))


def narrow_pairs(bw, ks_max, ks_count, nt_count):
    """The (k step, n tile) products a warp runs a source row."""
    return [(ks, nt) for ks in range(min(ks_max, ks_count)) if step_meets(bw, ks)
            for nt in range(min(MAX_NT, nt_count)) if meets(bw, ks, nt)]


def band_tile(bw, ks, nt, word, zero):
    """(32, 8) entries of B_y's fragment at k step ks and n tile nt, put back
    in place from the lanes' registers: b0 holds k = 4t + byte at d >= -8
    (word (d + 8) / 8), b1 k = 16 + 4t + byte at d <= bw - 16 (word (d + 24)
    / 8), both at n = g; word(lane, i) gives word i's 4 entries, and the
    rest are ``zero``."""
    d = 32 * ks - 8 * nt
    out = np.full((32, 8), zero, dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if d >= -8:
            out[4 * t:4 * t + 4, g] = word(lane, (d + 8) // 8)
        if d <= bw - 16:
            out[16 + 4 * t:16 + 4 * t + 4, g] = word(lane, (d + 24) // 8)
    return out


# ---- B14 ----------------------------------------------------------------------

def b14_band(base, q):
    """Sub-block column q's band: its first column o (16-aligned), BW, and
    (32, 8) source columns (-1 for a zero byte) of each fragment: lane word
    i holds source columns o - 8 + 8i + 4t - g + byte (K1's Z at word offset
    o / 8), masked to [BASE q, BASE q + BASE)."""
    bw, o = max(base, 16), base * q // 16 * 16

    def word(lane, i):
        g, t = lane >> 2, lane & 3
        cols = o - 8 + 8 * i + 4 * t - g + np.arange(4)
        return np.where((cols >= base * q) & (cols < base * q + base), cols, -1)

    tiles = {(ks, nt): band_tile(bw, ks, nt, word, -1)
             for ks in range(3) for nt in range(MAX_NT) if meets(bw, ks, nt)}
    return o, bw, tiles


def exclusive_prefix(rows):
    """(..., count) -> (..., count + 1): entry x is the sum of entries < x."""
    z = torch.zeros(rows.shape[:-1] + (1,), dtype=rows.dtype)
    return torch.cat([z, rows.cumsum(-1)], dim=-1)


def b14_mirror(src, windows, base, r, fill=-1):
    """B14's arithmetic, block by block: src (n, 64, 64), windows (n, 64+2R,
    64+2R) uint8 -> (n, k, k, 2R+1, 2R+1) int64; entries no warp writes keep
    ``fill``."""
    num, wide = 2 * r + 1, CTU + 2 * r
    k = CTU // base
    warps = min(k * k, 8)
    erows = TILE + CTU - base
    n = src.shape[0]
    s = torch.as_tensor(src).long()
    s_pad = torch.cat([s, torch.zeros((n, CTU, 1), dtype=torch.int64)], dim=2)   # column -1 reads 0
    win_all = torch.zeros((n, 16 * 5 + TILE + CTU, WS), dtype=torch.int64)
    win_all[:, :wide, :wide] = torch.as_tensor(windows).long()
    out = torch.full((n, k, k, num, num), fill, dtype=torch.int64)
    bands = [b14_band(base, q) for q in range(k)]
    ks_count, nt_count = -(-(num + max(base, 16) - 1) // 32), -(-num // 8)
    a_rows, a_cols = (torch.as_tensor(v) for v in a_tile_rows_cols())
    for m in range(-(-num // 16)):
        dy0 = TILE * m
        win = win_all[:, dy0:dy0 + TILE + CTU - 1]                      # the 79 staged rows
        w2 = win * win
        cs = torch.stack([w2[:, rr:rr + base].sum(1) for rr in range(erows)], dim=1)
        pre = exclusive_prefix(cs[:, :, :2 * CTU])                      # (n, EROWS, 129)
        rows = min(TILE, num - dy0)
        for warp in range(warps):
            q = warp % k
            o, bw, tiles = bands[q]
            for pq in range(warp, k * k, warps):
                p = pq // k
                tile = torch.zeros((n, TILE, 8 * MAX_NT), dtype=torch.int64)
                for ks, nt in narrow_pairs(bw, 3, ks_count, nt_count):
                    c = torch.zeros((n, TILE, 8), dtype=torch.int64)
                    for y in range(base * p, base * p + base):
                        a = win[:, y + a_rows, o + 32 * ks + a_cols]             # (n, 16, 32)
                        c += a @ s_pad[:, y][:, torch.as_tensor(tiles[(ks, nt)])]  # (n, 32, 8)
                    tile[:, :, 8 * nt:8 * nt + 8] -= 2 * c
                sq = (s[:, base * p:base * p + base, base * q:base * q + base] ** 2).sum((1, 2))
                e_rows = pre[:, base * p:base * p + TILE]
                dx = torch.arange(8 * MAX_NT)
                x0 = (base * q + dx).clamp(max=2 * CTU - base)
                tile += sq[:, None, None] + e_rows[:, :, x0 + base] - e_rows[:, :, x0]
                # The padded rows and columns: SSD 0, below every candidate.
                tile[:, rows:] = 0
                tile[:, :, num:] = 0
                out[:, p, q, dy0:dy0 + rows] = tile[:, :rows, :num]
    return out


def b14_case(n, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, CTU, CTU), dtype=np.uint8),
            rng.integers(0, 256, (n, CTU + 2 * r, CTU + 2 * r), dtype=np.uint8))


def xla_sub_block_grids(src, windows, base, r):
    """hevcasm_tpu's sub-block grids by xla_opt.ssd_grid (any R)."""
    g = jax_partition.base_grid_search(jnp.asarray(src), jnp.asarray(windows), r,
                                       xla_opt.ssd_grid, base)
    return np.asarray(g).astype(np.int64)


@pytest.mark.parametrize("base", [8, 16, 32])
def test_b14_mirror_matches_the_jax_kernel_at_r32(base):
    # JAX's B14 takes 128 x 128 windows (R = 32) only; run in interpret mode.
    src, win = b14_case(1 if base == 8 else 2, 32, 140 + base)
    want = np.asarray(jax_base_grids_ctu(jnp.asarray(src), jnp.asarray(win), base))
    np.testing.assert_array_equal(b14_mirror(src, win, base, 32).numpy(), want)


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("r", [1, 2, 8, 31])
def test_b14_mirror_matches_jax_sub_block_grids_at_other_radii(base, r):
    src, win = b14_case(2, r, 10 * base + r)
    np.testing.assert_array_equal(b14_mirror(src, win, base, r).numpy(),
                                  xla_sub_block_grids(src, win, base, r))


@pytest.mark.parametrize("base", [8, 16, 32])
def test_b14_warps_write_every_candidate_once(base):
    # Warp w's sub-blocks (p, w mod k) over the blocks' m tiles tile the
    # output: with a fill no SSD takes, none is left, and each (p, q, dy,
    # dx) is written once.
    r = 5
    src, win = b14_case(1, r, base)
    got = b14_mirror(src, win, base, r, fill=-7)
    assert not bool((got == -7).any())
    num, k = 2 * r + 1, CTU // base
    warps = min(k * k, 8)
    hits = np.zeros((k, k, num, num), dtype=int)
    for m in range(-(-num // 16)):
        for warp in range(warps):
            for pq in range(warp, k * k, warps):
                assert pq % k == warp % k
                hits[pq // k, pq % k, 16 * m:16 * m + 16] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("base", [8, 16, 32])
def test_b14_bands_rebuild_the_sub_block_column_and_skip_only_zero_steps(base):
    # Every (k step, n tile) pair of every column's band: the masked lane
    # words give B[j][dx] = s[o + j - dx] for o + j - dx in the sub-block's
    # columns, else 0; the pairs the kernel skips are all zero; the band's
    # columns stay in the staged row (o + 96 <= 144).
    for q in range(CTU // base):
        o, bw, tiles = b14_band(base, q)
        assert o % 16 == 0 and base * q - o + base <= bw and o + 96 <= WS
        for ks in range(3):
            for nt in range(MAX_NT):
                j = 32 * ks + np.arange(32)[:, None]
                dx = 8 * nt + np.arange(8)[None, :]
                col = o + j - dx
                want = np.where((col >= base * q) & (col < base * q + base), col, -1)
                if meets(bw, ks, nt):
                    np.testing.assert_array_equal(tiles[(ks, nt)], want)
                else:
                    assert (want == -1).all(), (q, ks, nt)


def test_b14_extremes_stay_in_int32():
    src = np.zeros((1, CTU, CTU), dtype=np.uint8)
    win = np.full((1, 128, 128), 255, dtype=np.uint8)
    got = b14_mirror(src, win, 32, 32)
    assert int(got.min()) == int(got.max()) == 32 * 32 * 255 * 255 < 2 ** 31


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("r", [1, 32])
def test_b14_products_count_matches_chip_smoke(base, r):
    # chip_smoke's design floor counts the products the tiling issues.
    num, bw, k = 2 * r + 1, max(base, 16), CTU // base
    pairs = narrow_pairs(bw, 3, -(-(num + bw - 1) // 32), -(-num // 8))
    assert chip_smoke.b14_products(3, base, r) == 3 * -(-num // 16) * k * k * base * len(pairs)


# ---- B8 -----------------------------------------------------------------------

MAX_WINDOW, ZOFF = 256, 16


def narrow(b):
    """(Z pairs a row, k steps, staged row stride) of B8 at block side b."""
    ks = -(-(8 * MAX_NT + b - 1) // 32)
    return b // 4 + 8, ks, 32 * ks + 16


def narrow_b_tile(b, ks, nt, zero):
    """(32, 8) indices into Z_y (``zero`` for a zero byte) of B_y's fragment:
    lane word i is the pair s_z[y][zq + 2i] shifted right by zsh bits, with
    s[y] at byte 16 (band_lane<16>)."""

    def word(lane, i):
        g, t = lane >> 2, lane & 3
        zq, zsh = ((ZOFF + 4 * t - g) >> 2) - 2, ((ZOFF + 4 * t - g) & 3) * 8
        return 4 * (zq + 2 * i) + zsh // 8 + np.arange(4)

    return band_tile(b, ks, nt, word, zero)


b8_plan = chip_smoke.b8_plan


def b8_mirror(src, windows, num_dy, num_dx, poison=True, fill=-1):
    """B8's arithmetic, block by block: src (n, b, b), windows (n, >= b +
    num_dy - 1, >= b + num_dx - 1) uint8 -> (n, num_dy, num_dx) int64."""
    n, b = src.shape[0], src.shape[1]
    zp, ks_max, ws = narrow(b)
    plan = b8_plan(b, n, num_dy, num_dx)
    mb, ntb = plan["mb"], plan["ntb"]
    s = torch.as_tensor(np.asarray(src)).long()
    w_all = torch.as_tensor(np.ascontiguousarray(windows)).long()
    # Z_y: s[y] at byte ZOFF of 4 (zp + 1) bytes, and one zero byte past it.
    zb = 4 * (zp + 1)
    z = torch.zeros((n, b, zb + 1), dtype=torch.int64)
    z[:, :, ZOFF:ZOFF + b] = s
    s_total = (s * s).sum((1, 2))
    a_rows, a_cols = (torch.as_tensor(v) for v in a_tile_rows_cols())
    out = torch.full((n, num_dy, num_dx), fill, dtype=torch.int64)
    for gy in range(-(-num_dy // (16 * mb))):
        for gz in range(-(-(-(-num_dx // 8)) // ntb)):
            dy0, dx0 = 16 * mb * gy, 8 * ntb * gz
            rows_valid, cols = min(16 * mb, num_dy - dy0), min(8 * ntb, num_dx - dx0)
            wrows, wcols = rows_valid + b - 1, cols + b - 1
            pairs = narrow_pairs(b, ks_max, -(-wcols // 32), -(-cols // 8))
            win = torch.zeros((n, plan["rows"], ws), dtype=torch.int64)
            win[:, :wrows, :wcols] = w_all[:, dy0:dy0 + wrows, dx0:dx0 + wcols]
            # E: column sums of b rows of w^2, then sums of b of them.
            w2 = win[:, :wrows, :wcols] ** 2
            cs = w2.unfold(1, b, 1).sum(-1)[:, :rows_valid]                # (n, rows, wcols)
            e = cs.unfold(2, b, 1).sum(-1)[:, :, :cols]
            b_idx = {pr: torch.as_tensor(narrow_b_tile(b, *pr, zb)) for pr in pairs}
            for m in range(mb):
                if 16 * m >= rows_valid:
                    continue
                tile = torch.zeros((n, 16, 8 * MAX_NT), dtype=torch.int64)
                for ks, nt in pairs:
                    c = torch.zeros((n, 16, 8), dtype=torch.int64)
                    for y in range(b):
                        a = win[:, 16 * m + y + a_rows, 32 * ks + a_cols]          # (n, 16, 32)
                        c += a @ z[:, y][:, b_idx[(ks, nt)]]                     # (n, 32, 8)
                    tile[:, :, 8 * nt:8 * nt + 8] -= 2 * c
                rows = min(16, rows_valid - 16 * m)
                tile[:, :rows, :cols] += s_total[:, None, None] + e[:, 16 * m:16 * m + rows]
                if poison:
                    tile[:, rows:] = 0
                    tile[:, :, cols:] = 0
                out[:, dy0 + 16 * m:dy0 + 16 * m + rows, dx0:dx0 + cols] = tile[:, :rows, :cols]
    return out


def b8_case(n, b, num_dy, num_dx, seed, extra=0, wider=0):
    """Blocks and windows; ``wider`` cuts each window from rows that many
    bytes wider, at byte offset 3 (a view), and ``extra`` adds rows and
    columns the grid does not read."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    wh, ww = b + num_dy - 1 + extra, b + num_dx - 1 + extra
    full = rng.integers(0, 256, (n, wh, ww + wider), dtype=np.uint8)
    return src, (full[:, :, 3:3 + ww] if wider else full)


def xla_grid(src, windows, num_dy, num_dx):
    return np.asarray(xla_opt.ssd_grid(jnp.asarray(src), jnp.asarray(np.ascontiguousarray(windows)),
                                       num_dy, num_dx)).astype(np.int64)


@pytest.mark.parametrize("b", [8, 16, 32, 64])
@pytest.mark.parametrize("num_dy,num_dx", [(33, 33), (7, 17), (17, 5), (1, 1), (65, 9)])
def test_b8_mirror_matches_xla_ssd_grid(b, num_dy, num_dx):
    n = 3 if b < 64 else 2
    src, win = b8_case(n, b, num_dy, num_dx, 1000 * b + 10 * num_dy + num_dx, extra=2)
    np.testing.assert_array_equal(b8_mirror(src, win, num_dy, num_dx).numpy(),
                                  xla_grid(src, win, num_dy, num_dx))


@pytest.mark.parametrize("b,num", [(8, 33), (16, 17), (32, 65), (64, 7)])
def test_b8_mirror_matches_on_window_views_into_wider_rows(b, num):
    src, win = b8_case(2, b, num, num, 7 * b + num, wider=13)
    assert not win.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(b8_mirror(src, win, num, num).numpy(),
                                  xla_grid(src, win, num, num))


@pytest.mark.parametrize("b,num_dy,num_dx", [(64, 129, 129), (8, 249, 249), (16, 150, 97)])
def test_b8_mirror_matches_the_plain_version_past_jaxs_window_limit(b, num_dy, num_dx):
    # Windows past hevcasm_tpu's 128-lane limit (the TPU kernel and
    # xla_opt.ssd_grid's tests stop there): held against the port's plain
    # ops.ssd.ssd_grid instead.  They tile the m and n ranges over blocks.
    src, win = b8_case(1, b, num_dy, num_dx, b + num_dy)
    plan = b8_plan(b, 1, num_dy, num_dx)
    assert -(-num_dy // (16 * plan["mb"])) > 1 or -(-(-(-num_dx // 8)) // plan["ntb"]) > 1
    want = port_ssd_grid(torch.as_tensor(src), torch.as_tensor(win), num_dy, num_dx)
    np.testing.assert_array_equal(b8_mirror(src, win, num_dy, num_dx).numpy(),
                                  want.numpy().astype(np.int64))


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b8_only_candidates_reach_the_output(b):
    # Poisoned (SSD 0) and unpoisoned padding give the same grids, every
    # candidate is written, and the poison lies below every candidate.
    src, win = b8_case(2, b, 19, 11, b)
    got = b8_mirror(src, win, 19, 11, poison=True, fill=-5)
    assert not bool((got == -5).any()) and int(got.min()) > 0
    np.testing.assert_array_equal(got.numpy(), b8_mirror(src, win, 19, 11, poison=False).numpy())


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_b8_fragments_rebuild_the_band_and_skip_only_zero_steps(b):
    # Every (k step, n tile) pair: the lanes' registers give B_y's tile
    # B[j][dx] = s[j - dx] for j - dx in [0, b), else 0; the pairs the
    # kernel skips (32 ks - 8 nt outside [-24, b]) are all zero.
    zp, ks_max, _ = narrow(b)
    zb = 4 * (zp + 1)
    zrow = np.zeros(zb + 1, dtype=np.int64)
    zrow[ZOFF:ZOFF + b] = np.arange(1, b + 1)
    for ks in range(ks_max):
        for nt in range(MAX_NT):
            j = 32 * ks + np.arange(32)[:, None]
            dx = 8 * nt + np.arange(8)[None, :]
            want = np.where((j - dx >= 0) & (j - dx < b), j - dx + 1, 0)
            if meets(b, ks, nt):
                np.testing.assert_array_equal(zrow[narrow_b_tile(b, ks, nt, zb)], want)
            else:
                assert not want.any(), (ks, nt)


def test_b8_plan_fits_every_geometry_the_wrapper_takes():
    # Every b and window up to 256 x 256: at most 8 warps and 227 KB a
    # block, and the staged rows hold what the m tiles' ldmatrix reads.
    for b in (8, 16, 32, 64):
        for num_dy in range(1, MAX_WINDOW - b + 2, 7):
            for num_dx in (1, 7, 17, 33, 65, 73, 97, 129, MAX_WINDOW - b + 1):
                if b + num_dx - 1 > MAX_WINDOW:
                    continue
                p = b8_plan(b, 32640, num_dy, num_dx)
                assert p["threads"] <= 256 and p["smem"] <= 227 * 1024, (b, num_dy, num_dx, p)
                assert p["mb"] <= 8 and p["ntb"] <= MAX_NT
                assert p["rows"] >= 16 * p["mb"] + b - 1


def test_b8_plan_at_the_path_shapes():
    # The PU decision at R = 16 on 8160 16x16 and 32640 8x8 blocks, and the
    # pyramid's levels: a few thousand blocks of 6-8 warps, not one a block.
    p = b8_plan(16, 8160, 33, 33)
    assert (p["sb"], p["mb"], p["ntb"], p["threads"]) == (2, 3, 5, 192) and p["smem"] < 64 * 1024
    assert (b8_plan(8, 32640, 33, 33)["sb"], b8_plan(16, 510, 17, 17)["sb"]) == (2, 4)
    assert b8_plan(64, 510, 65, 65)["threads"] == 5 * 32


@pytest.mark.parametrize("b,num", [(16, 33), (8, 33), (16, 17), (64, 7), (64, 65)])
def test_b8_products_count_matches_chip_smoke(b, num):
    # chip_smoke's design floor counts the products the tiling issues.
    n = 10
    plan = b8_plan(b, n, num, num)
    want = 0
    for gy in range(-(-num // (16 * plan["mb"]))):
        rows_valid = min(16 * plan["mb"], num - 16 * plan["mb"] * gy)
        for gz in range(-(-(-(-num // 8)) // plan["ntb"])):
            cols = min(8 * plan["ntb"], num - 8 * plan["ntb"] * gz)
            busy = sum(1 for m in range(plan["mb"]) if 16 * m < rows_valid)
            want += busy * len(narrow_pairs(b, narrow(b)[1], -(-(cols + b - 1) // 32),
                                            -(-cols // 8)))
    assert chip_smoke.b8_products(n, b, num, num) == n * b * want


def test_b8_extremes_stay_in_int32():
    for b in (8, 64):
        src = np.zeros((1, b, b), dtype=np.uint8)
        win = np.full((1, b + 16, b + 16), 255, dtype=np.uint8)
        got = b8_mirror(src, win, 17, 17)
        assert int(got.min()) == int(got.max()) == b * b * 255 * 255 < 2 ** 31
