"""The tensor-core form of kernel B15 (csrc/base_grids.cu) on the CPU: a
mirror of the kernel's decomposition, held against hevcasm_tpu's sub-block
grids and PU decision.

For CTU i, sub-block (p, q) of side BASE and candidate (dy, dx):

    grid_pq = S_pq + E_pq - 2 C_pq,  C_pq = sum_{y in band p} A_y @ B_{y,q},

with A_y the staged window at row offset y (m16 tiles of dy, k32 steps of
columns) and B_{y,q} K1's Toeplitz band of source row y, built lane by
lane from the lane's 10 band words, each ANDed with the mask of the bytes
whose source column lies in sub-block column q.  The mirror walks the
kernel's blocks (CTU, m tile, group of NG n tiles), runs only the (k step,
n tile) products whose band meets the sub-block, adds S and the BASE x
BASE box sums E, and decides each PU by the packed key (ssd << 32 | dy *
(2R+1) + dx) per block, the minimum over blocks, as the atomicMin does.
The products run in float64, exact here (every sum is below 2^31).  The
mirror is test code: the package's plain version of B15 stays
``base_layout_decide_ref``.  The kernel is held against it in
test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode import partition as jax_partition
from hevcasm_tpu.kernels import xla_opt
from hevcasm_tpu.kernels.search_pallas import base_layout_decide as jax_base_layout_decide

from hevcasm_tpu_torch.encode import partition
from hevcasm_tpu_torch.kernels import base_grids

CTU = 64
OFF = 32
WS = 144
MAX_NT, MAX_KS = 9, 4
NG = {8: 2, 16: 9, 32: 9}          # n tiles a block, by base
DEFAULT_LAYOUTS = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")


def tiling(r):
    num, wide = 2 * r + 1, CTU + 2 * r
    return num, wide, -(-num // 16), -(-num // 8), -(-wide // 32)


def band_meets(base, q, ks, nt):
    return base * q - 24 <= 32 * ks - 8 * nt <= base * q + base


def block_pairs(base, q, nt0, r):
    """The (k step, n tile) products warp q of a block at n tile nt0 runs."""
    _, _, _, nt_count, ks_count = tiling(r)
    return [(ks, nt) for ks in range(min(MAX_KS, ks_count))
            for nt in range(nt0, min(nt0 + NG[base], MAX_NT, nt_count))
            if band_meets(base, q, ks, nt)]


def lane_word_columns():
    """(32, 10, 4): the source column of byte b of lane L's band word i,
    -8 + 8i + 4t - g + b (ssd_tc_core.cuh's band_lane / band_word)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    i = np.arange(10)
    return (-8 + 8 * i[None, :, None] + (4 * t - g)[:, None, None]
            + np.arange(4)[None, None, :])


def b_tile_columns(base, q, ks, nt):
    """(32, 8) source columns (-1 for a zero byte) of B_{y,q}'s fragment at
    k step ks and n tile nt, put back in place from the lanes' registers:
    b0 holds k = 4t + byte, b1 k = 16 + 4t + byte, both at n = g; each
    word masked to the columns of sub-block column q."""
    cols = lane_word_columns()
    keep = (cols >= base * q) & (cols < base * q + base)
    masked = np.where(keep, cols, -1)
    d = 32 * ks - 8 * nt
    out = np.full((32, 8), -1, dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if d >= -8:
            out[4 * t:4 * t + 4, g] = masked[lane, (d + 8) // 8]
        if d + 16 <= 64:
            out[16 + 4 * t:16 + 4 * t + 4, g] = masked[lane, (d + 24) // 8]
    return out


def mirror(src, windows, base, lists, r):
    """The kernel's arithmetic: src (n, 64, 64), windows (n, 64+2R, 64+2R)
    uint8 -> (n, P, 3) [dy - R, dx - R, ssd]."""
    num, wide, mt_count, nt_count, ks_count = tiling(r)
    k = CTU // base
    ng = NG[base]
    vw = 8 * ng
    groups = -(-nt_count // ng)
    n = src.shape[0]
    tiles = {(q, ks, nt): b_tile_columns(base, q, ks, nt)
             for q in range(k) for ks in range(MAX_KS) for nt in range(MAX_NT)
             if band_meets(base, q, ks, nt)}
    out = np.zeros((n, len(lists), 3), dtype=np.int64)
    for i in range(n):
        s = src[i].astype(np.float64)
        sq = (s * s).reshape(k, base, k, base).sum(axis=(1, 3))
        s_pad = np.concatenate([s, np.zeros((CTU, 1))], axis=1)     # column -1 reads 0
        keys = np.full(len(lists), np.iinfo(np.int64).max, dtype=np.int64)
        for m in range(mt_count):
            dy0 = 16 * m
            win = np.zeros((16 + CTU - 1, WS))
            rows = max(0, min(16 + CTU - 1, wide - dy0))
            win[:rows, :wide] = windows[i, dy0:dy0 + rows]
            for grp in range(groups):
                nt0 = ng * grp
                dxg0 = 8 * nt0
                val = np.zeros((k, k, 16, vw))
                for q in range(k):
                    for p in range(k):
                        ys = np.arange(base * p, base * p + base)
                        for ks, nt in block_pairs(base, q, nt0, r):
                            a = win[ys[:, None, None] + np.arange(16)[None, :, None],
                                    32 * ks + np.arange(32)[None, None, :]]   # (BASE, 16, 32)
                            b = s_pad[ys[:, None, None], tiles[(q, ks, nt)][None]]
                            c = np.einsum("ymj,yjn->mn", a, b)
                            val[p, q, :, 8 * (nt - nt0):8 * (nt - nt0) + 8] -= 2 * c
                # + S + E: box sums of w^2 over the staged rows.
                w2 = win * win
                for p in range(k):
                    colsum = np.stack([w2[base * p + rr: base * p + rr + base].sum(0)
                                       for rr in range(16)])                   # (16, WS)
                    for q in range(k):
                        for dxl in range(vw):
                            x0 = dxg0 + dxl + base * q
                            val[p, q, :, dxl] += sq[p, q] + colsum[:, x0:x0 + base].sum(1)
                flat = val.reshape(k * k, 16, vw)
                r_idx = np.arange(16)[:, None]
                dx = dxg0 + np.arange(vw)[None, :]
                valid = (dy0 + r_idx < num) & (dx < num)
                idx = (dy0 + r_idx) * num + dx
                for pu, subs in enumerate(lists):
                    v = flat[list(subs)].sum(0).astype(np.int64)
                    key = np.where(valid, (v << 32) | idx, np.iinfo(np.int64).max)
                    keys[pu] = min(keys[pu], key.min())
        best, idx = keys >> 32, keys & 0xFFFFFFFF
        out[i] = np.stack([idx // num - r, idx % num - r, best], axis=-1)
    return out


def jax_decision(src, windows, base, lists, r):
    """hevcasm_tpu's sub-block grids, each PU's sum, its first minimum."""
    num, k = 2 * r + 1, CTU // base
    g = np.asarray(jax_partition.base_grid_search(jnp.asarray(src), jnp.asarray(windows), r,
                                                  xla_opt.ssd_grid, base))
    g = g.reshape(src.shape[0], k * k, num * num).astype(np.int64)
    out = []
    for subs in lists:
        pu = g[:, list(subs)].sum(1)
        idx = pu.argmin(1)
        out.append(np.stack([idx // num - r, idx % num - r, pu.min(1)], axis=-1))
    return np.stack(out, axis=1)


def default_lists(base):
    layouts = DEFAULT_LAYOUTS if base <= 16 else DEFAULT_LAYOUTS[:4]
    return partition._pu_lists(layouts, base)


def odd_lists(base):
    """PUs that are no rectangle: a diagonal, a checkerboard, a corner pair."""
    k = CTU // base
    return (tuple(i * k + i for i in range(k)),
            tuple(i * k + j for i in range(k) for j in range(k) if (i + j) % 2 == 0),
            (0, k * k - 1), (k - 1,))


def case(n, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, CTU, CTU), dtype=np.uint8),
            rng.integers(0, 256, (n, CTU + 2 * r, CTU + 2 * r), dtype=np.uint8))


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("r", [1, 3, 32])
def test_mirror_matches_jax_grids_and_first_minimum(base, r):
    src, win = case(1 if base == 8 and r == 32 else 2, r, 100 * base + r)
    lists = default_lists(base) + odd_lists(base)
    np.testing.assert_array_equal(mirror(src, win, base, lists, r),
                                  jax_decision(src, win, base, lists, r))


def test_mirror_matches_the_jax_kernel_in_interpret_mode():
    src, win = case(1, 32, 7)
    lists = default_lists(16)
    want = np.asarray(jax_base_layout_decide(jnp.asarray(src), jnp.asarray(win), 16, lists))
    np.testing.assert_array_equal(mirror(src, win, 16, lists, 32), want)


@pytest.mark.parametrize("r", [2, 32])
def test_mirror_ties_take_the_first_candidate(r):
    src, _ = case(2, r, r)
    win = np.full((2, CTU + 2 * r, CTU + 2 * r), 97, dtype=np.uint8)
    lists = default_lists(16)
    got = mirror(src, win, 16, lists, r)
    assert (got[:, :, :2] == -r).all()
    np.testing.assert_array_equal(got, base_grids.base_layout_decide_ref(src, win, 16,
                                                                         lists).numpy())


def test_mirror_extremes_stay_in_int32():
    src = np.zeros((1, CTU, CTU), dtype=np.uint8)
    win = np.full((1, 128, 128), 255, dtype=np.uint8)
    got = mirror(src, win, 32, default_lists(32), 32)
    assert int(got[0, -1, 2]) == 4096 * 255 * 255 < 2 ** 31


@pytest.mark.parametrize("base", [8, 16, 32])
@pytest.mark.parametrize("r", [1, 2, 17, 31, 32])
def test_fragments_rebuild_the_masked_band_and_skip_only_zero_steps(base, r):
    # Every (k step, n tile) pair of every sub-block column: the masked lane
    # words give B_{y,q}[j][dx] = s[j - dx] for j - dx in [BASE q, BASE q +
    # BASE), else 0; the pairs the kernel skips are all zero.
    _, _, _, nt_count, ks_count = tiling(r)
    for q in range(CTU // base):
        ran = {pair for nt0 in range(0, nt_count, NG[base])
               for pair in block_pairs(base, q, nt0, r)}
        for ks in range(ks_count):
            for nt in range(nt_count):
                j = 32 * ks + np.arange(32)[:, None]
                dx = 8 * nt + np.arange(8)[None, :]
                want = np.where((j - dx >= base * q) & (j - dx < base * q + base), j - dx, -1)
                if (ks, nt) in ran:
                    np.testing.assert_array_equal(b_tile_columns(base, q, ks, nt), want)
                else:
                    assert (want == -1).all(), (q, ks, nt)


@pytest.mark.parametrize("base,low,high", [(8, 3.2, 3.6), (16, 1.9, 2.2), (32, 1.2, 1.5)])
def test_tensor_work_against_k1s(base, low, high):
    # The products a CTU runs at R = 32, against K1's 5 x 26 a source row:
    # the narrow bands pad their n tiles.
    k = CTU // base
    per_row = sum(len(block_pairs(base, q, nt0, 32)) for q in range(k)
                  for nt0 in range(0, MAX_NT, NG[base]))
    assert low <= per_row / 26 <= high


@pytest.mark.parametrize("kernel", ["B9", "B15", "B14", "B8", "K1", "B17", "B19"])
def test_phase_cost_ablations_still_match_the_kernel_sources(kernel):
    # tools/b9_b15_phase_costs.py (B9, B15, B14, B8) and tools/k1_phase_costs.py (K1,
    # B17, B19, whose edits name the file: the kernel's source or the shared
    # ssd_tc_core.cuh) edit the sources by text; each edit must still find
    # its text once, or the tool stops on the card.
    from pathlib import Path

    from tools import b9_b15_phase_costs, k1_phase_costs

    tool = b9_b15_phase_costs if kernel in ("B9", "B15", "B14", "B8") else k1_phase_costs
    source, entry, variants = tool.ABLATIONS[kernel]
    csrc = Path(base_grids.build.CSRC)
    assert f'extern "C" int {entry}(' in (csrc / source).read_text()
    for name, edits in variants.items():
        for edit in edits:
            fname, old = (source, edit[0]) if len(edit) == 2 else edit[:2]
            assert (csrc / fname).read_text().count(old) == 1, (name, fname, old)
        if tool is k1_phase_costs:
            k1_phase_costs.edited_sources(kernel, edits, csrc)
