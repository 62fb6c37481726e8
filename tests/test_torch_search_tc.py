"""The keyed epilogue of kernels B17 (csrc/search_mv.cu) and B19 (csrc/mega.cu)
on the CPU: K1's tensor-core tiling (the int64 mirror of
test_torch_ssd_tc.py: A_y from ldmatrix, B_y from the lanes' band words,
only the (k step, n tile) pairs the kernel runs) over whole m16 x n8 tiles,
then the first minimum as the lanes take it.

Lane (g, t) of warp w holds, in accumulator i of n tile nt, the candidate

    dy = 16 w + g + 8 (i >> 1),  dx = 8 nt + 2t + (i & 1),

and turns S + E - 2C into the packed key (SSD << 32) | (dy (2R+1) + dx)
for dy, dx < 2R + 1 only; the lane's minimum, then the warp's (shuffles),
then the block's (shared memory) is the first minimum in row-major [dy, dx]
order.  The tiles' padded rows and columns are computed from whatever lies
past the window (random bytes here, as stale shared memory on the card) and
never enter a key; one case poisons them with SSD 0, below every real SSD.
The result is held bit for bit against hevcasm_tpu's search_mv and
search_mv_dma (interpret mode), against the mv and best of its
encode_ctu_mega, and against its full search at R from 1 to 32.  The
mirror is test code: the package's plain versions stay search_mv_ref,
search_mv_dma_ref and encode_ctu_mega_ref.  The kernels are held against
them in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels import xla_opt

from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.utils.tensor import PAD_L

from test_torch_mega import jax_result, port_inputs
from test_torch_search import b17_case
from test_torch_ssd_tc import CTU, OFF, WS, ZW, a_tile_rows_cols, b_tile_index, computed_steps, tiling

NO_KEY = torch.iinfo(torch.int64).max


def lane_candidates(r):
    """(MT, 32, NT, 4) dy and dx of each warp, lane, n tile and accumulator."""
    _, _, mt_count, nt_count, _ = tiling(r)
    w, lane, nt, i = np.meshgrid(np.arange(mt_count), np.arange(32), np.arange(nt_count),
                                 np.arange(4), indexing="ij")
    g, t = lane >> 2, lane & 3
    return 16 * w + g + 8 * (i >> 1), 8 * nt + 2 * t + (i & 1)


def tile_values(src, windows, r, seed=0):
    """S + E - 2C of every entry of every warp's tiles, (n, 16 MT, 8 NT)
    int64, and the mask of the candidates (dy, dx < 2R + 1).  windows (n,
    64 + 2R, 64 + 2R): each CTU's window.  The staged rows past the window
    (to row 63 + 16 MT - 1) hold random bytes, and E is 0 outside the
    candidates: those entries are whatever the tiles compute."""
    num, wide, mt_count, nt_count, _ = tiling(r)
    wrows = CTU - 1 + 16 * mt_count
    n = src.shape[0]
    s = torch.as_tensor(np.asarray(src)).long()
    win = torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (n, wrows, WS)))
    win[:, :wide, :] = 0
    win[:, :wide, :wide] = torch.as_tensor(np.asarray(windows)).long()[:, :wide, :wide]
    z = torch.zeros((n, CTU, 4 * ZW + 1), dtype=torch.int64)
    z[:, :, OFF:OFF + CTU] = s
    steps = computed_steps(r)
    b_idx = torch.as_tensor(np.stack([b_tile_index(ks, nt) for ks, nt in steps]))
    a_rows, a_cols = (torch.as_tensor(v) for v in a_tile_rows_cols())
    c = torch.zeros((n, mt_count, 16, nt_count, 8), dtype=torch.int64)
    m_rows = 16 * torch.arange(mt_count)[:, None, None] + a_rows
    for y in range(CTU):
        a_steps = {ks: win[:, y + m_rows, 32 * ks + a_cols] for ks, _ in steps}
        for j, (ks, nt) in enumerate(steps):
            c[:, :, :, nt] += a_steps[ks] @ z[:, y][:, b_idx[j]][:, None]
    c = c.reshape(n, 16 * mt_count, 8 * nt_count)
    sq = win[:, :wide, :wide] ** 2
    e = torch.zeros_like(c)
    e[:, :num, :num] = sq.unfold(1, CTU, 1).sum(-1)[:, :num].unfold(2, CTU, 1).sum(-1)[:, :, :num]
    valid = torch.zeros(c.shape[1:], dtype=torch.bool)
    valid[:num, :num] = True
    return (s * s).sum(dim=(1, 2))[:, None, None] + e - 2 * c, valid


def keyed_min(values, valid, r, poison=None, filtered=True):
    """(mv (n, 2), best (n,)) int32 of the block's least key, reduced as
    the kernel does: each lane over its accumulators, the warp over its
    lanes, the block over its warps.  poison: the value put in every entry
    that is no candidate; filtered=False lets those entries in."""
    num = 2 * r + 1
    dy, dx = (torch.as_tensor(v) for v in lane_candidates(r))
    if poison is not None:
        values = torch.where(valid, values, torch.full_like(values, poison))
    held = values[:, dy, dx]                                         # (n, MT, 32, NT, 4)
    keys = (held << 32) | (dy * num + dx)
    if filtered:
        keys = torch.where(valid[dy, dx], keys, torch.full_like(keys, NO_KEY))
    key = keys.amin(dim=(3, 4)).amin(dim=2).amin(dim=1)
    idx, best = key & 0xFFFFFFFF, key >> 32
    return (torch.stack([idx // num - r, idx % num - r], dim=-1).to(torch.int32),
            best.to(torch.int32))


def windows_at(padded, pos, r):
    """Each CTU's search window, at pos + PAD_L in the padded plane, clamped
    as the kernels clamp."""
    return tmotion.extract_windows(torch.as_tensor(np.asarray(padded)),
                                   torch.as_tensor(np.asarray(pos)) + PAD_L, CTU + 2 * r)


def jax_full_search(cur, ref, r):
    """hevcasm_tpu's full search with its XLA SSD grid: (src, padded, pos,
    (mv, best)) of a frame."""
    h, w = cur.shape
    src = tctu.tile_frame(torch.as_tensor(cur), CTU).contiguous()
    padded = tctu.pad_frame(torch.as_tensor(ref), r + 3, r + 4, r + 3, r + 4)
    pos = tmotion.ctu_positions(h // CTU, w // CTU, CTU)
    want = jmotion.full_search(jnp.asarray(src.numpy()), jnp.asarray(padded.numpy()),
                               jnp.asarray(pos.numpy()), r, grid_fn=xla_opt.ssd_grid)
    return src, padded, pos, [np.asarray(o) for o in want]


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("r", [1, 2, 8, 17, 31, 32])
def test_lanes_hold_every_candidate_once(r):
    num = 2 * r + 1
    dy, dx = lane_candidates(r)
    inside = (dy < num) & (dx < num)
    held = np.zeros((num, num), dtype=np.int64)
    np.add.at(held, (dy[inside], dx[inside]), 1)
    assert (held == 1).all()
    assert dy.max() == 16 * (-(-num // 16)) - 1 and dx.max() == 8 * (-(-num // 8)) - 1


@pytest.mark.parametrize("entry", ["mv", "dma"])
@pytest.mark.parametrize("content", ["random", "constant"])
def test_keyed_epilogue_matches_jax_search_kernels(content, entry):
    # hevcasm_tpu's search_mv and search_mv_dma in interpret mode, 3 x 4
    # CTUs at R = 32: random planes, and a constant reference on which
    # every candidate ties and the first, (-R, -R), must win.
    (src, padded, pos, win), want = b17_case(content)
    windows = win if entry == "mv" else windows_at(padded, pos, 32)
    got = keyed_min(*tile_values(src, windows, 32), 32)
    assert_equal(got, want[entry])
    if content == "constant":
        assert (got[0] == -32).all()
    else:
        assert len(torch.unique(got[1])) == len(got[1]) and (got[1] > 0).all()


@pytest.mark.parametrize("case", ["odd", "even", "corner"])
def test_keyed_epilogue_matches_jax_mega_search(case):
    # hevcasm_tpu's encode_ctu_mega: a panned picture at R = 8 on odd and
    # even CTU-grid widths, and noise shifted by 2R at R = 16, where MVs
    # reach the edges of the range.
    src, padded, pos, r = port_inputs(case)
    want = jax_result(case)
    got = keyed_min(*tile_values(src, windows_at(padded, pos, r), r), r)
    assert_equal(got, (want[1], want[3]))
    if case == "corner":
        assert (got[0].abs() == r).any()


@pytest.mark.parametrize("r,gc", [(1, 3), (2, 2), (8, 3), (17, 1), (31, 2), (32, 3)])
def test_keyed_epilogue_matches_jax_full_search_at_any_radius(r, gc):
    rng = np.random.default_rng(1000 + r)
    cur = rng.integers(0, 256, (CTU, CTU * gc), dtype=np.uint8)
    ref = rng.integers(0, 256, (CTU, CTU * gc), dtype=np.uint8)
    src, padded, pos, want = jax_full_search(cur, ref, r)
    got = keyed_min(*tile_values(src, windows_at(padded, pos, r), r, seed=r), r)
    assert_equal(got, want)


@pytest.mark.parametrize("r", [8, 32])
def test_keyed_epilogue_finds_mvs_at_the_edge_of_the_range(r):
    # cur[y, x] = ref[y - R, x + R]: the best match sits at (-R, +R), and
    # is exact for the CTUs whose window holds it unwrapped.
    rng = np.random.default_rng(7 * r)
    ref = rng.integers(0, 256, (2 * CTU, 3 * CTU), dtype=np.uint8)
    cur = np.roll(ref, (r, -r), axis=(0, 1))
    src, padded, pos, want = jax_full_search(cur, ref, r)
    got = keyed_min(*tile_values(src, windows_at(padded, pos, r), r), r)
    assert_equal(got, want)
    edge = (got[0] == torch.tensor([-r, r], dtype=torch.int32)).all(-1)
    assert int(edge.sum()) >= 2 and int((got[1][edge] == 0).sum()) >= 2


@pytest.mark.parametrize("r,gc", [(8, 3), (32, 2)])
def test_poisoned_padding_never_wins(r, gc):
    # Every entry of the tiles that is no candidate set to SSD 0, below
    # every real SSD on noise: the filtered minimum is still JAX's, and
    # the unfiltered one would have taken a padded entry.
    rng = np.random.default_rng(2000 + r)
    cur = rng.integers(0, 256, (CTU, CTU * gc), dtype=np.uint8)
    ref = rng.integers(0, 256, (CTU, CTU * gc), dtype=np.uint8)
    src, padded, pos, want = jax_full_search(cur, ref, r)
    values, valid = tile_values(src, windows_at(padded, pos, r), r)
    assert (values[:, valid] > 0).all()
    assert_equal(keyed_min(values, valid, r, poison=0), want)
    leaked = keyed_min(values, valid, r, poison=0, filtered=False)
    assert (leaked[1] == 0).all() and not np.array_equal(leaked[0].numpy(), want[0])
