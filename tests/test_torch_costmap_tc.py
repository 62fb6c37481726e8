"""The tensor-core refinement of kernels B11, B12 and B13 on the CPU
(csrc/refine_tile_tc.cuh for tile sides 8, 16 and 32, and at side 64 the
64x64 core of csrc/refine_tc_core.cuh on a gathered window; csrc/costmap.cu,
csrc/refine_fused.cu): an int64 mirror of the kernels' tiling, fragment by
fragment.  Shared memory is a flat byte array per warp (per block at side
64), addressed as the kernels address it; every mma.sync operand is read as
the lanes read it (test_torch_refine_tc.py's fragment helpers), and the
score, the warp's sums, the first minimum and the winner proceed from the
lanes' accumulator registers as the kernels do.

Shared memory starts poisoned with random bytes: the kernels write only the
(b+7)^2 windows (and the last word's spare byte, 0), and whatever else the
products read meets only zero taps.  The mirror is held bit for bit against
hevcasm_tpu's refine_qpel_costmap, refine_qpel_costmap_dma and
refine_quarter_pel_fused in interpret mode, on smooth, constant and
adversarial content (the horizontal pass at 22440 and -6120), and against
the port's plain versions, also for window starts past the plane's end.
The kernels themselves are held against those plain versions in
test_torch_cuda.py."""

import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels.interp_pallas import refine_qpel_costmap as jax_b12
from hevcasm_tpu.kernels.interp_pallas import refine_qpel_costmap_dma as jax_b13
from hevcasm_tpu.kernels.interp_pallas import refine_quarter_pel_fused as jax_b11

import chip_smoke
import test_torch_refine_tc as k2m
from hevcasm_tpu_torch.kernels import build, costmap, inter_fused
from hevcasm_tpu_torch.ops.pred_inter import KERNEL8

G, T, LANE = k2m.G, k2m.T, k2m.LANE
SIDES = (8, 16, 32, 64)


@functools.lru_cache(maxsize=None)
def geom(s):
    """rtc::Tile<s> (csrc/refine_tile_tc.cuh)."""
    win = s + 7
    h_nt = (win + 7) // 8
    hrows = 8 * h_nt
    cg = 2 if s == 32 else 1
    hs = 48 if 2 * hrows <= 48 else 80
    win_bytes = hrows * 48
    return SimpleNamespace(s=s, win=win, qw=(win + 3) // 4, per_warp=2 if s == 8 else 1, cg=cg,
                           cols=16 * cg, vt=s // 8, frags=cg * (s // 8), h_nt=h_nt, hrows=hrows,
                           ws=48, hs=hs, lo=hrows, win_bytes=win_bytes,
                           warp_bytes=win_bytes + 4 * 16 * cg * hs)


# ---- the small-tile core, one warp a tile (two at side 8) ----------------------------

def warps_of(g, n):
    return -(-n // g.per_warp)


def stage(g, wins, rng, poison=True):
    """(warps, WARP_BYTES) shared memory after step 1: tile p of a warp at
    column 16 p of rows WS apart; a row's last word has its bytes past the
    window 0 (row_word); everything else poisoned."""
    nw = warps_of(g, len(wins))
    smem = (rng.integers(0, 256, (nw, g.warp_bytes)) if poison
            else np.zeros((nw, g.warp_bytes), dtype=np.int64))
    for i, w in enumerate(wins):
        rows = smem[i // g.per_warp, :g.win_bytes].reshape(g.hrows, g.ws)
        c0 = 16 * (i % g.per_warp)
        rows[:g.win, c0:c0 + 4 * g.qw] = 0
        rows[:g.win, c0:c0 + g.win] = w
    return smem


def a_fragments(g):
    """(4, 32, 4) the horizontal pass's A registers: K2's, or at side 8 the
    block-diagonal band {w, 0, 0, w}."""
    a = k2m.band_fragments().copy()
    if g.s == 8:
        a[:, :, 1] = 0
        a[:, :, 3] = a[:, :, 0]
    return a


def horizontal(g, smem):
    """Step 2 in place: hp[xf][col][row] as hi and lo bytes of each column."""
    a = a_fragments(g)
    for mt in range(g.cg):
        for nt in range(g.h_nt):
            wr = (8 * nt + G) * g.ws + 16 * mt + 4 * T
            b = np.stack([k2m.lds32(smem, wr), k2m.lds32(smem, wr + 16)], -1)
            for xf in range(4):
                d = k2m.mma(np.zeros(b.shape[:-1] + (4,), dtype=np.int64), a[xf], b, False)
                for h in range(2):
                    off = g.win_bytes + (xf * g.cols + 16 * mt + G + 8 * h) * g.hs + 8 * nt + 2 * T
                    v0, v1 = d[..., 2 * h], d[..., 2 * h + 1]
                    smem[:, off], smem[:, off + 1] = (v0 >> 8) & 255, (v1 >> 8) & 255
                    smem[:, off + g.lo], smem[:, off + g.lo + 1] = v0 & 255, v1 & 255
    return smem


def fragment(g, smem, xf, f):
    """tile_fragment: the hi and lo A registers (warps, 32, 2)."""
    p = g.win_bytes + (xf * g.cols + 16 * (f // g.vt) + G) * g.hs + 8 * (f % g.vt) + 4 * T
    hi = np.stack([k2m.lds32(smem, p), k2m.lds32(smem, p + 8 * g.hs)], -1)
    lo = np.stack([k2m.lds32(smem, p + g.lo), k2m.lds32(smem, p + 8 * g.hs + g.lo)], -1)
    return hi, lo


def lane_pixels(g, f):
    """tile_pixel: (32, 4) the tile (0, or at side 8 r >> 1) and the offset
    y * s + x of each lane's register r in fragment f."""
    r = np.arange(4)
    y = 8 * (f % g.vt) + 2 * T[:, None] + (r & 1)
    if g.s == 8:
        return np.broadcast_to(r >> 1, (32, 4)), y * g.s + G[:, None]
    return np.zeros((32, 4), dtype=int), y * g.s + 16 * (f // g.vt) + G[:, None] + 8 * (r >> 1)


def sources(g, src):
    """tile_source: (warps, frags, 32, 4) the lanes' source bytes; a last
    pair's missing tile 1 reads tile 0, as the kernel's s1 does."""
    n = len(src)
    flat = src.reshape(n, -1).astype(np.int64)
    out = np.zeros((warps_of(g, n), g.frags, 32, 4), dtype=np.int64)
    for w in range(out.shape[0]):
        t0 = w * g.per_warp
        count = min(g.per_warp, n - t0)
        for f in range(g.frags):
            tile, off = lane_pixels(g, f)
            out[w, f] = flat[t0 + np.minimum(tile, count - 1), off]
    return out


def scores(g, smem, src4):
    """Step 3: res (warps, per_warp, 4 xf, 32 lanes), lane l holding the
    warp sum of candidate ((l >> 3) & 3, xf)."""
    w = k2m.band_words()
    res = np.zeros((smem.shape[0], g.per_warp, 4, 32), dtype=np.int64)
    for xf in range(4):
        v = np.zeros((smem.shape[0], g.per_warp, 32, 4), dtype=np.int64)     # [..., yf]
        for f in range(g.frags):
            hi, lo = fragment(g, smem, xf, f)
            c = -(src4[:, f] << 4)
            for yf in range(4):
                t = np.abs(k2m.vertical_acc(c, w[yf], hi, lo)) >> 4
                if g.s == 8:
                    v[:, 0, :, yf] += t[..., 0] + t[..., 1]
                    v[:, 1, :, yf] += t[..., 2] + t[..., 3]
                else:
                    v[:, 0, :, yf] += t.sum(-1)
        for p in range(g.per_warp):
            res[:, p, xf] = k2m.warp_sums4(v[:, p])
    return res


def tile_first_min(res):
    """(..., 4 xf, 32) -> (best, best_cost): lane l offers res[l & 3][l];
    the first lane with bit 2 clear that holds the minimum wins."""
    v = res[..., LANE & 3, LANE]
    m = v.min(-1)
    lane = np.argmax((v == m[..., None]) & ((LANE & 4) == 0), axis=-1)
    return (lane >> 3) * 4 + (lane & 3), m


def winners(g, smem, best):
    """tile_winner: each warp's predictions written over its window, then
    read back as the tiles' (s, s) blocks."""
    w = k2m.band_words()
    out = smem[:, :g.win_bytes].copy()
    for wi in range(smem.shape[0]):
        for f in range(g.frags):
            tile, off = lane_pixels(g, f)
            for p in range(g.per_warp):
                yf, xf = best[wi, p] >> 2, best[wi, p] & 3
                hi, lo = fragment(g, smem[wi:wi + 1], xf, f)
                d = k2m.vertical_acc(np.full((1, 32, 4), 8, dtype=np.int64), w[yf], hi, lo)[0]
                mine = tile == p
                out[wi, p * g.s * g.s + off[mine]] = np.clip(d[mine] >> 12, 0, 255)
    return out[:, :g.per_warp * g.s * g.s].reshape(-1, g.s, g.s)


# ---- side 64: K2's block core on a gathered window --------------------------------

def stage_gathered(wins, rng, poison=True):
    """(n, 72 * 80): the 71 x 71 corner staged, 18 words a row (col 71 0),
    rows 71.. and columns 72.. poisoned."""
    n = len(wins)
    buf = (rng.integers(0, 256, (n, k2m.ROWS, k2m.WS)) if poison
           else np.zeros((n, k2m.ROWS, k2m.WS), dtype=np.int64))
    buf[:, :k2m.WIN, :72] = 0
    buf[:, :k2m.WIN, :k2m.WIN] = wins
    return buf.reshape(n, -1)


def ctu_mirror(src, wins, rng, poison, winner):
    hp = k2m.horizontal_pass(stage_gathered(wins, rng, poison), k2m.band_fragments())
    if poison:
        hp = k2m.poison_hp(hp, rng)
    cost = k2m.vertical_scores(hp, src, k2m.band_words())
    if not winner:
        return k2m.warp_table(cost).sum(1).reshape(-1, 4, 4)
    best, best_cost, _ = k2m.select_first_min(cost)
    pred = np.clip(k2m.winner_acc(hp, k2m.band_words(), best, 8) >> 12, 0, 255)
    return pred, best, best_cost


def mirror(src, wins, seed=0, poison=True, winner=False):
    """B12/B13's cost maps (n, 4, 4), or B11's (pred, frac, cost), from the
    tiles' (b+7)^2 windows."""
    rng = np.random.default_rng(seed)
    n, b = src.shape[0], src.shape[-1]
    wins = np.asarray(wins)[:, :b + 7, :b + 7].astype(np.int64)
    if b == 64:
        out = ctu_mirror(src, wins, rng, poison, winner)
    else:
        g = geom(b)
        smem = horizontal(g, stage(g, wins, rng, poison))
        res = scores(g, smem, sources(g, src))
        if not winner:
            out = res[..., 8 * np.arange(4)].transpose(0, 1, 3, 2).reshape(-1, 4, 4)[:n]
        else:
            best, best_cost = tile_first_min(res)
            out = (winners(g, smem, best)[:n], best.reshape(-1)[:n], best_cost.reshape(-1)[:n])
    if not winner:
        return out.astype(np.int32)
    return out[0].astype(np.uint8), out[1].astype(np.int32), out[2].astype(np.int32)


def plane_windows(plane, offsets, b):
    """B13's windows: each start clamped so the (b+7)^2 window fits."""
    w = b + 7
    y = np.clip(offsets[:, 0], 0, plane.shape[0] - w)
    x = np.clip(offsets[:, 1], 0, plane.shape[1] - w)
    return np.stack([plane[a:a + w, c:c + w] for a, c in zip(y, x)])


# ---- inputs -------------------------------------------------------------------

CONTENTS = ("smooth", "constant", "adversarial", "adversarial inverted")
COUNTS = {8: 5, 16: 3, 32: 2, 64: 2}      # 5 at side 8: a last pair with one tile


@functools.lru_cache(maxsize=None)
def case(b, content):
    """(src (n, b, b), plane, offsets (n, 2)): window starts over [0, the
    largest that fits], the first at (0, 0) and the last at the maximum."""
    rng = np.random.default_rng(b * 100 + CONTENTS.index(content))
    n = COUNTS[b]
    shape = (2 * b + 40, 3 * b + 40)
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    if content == "smooth":
        base = rng.integers(0, 256, (shape[0] + 2, shape[1] + 2)).astype(np.float32)
        base = (base[:-2, :-2] + base[1:-1, 1:-1] + base[2:, 2:]) / 3
        plane = np.clip(base + rng.normal(0, 2, base.shape), 0, 255).astype(np.uint8)
    elif content == "constant":
        plane = np.full(shape, 97, dtype=np.uint8)
    else:
        plane = chip_smoke.adversarial_plane(shape, "cpu", content.endswith("inverted")).numpy()
        src = np.where(rng.random((n, b, b)) < 0.5, 0, 255).astype(np.uint8)
    lim = np.array(shape) - (b + 7)
    offsets = (rng.random((n, 2)) * (lim + 1)).astype(np.int32)
    offsets[0], offsets[-1] = 0, lim
    if content == "smooth":                # near the integer MV: the fractions differ
        for i in range(0, n, 2):
            y, x = np.minimum(offsets[i] + (3, 4), np.array(shape) - b)
            src[i] = plane[y:y + b, x:x + b]
    return src, plane, offsets


def gathered(b, content, extra=3):
    """B11's and B12's windows, (b+7+extra) square from the plane (the
    kernels read their top-left (b+7)^2)."""
    src, plane, offsets = case(b, content)
    pad = np.pad(plane, ((0, extra), (0, extra)))
    return src, plane_windows(pad, offsets, b + extra)


@functools.lru_cache(maxsize=None)
def jax_out(kernel, b, content):
    src, plane, offsets = case(b, content)
    if kernel == "B13":
        cost, win = jax_b13(jnp.asarray(src), jnp.asarray(plane), jnp.asarray(offsets))
        return np.asarray(cost), np.asarray(win)[:, :b + 7, :b + 7]
    src, wins = gathered(b, content)
    if kernel == "B12":
        return np.asarray(jax_b12(jnp.asarray(src), jnp.asarray(wins)))
    return tuple(np.asarray(o) for o in jax_b11(jnp.asarray(src), jnp.asarray(wins)))


def assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


# ---- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 16, 32])
def test_tile_layout_reads_and_stores_hit_32_banks(s):
    # A fragment's 32 lanes read 32 distinct banks (or one word together);
    # the horizontal pass's 16-bit stores of two lanes share a word.
    g = geom(s)

    def banks_distinct(addr):
        words = addr // 4
        banks = words % 32
        return all(len({w for w, k in zip(words, banks) if k == bank}) <= 1
                   for bank in set(banks))

    for mt in range(g.cg):
        for nt in range(g.h_nt):
            wr = (8 * nt + G) * g.ws + 16 * mt + 4 * T
            assert banks_distinct(wr) and banks_distinct(wr + 16)
            assert (wr % g.ws + 19).max() < g.ws                 # b1's bytes lie in the row
            for xf in range(4):
                for h in range(2):
                    off = (xf * g.cols + 16 * mt + G + 8 * h) * g.hs + 8 * nt + 2 * T
                    assert banks_distinct(off) and banks_distinct(off + g.lo)
    for f in range(g.frags):
        p = (16 * (f // g.vt) + G) * g.hs + 8 * (f % g.vt) + 4 * T
        for q in (p, p + 8 * g.hs, p + g.lo, p + 8 * g.hs + g.lo):
            assert banks_distinct(q)
        # the rows a fragment reads stay in their half of the column
        assert (p % g.hs + 3).max() < g.lo and (p % g.hs + g.lo + 3).max() < g.hs
    # the window rows cover the n tiles, the hp rows the vertical fragments
    assert g.hrows >= g.win and 8 * (g.vt - 1) + 16 <= g.hrows
    assert g.per_warp * s * s <= g.win_bytes
    assert g.warp_bytes * 8 == {8: 30720, 16: 33792, 32: 97280}[s]


def test_side_8_band_is_block_diagonal():
    a = a_fragments(geom(8))
    r, k = np.indices((16, 32))
    for f in range(4):
        o, kk = r % 8, k - 16 * (r // 8)
        want = np.where((kk - o >= 0) & (kk - o < 8), KERNEL8[f][np.clip(kk - o, 0, 7)], 0)
        np.testing.assert_array_equal(k2m.a_matrix(a[f]), want)


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("content", ["smooth", "adversarial", "adversarial inverted"])
def test_horizontal_products_give_the_transposed_intermediate(s, content):
    g = geom(s)
    src, plane, offsets = case(s, content)
    wins = plane_windows(plane, offsets, s).astype(np.int64)
    smem = horizontal(g, stage(g, wins, np.random.default_rng(1)))
    hp = smem[:, g.win_bytes:].reshape(-1, 4, g.cols, g.hs)
    hi = np.where(hp[..., :g.lo] >= 128, hp[..., :g.lo] - 256, hp[..., :g.lo])
    v = 256 * hi + hp[..., g.lo:2 * g.lo]                         # (warps, xf, col, row)
    assert -24 <= hi[..., :g.win].min() and hi[..., :g.win].max() <= 87
    for i, w in enumerate(wins):
        wi, p = divmod(i, g.per_warp)
        c0 = 8 * p if s == 8 else 0
        for xf in range(4):
            want = k2m.wrap16(k2m.fir(w, KERNEL8[xf], axis=1))   # (row, col)
            np.testing.assert_array_equal(v[wi, xf, c0:c0 + s, :g.win].T, want)


@pytest.mark.parametrize("b", SIDES)
@pytest.mark.parametrize("content", CONTENTS)
def test_b12_mirror_matches_jax_and_the_plain_version(b, content):
    src, wins = gathered(b, content)
    got = mirror(src, wins)
    assert_same(got, jax_out("B12", b, content), "cost")
    assert_same(got, costmap.refine_qpel_costmap_ref(src, wins), "cost (plain)")
    if content == "constant":
        assert (got == got[:, :1, :1]).all()          # every fraction ties


@pytest.mark.parametrize("b", (8, 16, 32))
@pytest.mark.parametrize("content", CONTENTS)
def test_b13_mirror_matches_jax_and_the_plain_version(b, content):
    src, plane, offsets = case(b, content)
    wins = plane_windows(plane, offsets, b)
    got = mirror(src, wins)
    jcost, jwin = jax_out("B13", b, content)
    assert_same(got, jcost, "cost")
    assert_same(wins, jwin, "windows")
    pcost, pwin = costmap.refine_qpel_costmap_dma_ref(src, plane, offsets)
    assert_same(got, pcost, "cost (plain)")
    assert_same(wins, pwin, "windows (plain)")


@pytest.mark.parametrize("b", SIDES)
@pytest.mark.parametrize("content", CONTENTS)
def test_b11_mirror_matches_jax_and_the_plain_version(b, content):
    src, wins = gathered(b, content)
    got = mirror(src, wins, winner=True)
    names = ("pred", "frac", "cost")
    for name, g_, w_ in zip(names, got, jax_out("B11", b, content)):
        assert_same(g_, w_, name)
    for name, g_, w_ in zip(names, got, inter_fused.refine_quarter_pel_fused_ref(src, wins)):
        assert_same(g_, w_, f"{name} (plain)")
    if content == "constant":
        assert not got[1].any() and (got[0] == 97).all()   # frac 0 on a tie


@pytest.mark.parametrize("b", (8, 16, 32))
def test_b13_starts_past_the_plane_clamp_like_the_plain_version(b):
    # JAX's kernel takes no such start; the port's plain version clamps it
    # so that the window fits, as the kernel's stage does.
    src, plane, offsets = case(b, "smooth")
    past = offsets + np.array([[7, 11]], dtype=np.int32)
    past[0] = (-5, plane.shape[1] + 3)
    wins = plane_windows(plane, past, b)
    pcost, pwin = costmap.refine_qpel_costmap_dma_ref(src, plane, past)
    assert_same(mirror(src, wins), pcost, "cost")
    assert_same(wins, pwin, "windows")


@pytest.mark.parametrize("b", SIDES)
def test_poisoned_padding_changes_nothing(b):
    src, wins = gathered(b, "adversarial")
    clean = mirror(src, wins, poison=False, winner=True)
    for seed in (1, 2):
        for name, g_, w_ in zip(("pred", "frac", "cost"), mirror(src, wins, seed, winner=True),
                                clean):
            assert_same(g_, w_, name)
        assert_same(mirror(src, wins, seed), mirror(src, wins, poison=False), "cost")


def test_a_tie_goes_to_the_first_fraction():
    res = np.zeros((1, 4, 32), dtype=np.int64)
    for xf in range(4):
        res[0, xf] = 100 + ((LANE >> 3) & 3) * 4 + xf                # entry yf*4 + xf
    assert tile_first_min(res)[0].tolist() == [0]
    res[0, 1, 16:24] = res[0, 2, 8:16] = 5                             # entries 9 and 6
    best, cost = tile_first_min(res)
    assert best.tolist() == [6] and cost.tolist() == [5]


@pytest.mark.parametrize("b,winner", [(8, False), (8, True), (16, False), (16, True),
                                      (32, True), (64, False), (64, True)])
def test_product_counts_match_chip_smoke(b, winner):
    # chip_smoke's design floors count the products each tiling issues: the
    # mirror's mma calls for one warp's tiles (one block at side 64).
    src, wins = gathered(b, "smooth")
    n = 2 if b == 8 else 1
    for key in k2m.PRODUCTS:
        k2m.PRODUCTS[key] = 0
    mirror(src[:n], wins[:n], winner=winner)
    assert (k2m.PRODUCTS["m16n8k32"], k2m.PRODUCTS["m16n8k16"]) == \
        chip_smoke.refine_tile_products(n, b, winner)


def test_the_cuda_core_refinement_left_b11_b12_and_b13():
    csrc = Path(build.CSRC)
    cm, rf = (csrc / "costmap.cu").read_text(), (csrc / "refine_fused.cu").read_text()
    assert "K8[" not in cm and "costmap_kernel<" not in cm
    assert '#include "refine_tile_tc.cuh"' in cm and '#include "refine_tile_tc.cuh"' in rf
    assert "refine_core.cuh" not in rf and "refine_select_at" not in rf
    users = sorted(f.name for f in csrc.glob("*.cu") if '"refine_core.cuh"' in f.read_text())
    assert users == ["mc.cu", "mega.cu"]
    assert "B19" in (csrc / "refine_core.cuh").read_text().split("\n\n")[0]


@pytest.mark.parametrize("kernel", ["B11", "B13"])
def test_phase_cost_ablations_still_match_the_tile_sources(kernel):
    # tools/refine_phase_costs.py edits the sources by text; each edit must
    # find its text once, or the tool stops on the card.
    from tools import refine_phase_costs as tool

    csrc = Path(build.CSRC)
    source, entry = tool.TILE_KERNELS[kernel]
    assert f'extern "C" int {entry}(' in (csrc / source).read_text()
    for name, edits in tool.TILE_PHASES[kernel].items():
        for fname, old, _ in edits:
            fname = source if fname == "KERNEL" else fname
            assert (csrc / fname).read_text().count(old) == 1, (name, fname, old)
        tool.edited_sources(source, edits, csrc)
