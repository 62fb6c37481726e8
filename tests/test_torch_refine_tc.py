"""The tensor-core refinement of kernels K2 and B3 (csrc/refine_tc_core.cuh,
csrc/inter_fused.cu, csrc/bi_fused.cu) on the CPU: an int64 mirror of the
kernels' tiling, fragment by fragment.  Shared memory is a flat byte array
per CTU, addressed as the kernels address it (window rows WS bytes apart,
hp[xf][col][row] hi and lo planes HP_PLANE bytes apart); every operand of
an mma.sync m16n8k32 is read as the lanes read it and put back in place
from their registers, and every result is taken back into the lanes'
accumulator registers, from which the stores, the score, the warp's
sums and the first minimum proceed as the kernels do.

The staged padding (window rows and columns 71..79) and hp rows 71..79 are
poisoned with random bytes: they meet only zero taps.  The mirror is held
bit for bit against hevcasm_tpu's inter_ctu_fused_dma and bi_ctu_fused_dma
in interpret mode, and against the port's plain versions.  The mirror is
test code: the package's plain versions stay ``inter_ctu_fused_dma_ref`` and
``bi_ctu_fused_dma_ref``.  The kernels themselves are held against those in
test_torch_cuda.py."""

import functools
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels.interp_pallas import bi_ctu_fused_dma as jax_bi
from hevcasm_tpu.kernels.interp_pallas import inter_ctu_fused_dma as jax_k2

import torch_testing  # noqa: F401
import chip_smoke
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import bi_fused, inter_fused
from hevcasm_tpu_torch.ops.pred_inter import KERNEL8

B = 64
WIN = 71
ROWS, WS = 72, 80
HP_PLANE = 4 * B * WS
HP_BYTES = 2 * HP_PLANE
MT, H_NT, NWARPS, TILES = 4, 9, 8, 4
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3

# ---- fragments ----------------------------------------------------------------
# Lane (g, t) of mma.sync m16n8k32 (8-bit): A register j byte b is A[g + 8
# (j & 1)][4t + 16 (j >> 1) + b]; B register j byte b is B[4t + 16 j +
# b][g].  Of m16n8k16: A register j byte b is A[g + 8 j][4t + b]; B's one
# register byte b is B[4t + b][g].  D register j is D[g + 8 (j >> 1)][2t +
# (j & 1)] in both.
A_ROW = G[:, None, None] + 8 * (np.arange(4)[None, :, None] & 1) + 0 * np.arange(4)
A_COL = 4 * T[:, None, None] + 16 * (np.arange(4)[None, :, None] >> 1) + np.arange(4)
B_K = 4 * T[:, None, None] + 16 * np.arange(2)[None, :, None] + np.arange(4)
B_N = np.broadcast_to(G[:, None, None], (32, 2, 4))
A16_ROW = G[:, None, None] + 8 * np.arange(2)[None, :, None] + 0 * np.arange(4)
A16_COL = np.broadcast_to(4 * T[:, None, None] + np.arange(4), (32, 2, 4))
B16_K = 4 * T[:, None] + np.arange(4)
B16_N = np.broadcast_to(G[:, None], (32, 4))
D_ROW = G[:, None] + 8 * (np.arange(4)[None, :] >> 1)
D_COL = 2 * T[:, None] + (np.arange(4)[None, :] & 1)


def k8_bytes(f):
    return sum((int(c) & 255) << (8 * i) for i, c in enumerate(KERNEL8[f]))


def band_word(taps, first):
    if first >= 8 or first <= -4:
        return 0
    return (taps >> (8 * first) if first >= 0 else taps << (-8 * first)) & 0xFFFFFFFF


def band_fragments():
    """(4, 32, 4) words: lane (g, t)'s registers of the horizontal pass's A
    fragment of each fraction, as csrc/refine_tc_core.cuh horizontal_pass
    builds them."""
    a = np.zeros((4, 32, 4), dtype=np.int64)
    for f in range(4):
        taps = k8_bytes(f)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            a[f, lane] = (band_word(taps, 4 * t - g), band_word(taps, 4 * t - g - 8), 0,
                          band_word(taps, 8 + 4 * t - g))
    return a


def band_words():
    """(4, 32) words: lane (g, t)'s register of the vertical pass's B
    fragment of each fraction (band_words): register 0 of the A fragment."""
    return band_fragments()[:, :, 0]


def word_bytes(words, signed):
    """(..., 4) words -> (..., 4, 4) bytes, little-endian."""
    b = (words[..., None] >> (8 * np.arange(4))) & 255
    return np.where(b >= 128, b - 256, b) if signed else b


def a_matrix(a_regs):
    """(32, 4) words of s8 -> the 16 x 32 A tile they hold."""
    m = np.zeros((16, 32), dtype=np.int64)
    m[A_ROW, A_COL] = word_bytes(a_regs, True)
    return m


PRODUCTS = {"m16n8k32": 0, "m16n8k16": 0}      # mma calls, counted


def mma(d, a_regs, b_regs, b_signed):
    """d (..., 32, 4) += A (from the lanes' a_regs (32, 4)) x B (from the
    lanes' b_regs (..., 32, 2)), in the lanes' D layout."""
    PRODUCTS["m16n8k32"] += 1
    bm = np.zeros(b_regs.shape[:-2] + (32, 8), dtype=np.int64)
    bm[..., B_K, B_N] = word_bytes(b_regs, b_signed)
    prod = a_matrix(a_regs) @ bm                                  # (..., 16, 8)
    return d + prod[..., D_ROW, D_COL]


def b16_matrix(w):
    """(32,) words of s8 -> the 16 x 8 B tile of m16n8k16 they hold."""
    m = np.zeros((16, 8), dtype=np.int64)
    m[B16_K, B16_N] = word_bytes(w, True)
    return m


def mma16(d, a_regs, a_signed, w):
    """d (..., 32, 4) += A (from the lanes' a_regs (..., 32, 2)) x B (from
    the lanes' band words w (32,)), m16n8k16, in the lanes' D layout."""
    PRODUCTS["m16n8k16"] += 1
    am = np.zeros(a_regs.shape[:-2] + (16, 16), dtype=np.int64)
    am[..., A16_ROW, A16_COL] = word_bytes(a_regs, a_signed)
    prod = am @ b16_matrix(w)                                     # (..., 16, 8)
    return d + prod[..., D_ROW, D_COL]


def lds32(buf, addr):
    """buf (n, bytes) u8; addr (...) -> (n, ...) words."""
    b = buf[:, addr[..., None] + np.arange(4)]
    return (b << (8 * np.arange(4))).sum(-1)


def wrap16(v):
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


# ---- the kernels' steps -------------------------------------------------------

def stage_window(plane, offsets):
    """(n, ROWS * WS) bytes: the 80 x 80 window as stage_window reads it."""
    ph, pw = plane.shape
    out = np.zeros((len(offsets), ROWS, WS), dtype=np.int64)
    for i, (oy, ox) in enumerate(offsets):
        y0, x0 = np.clip(oy, 0, ph - WIN), np.clip(ox, 0, pw - WIN)
        rows = np.minimum(y0 + np.arange(ROWS), ph - 1)
        cols = np.minimum(x0 + np.arange(WS), pw - 1)
        out[i] = plane[rows][:, cols]
    return out.reshape(len(offsets), -1)


def poison_window(win, rng):
    w = win.reshape(-1, ROWS, WS).copy()
    w[:, WIN:, :] = rng.integers(0, 256, w[:, WIN:, :].shape)
    w[:, :, WIN:] = rng.integers(0, 256, w[:, :, WIN:].shape)
    return w.reshape(win.shape)


def horizontal_pass(win, a):
    """(n, HP_BYTES) bytes of hp from the staged windows, pair by pair."""
    n = win.shape[0]
    hp = np.zeros((n, HP_BYTES), dtype=np.int64)
    for p in range(MT * H_NT):
        mt, nt = p % MT, p // MT
        wr = (8 * nt + G) * WS + 16 * mt + 4 * T                   # (32,)
        b = np.stack([lds32(win, wr), lds32(win, wr + 16)], -1)     # (n, 32, 2)
        for xf in range(4):
            d = mma(np.zeros((n, 32, 4), dtype=np.int64), a[xf], b, False)
            for h in range(2):
                off = (xf * B + 16 * mt + G + 8 * h) * WS + 8 * nt + 2 * T
                v0, v1 = d[:, :, 2 * h], d[:, :, 2 * h + 1]
                hp[:, off], hp[:, off + 1] = (v0 >> 8) & 255, (v1 >> 8) & 255
                hp[:, HP_PLANE + off], hp[:, HP_PLANE + off + 1] = v0 & 255, v1 & 255
    return hp


def poison_hp(hp, rng):
    h = hp.reshape(-1, 2, 4, B, WS).copy()
    h[..., WIN:] = rng.integers(0, 256, h[..., WIN:].shape)
    return h.reshape(hp.shape)


def tile_origin(warp, j):
    return 32 * (warp >> 2) + 8 * j, 16 * (warp & 3)


def hp_fragment(hp, warp, xf, j):
    y0, x0 = tile_origin(warp, j)
    p = (xf * B + x0 + G) * WS + y0 + 4 * T
    hi = np.stack([lds32(hp, p), lds32(hp, p + 8 * WS)], -1)
    lo = np.stack([lds32(hp, p + HP_PLANE), lds32(hp, p + HP_PLANE + 8 * WS)], -1)
    return hi, lo


def vertical_acc(d, w, hi, lo):
    d = mma16(d, hi, True, w) * 256
    return mma16(d, lo, False, w)


def lane_xy(warp, j):
    """(32, 4) output rows and columns of the lanes' accumulator registers
    in the warp's tile j (tile_y, tile_x)."""
    y0, x0 = tile_origin(warp, j)
    return y0 + D_COL, x0 + D_ROW


def vertical_scores(hp, src, w):
    """(n, 8 warps, 32 lanes, 16) each lane's share of QPEL_SCORE."""
    n = hp.shape[0]
    flat = src.reshape(n, -1).astype(np.int64)
    cost = np.zeros((n, NWARPS, 32, 16), dtype=np.int64)
    for warp in range(NWARPS):
        for j in range(TILES):
            y, x = lane_xy(warp, j)
            c = -(flat[:, y * B + x] << 4)                          # (n, 32, 4)
            for xf in range(4):
                hi, lo = hp_fragment(hp, warp, xf, j)
                for yf in range(4):
                    d = vertical_acc(c, w[yf], hi, lo)
                    cost[:, warp, :, yf * 4 + xf] += (np.abs(d) >> 4).sum(-1)
    return cost


def warp_sums4(v):
    """(..., 32, 4) one xf's 4 sums a lane -> (..., 32): the value lane l
    holds after warp_sums4's reduce-scatter at offsets 16 and 8 and its
    butterfly at 4, 2 and 1 (the warp sum of yf = (l >> 3) & 3)."""
    up16, up8 = ((LANE & 16) != 0)[:, None], (LANE & 8) != 0
    send = np.where(up16, v[..., [0, 1]], v[..., [2, 3]])
    p = np.where(up16, v[..., [2, 3]], v[..., [0, 1]]) + send[..., LANE ^ 16, :]
    r = np.where(up8, p[..., 1], p[..., 0]) + np.where(up8, p[..., 0], p[..., 1])[..., LANE ^ 8]
    for off in (4, 2, 1):
        r = r + r[..., LANE ^ off]
    return r


def warp_table(cost):
    """(n, 8, 32, 16) -> s_red (n, 8, 16): per xf, lanes 0, 8, 16 and 24
    write their yf's warp sum to entry yf * 4 + xf."""
    s_red = np.zeros(cost.shape[:2] + (16,), dtype=np.int64)
    for xf in range(4):
        r = warp_sums4(cost[..., xf::4])                            # v[yf] = cost[yf*4+xf]
        for lane in range(0, 32, 8):
            s_red[:, :, (lane >> 3) * 4 + xf] = r[:, :, lane]
    return s_red


def select_first_min(cost):
    """(n, 8, 32, 16) -> (best, best_cost, totals (n, 16))."""
    totals = warp_table(cost).sum(1)
    lanes = np.full((cost.shape[0], 32), 0x7FFFFFFF, dtype=np.int64)
    lanes[:, :16] = totals
    m = lanes.min(1)
    return np.argmax(lanes == m[:, None], axis=1), m, totals


def winner_acc(hp, w, best, c0):
    """(n, 64, 64) the winner's accumulator + c0 * 256, tile by tile."""
    n = hp.shape[0]
    out = np.zeros((n, B, B), dtype=np.int64)
    for i in range(n):
        yf, xf = best[i] >> 2, best[i] & 3
        for warp in range(NWARPS):
            for j in range(TILES):
                hi, lo = hp_fragment(hp[i:i + 1], warp, xf, j)
                d = vertical_acc(np.full((1, 32, 4), c0, dtype=np.int64), w[yf], hi, lo)
                y, x = lane_xy(warp, j)
                out[i, y, x] = d[0]
    return out


def refine(src, plane, offsets, rng, poison=True):
    """Steps 1-4 of one reference: (hp, best, best_cost, per-lane costs)."""
    win = stage_window(plane, offsets)
    if poison:
        win = poison_window(win, rng)
    hp = horizontal_pass(win, band_fragments())
    if poison:
        hp = poison_hp(hp, rng)
    cost = vertical_scores(hp, src, band_words())
    best, best_cost, _ = select_first_min(cost)
    return hp, best, best_cost, cost


def k2_mirror(src, plane, offsets, qargs, seed=0, poison=True):
    rng = np.random.default_rng(seed)
    hp, best, best_cost, _ = refine(src, plane, offsets, rng, poison)
    pred = np.clip(winner_acc(hp, band_words(), best, 8) >> 12, 0, 255)
    rec, nnz, bits = inter_fused.residual_8x8(torch.as_tensor(src),
                                              torch.as_tensor(pred.astype(np.uint8)), *qargs)
    return rec.numpy(), best.astype(np.int32), best_cost.astype(np.int32), nnz.numpy(), \
        bits.numpy()


def pack16(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def unpack16(w):
    return wrap16(w), wrap16(w >> 16)


def b3_mirror(src, plane, off0, off1, qargs, seed=0, poison=True):
    rng = np.random.default_rng(seed)
    w = band_words()
    hp0, best0, _, _ = refine(src, plane, off0, rng, poison)
    p0 = wrap16(winner_acc(hp0, w, best0, 0) >> 6)
    # the registers hold p0 as int16 pairs (rows y, y + 1)
    packed = pack16(p0[:, 0::2], p0[:, 1::2])
    lo, hi = unpack16(packed)
    p0 = np.stack([lo, hi], 2).reshape(p0.shape)
    hp1, best1, _, _ = refine(src, plane, off1, rng, poison)
    p1 = wrap16(winner_acc(hp1, w, best1, 0) >> 6)
    pred = np.clip((p0 + p1 + 64) >> 7, 0, 255)
    rec, nnz, bits = inter_fused.residual_8x8(torch.as_tensor(src),
                                              torch.as_tensor(pred.astype(np.uint8)), *qargs)
    return rec.numpy(), best0.astype(np.int32), best1.astype(np.int32), nnz.numpy(), \
        bits.numpy()


# ---- inputs -------------------------------------------------------------------

QARGS = (*EncodeConfig(qp=32).quant_params(False), *EncodeConfig(qp=32).dequant_params())
PLANE_SHAPE = (150, 214)         # the loop's padded 64 x 128 frame at R = 8 plus slack


def offsets_0_to_max(n, shape, rng):
    off = np.stack([rng.integers(0, shape[0] - WIN + 1, n),
                    rng.integers(0, shape[1] - WIN + 1, n)], -1)
    off[0] = (0, 0)
    off[-1] = (shape[0] - WIN, shape[1] - WIN)
    return off.astype(np.int32)


def case(name):
    """(src (n, 64, 64), plane, offsets0, offsets1) for a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 3
    src = rng.integers(0, 256, (n, B, B), dtype=np.uint8)
    if name == "random":
        plane = rng.integers(0, 256, PLANE_SHAPE, dtype=np.uint8)
    elif name == "shifted":
        base = rng.integers(0, 256, (PLANE_SHAPE[0] + 8, PLANE_SHAPE[1] + 8), dtype=np.uint8)
        plane = base[:PLANE_SHAPE[0], :PLANE_SHAPE[1]]
        src = np.stack([base[5 + 40 * i:69 + 40 * i, 7 + 50 * i:71 + 50 * i] for i in range(n)])
    elif name == "constant":
        plane = np.full(PLANE_SHAPE, 97, dtype=np.uint8)
    elif name in ("adversarial", "adversarial inverted"):
        # the horizontal pass at 22440 and -6120 (hi bytes 87 and -24), the
        # vertical pass at both extremes too
        plane = chip_smoke.adversarial_plane(PLANE_SHAPE, "cpu",
                                             name.endswith("inverted")).numpy()
        src = np.where(rng.random((n, B, B)) < 0.5, 0, 255).astype(np.uint8)
    else:
        raise ValueError(name)
    off0 = offsets_0_to_max(n, PLANE_SHAPE, rng)
    off1 = offsets_0_to_max(n, PLANE_SHAPE, rng)[::-1].copy()
    return src, np.ascontiguousarray(plane), off0, off1


CASES = ["random", "shifted", "constant", "adversarial", "adversarial inverted"]


@functools.lru_cache(maxsize=None)
def jax_k2_out(name):
    src, plane, off0, _ = case(name)
    out = jax_k2(jnp.asarray(src), jnp.asarray(plane), jnp.asarray(off0), *QARGS, group=6)
    return tuple(np.asarray(o) for o in out)


@functools.lru_cache(maxsize=None)
def jax_b3_out(name):
    src, plane, off0, off1 = case(name)
    out = jax_bi(jnp.asarray(src), jnp.asarray(plane), jnp.asarray(off0), jnp.asarray(off1),
                 *QARGS, group=6)
    return tuple(np.asarray(o) for o in out)


def assert_outputs_equal(got, want, names):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)


def fir(x, taps, axis):
    """8-tap FIR along axis (output length len - 7), int64."""
    n = x.shape[axis] - 7
    return sum(int(c) * np.take(x, np.arange(n) + j, axis=axis) for j, c in enumerate(taps))


# ---- the tests ------------------------------------------------------------------

def test_band_fragments_rebuild_the_band():
    a, w = band_fragments(), band_words()
    r, k = np.indices((16, 32))
    for f in range(4):
        want = np.where((k - r >= 0) & (k - r < 8), KERNEL8[f][np.clip(k - r, 0, 7)], 0)
        np.testing.assert_array_equal(a_matrix(a[f]), want)
        assert not a[f, :, 2].any()                 # row g, columns 16..31: k - r >= 9
        # the vertical pass's B: band[o][k] for 8 outputs o from 16 inputs k
        np.testing.assert_array_equal(b16_matrix(w[f]), want[:8, :16].T)
    assert [k8_bytes(f) for f in range(4)] == [
        0x0000000040000000, 0x0001FB113AF604FF, 0xFF04F52828F504FF, 0xFF04F63A11FB0100]


def test_fragment_layouts_cover_each_tile_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 32)), (B_K, B_N, (32, 8)),
                              (A16_ROW, A16_COL, (16, 16)), (B16_K, B16_N, (16, 8)),
                              (D_ROW, D_COL, (16, 8))):
        seen = np.zeros(shape, dtype=int)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


@pytest.mark.parametrize("name", ["random", "adversarial", "adversarial inverted"])
def test_horizontal_products_give_the_transposed_intermediate(name):
    src, plane, off0, _ = case(name)
    win = stage_window(plane, off0)
    hp = horizontal_pass(win, band_fragments()).reshape(-1, 2, 4, B, WS)
    hi = np.where(hp[:, 0] >= 128, hp[:, 0] - 256, hp[:, 0])
    v = 256 * hi + hp[:, 1]                                   # (n, xf, col, row)
    w = win.reshape(-1, ROWS, WS)
    for xf in range(4):
        want = wrap16(fir(w[:, :, :B + 7], KERNEL8[xf], axis=2))   # (n, row, col)
        np.testing.assert_array_equal(v[:, xf, :, :ROWS].transpose(0, 2, 1), want)


def test_hi_lo_split_reaches_both_extremes():
    # 22440 = 87 * 256 + 168 and -6120 = -24 * 256 + 24 at xf = 2.
    extremes = set()
    for name in ("adversarial", "adversarial inverted"):
        src, plane, off0, _ = case(name)
        hp = horizontal_pass(stage_window(plane, off0), band_fragments()).reshape(
            -1, 2, 4, B, WS)[..., :WIN]
        hi = np.where(hp[:, 0] >= 128, hp[:, 0] - 256, hp[:, 0])
        assert -24 <= hi.min() and hi.max() <= 87
        v = 256 * hi + hp[:, 1]
        extremes |= {int(v[:, 2].max()), int(v[:, 2].min())}
        assert {int(hi[:, 2].max()), int(hi[:, 2].min())} == {87, -24}
    assert {22440, -6120} <= extremes


@pytest.mark.parametrize("name", ["random", "adversarial"])
def test_vertical_products_are_the_candidates(name):
    src, plane, off0, _ = case(name)
    rng = np.random.default_rng(1)
    hp = poison_hp(horizontal_pass(poison_window(stage_window(plane, off0), rng),
                                   band_fragments()), rng)
    h = hp.reshape(-1, 2, 4, B, WS)
    v = 256 * np.where(h[:, 0] >= 128, h[:, 0] - 256, h[:, 0]) + h[:, 1]   # (n, xf, col, row)
    for frac in (0, 5, 10, 15):
        yf, xf = frac >> 2, frac & 3
        want = fir(v[:, xf, :, :B + 7], KERNEL8[yf], axis=2).transpose(0, 2, 1)  # (n, y, x)
        np.testing.assert_array_equal(winner_acc(hp, band_words(), np.full(3, frac), 0), want)
        assert np.abs(want).max() < 2.2e6


def test_score_and_warp_sums_from_the_lane_layout():
    src, plane, off0, _ = case("random")
    w = band_words()
    hp = horizontal_pass(stage_window(plane, off0), band_fragments())
    cost = vertical_scores(hp, src, w)                       # (n, 8, 32, 16)
    for xf in range(4):
        r = warp_sums4(cost[..., xf::4])
        np.testing.assert_array_equal(r, cost.sum(2)[:, :, xf::4][:, :, (LANE >> 3) & 3])
    np.testing.assert_array_equal(warp_table(cost), cost.sum(2))
    best, best_cost, totals = select_first_min(cost)
    s12 = src.astype(np.int64) << 12
    for frac in range(16):
        acc = winner_acc(hp, w, np.full(3, frac), 0)
        np.testing.assert_array_equal(totals[:, frac], (np.abs(acc - s12) >> 4).sum((1, 2)))
    np.testing.assert_array_equal(best, totals.argmin(1))
    np.testing.assert_array_equal(best_cost, totals.min(1))
    # a tie goes to the first candidate in yf*4 + xf order
    tied = cost.copy()
    tied[..., 9] = tied[..., 12] = 0
    assert (select_first_min(tied)[0] == 9).all()


@pytest.mark.parametrize("name", CASES)
def test_k2_mirror_matches_jax_and_the_plain_version(name):
    src, plane, off0, _ = case(name)
    got = k2_mirror(src, plane, off0, QARGS)
    names = ("rec", "frac", "cost", "nnz", "bits")
    assert_outputs_equal(got, jax_k2_out(name), names)
    assert_outputs_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, off0, *QARGS),
                         names)
    if name == "constant":
        assert not got[1].any()                           # every fraction ties


@pytest.mark.parametrize("name", CASES)
def test_b3_mirror_matches_jax_and_the_plain_version(name):
    src, plane, off0, off1 = case(name)
    got = b3_mirror(src, plane, off0, off1, QARGS)
    names = ("rec", "frac0", "frac1", "nnz", "bits")
    assert_outputs_equal(got, jax_b3_out(name), names)
    assert_outputs_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, plane, off0, off1, *QARGS),
                         names)
    if name == "constant":
        assert not got[1].any() and not got[2].any()


def test_poisoned_padding_changes_nothing():
    src, plane, off0, off1 = case("adversarial")
    clean = k2_mirror(src, plane, off0, QARGS, poison=False)
    for seed in (1, 2):
        assert_outputs_equal(k2_mirror(src, plane, off0, QARGS, seed=seed), clean, range(5))
    clean = b3_mirror(src, plane, off0, off1, QARGS, poison=False)
    assert_outputs_equal(b3_mirror(src, plane, off0, off1, QARGS, seed=3), clean, range(5))


def test_starts_past_the_plane_clamp_like_the_plain_version():
    # The JAX kernels take no such start; the port's plain versions clamp it
    # so that the window fits, as stage_window does.
    src, plane, off0, off1 = case("random")
    lim = np.array(plane.shape) - WIN
    assert (off0[0] == 0).all() and (off0[-1] == lim).all() and (off1[0] == lim).all()
    off0, off1 = off0 + 9, off1 + np.array([5, 13], dtype=np.int32)
    assert_outputs_equal(k2_mirror(src, plane, off0, QARGS),
                         inter_fused.inter_ctu_fused_dma_ref(src, plane, off0, *QARGS), range(5))
    assert_outputs_equal(b3_mirror(src, plane, off0, off1, QARGS),
                         bi_fused.bi_ctu_fused_dma_ref(src, plane, off0, off1, *QARGS),
                         range(5))


@pytest.mark.parametrize("refs", [1, 2])
def test_product_counts_match_chip_smoke(refs):
    # chip_smoke's design floors count the products the tiling issues: the
    # mirror's mma calls for one CTU.
    src, plane, off0, off1 = case("random")
    src, off0, off1 = src[:1], off0[:1], off1[:1]
    for key in PRODUCTS:
        PRODUCTS[key] = 0
    if refs == 1:
        k2_mirror(src, plane, off0, QARGS)
    else:
        b3_mirror(src, plane, off0, off1, QARGS)
    assert (PRODUCTS["m16n8k32"], PRODUCTS["m16n8k16"]) == chip_smoke.refine_tc_products(1, refs)


@pytest.mark.parametrize("kernel", ["K2", "B3"])
def test_phase_cost_ablations_still_match_the_kernel_sources(kernel):
    # tools/refine_phase_costs.py edits the sources by text; each edit of
    # this checkout's design must find its text once, or the tool stops on
    # the card.
    from tools import refine_phase_costs as tool

    csrc = Path(inter_fused.build.CSRC)
    design = tool.design_of(csrc)
    assert design.startswith("tensor cores")
    source, entry = tool.KERNELS[kernel]
    assert f'extern "C" int {entry}(' in (csrc / source).read_text()
    for name, edits in tool.DESIGNS[design][1].items():
        for fname, old, _ in edits:
            fname = source if fname == "KERNEL" else fname
            assert (csrc / fname).read_text().count(old) == 1, (name, fname, old)
        tool.edited_sources(source, edits, csrc)
