"""Kernels B5 and B6 on the tensor cores (csrc/mc_tc.cuh, which csrc/mc.cu
launches) on the CPU: an int64 mirror of the tiling, fragment by fragment.

Device memory is a flat byte array at addresses the mirror chooses (rows
any number of bytes apart, blocks starting at any byte), and shared memory
a flat byte array a CTA, poisoned with random bytes: the staging writes the
aligned 16-byte chunks that hold each window row, as the kernel's cp.async
does, and
every other byte the products read must meet a zero tap or feed a column
past the block.  The band words are built by the kernel's rules, every
mma.sync m16n8k32 operand is assembled from the lanes' registers with its
element types (s8 or u8) and every result taken back into the lanes'
accumulators, from which the byte permutes, the epilogue and the stores
proceed as the kernel's do.  The output starts poisoned, with guard bytes
past it: every pixel must be written and nothing else.

The mirror is held bit for bit against hevcasm_tpu's pred_uni_pallas and
pred_bi_pallas in interpret mode and against the port's plain versions at
every self-test shape of both filter families with every fraction, on
random and full-swing content (0/255 checkerboards and stripes, random
0/255, which drive the int16 intermediate's hi byte to its ends), and at
block sizes that are no multiple of the 16 x 16 a warp's step covers.  The
JAX results are computed once a module.

The header itself is also compiled for the CPU, with tests/warp_emu.h
running a CTA of one warp as 32 threads that meet at a barrier at each
product and __syncthreads (its inline PTX replaced by an emulated mma.sync
and plain copies for cp.async), and held against the plain version.  On
the card the kernels are held against the plain versions in
test_torch_cuda.py and chip_smoke.py."""

import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels.mc_pallas import pred_bi_pallas, pred_uni_pallas

import chip_smoke
import torch_testing
from hevcasm_tpu_torch.kernels import build, mc
from hevcasm_tpu_torch.ops.pred_inter import KERNEL4, KERNEL8

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
SPW, MAX_WARPS = 4, 8                  # csrc/mc_tc.cuh
PHASES = {8: 4, 4: 8}
PRODUCTS = {"m16n8k32": 0}
# The int16 intermediate's hi byte at the filters' ends: 255 x the positive
# and the negative taps' sums, >> 8.
HI_ENDS = {8: (-24, 87), 4: (-10, 73)}


# ---- the tiling, as mctc::geometry computes it ------------------------------------

def geometry(h, w, paths):
    strips, steps = -(-w // 16), -(-h // 16)
    runs = -(-steps // SPW)
    tasks = strips * runs
    ws = 16 * ((strips + 2) | 1)
    rows = 16 * (steps + 1)
    return SimpleNamespace(h=h, w=w, paths=paths, strips=strips, steps=steps, runs=runs,
                           tasks=tasks, ws=ws, rows=rows, win_bytes=rows * ws,
                           warps=min(tasks, MAX_WARPS), smem=paths * rows * ws)


def strip_column(m):
    m = np.asarray(m)
    return 4 * ((m >> 1) & 3) + 2 * (m >> 3) + (m & 1)


# ---- lane words ---------------------------------------------------------------------

def filter_bytes(taps, f):
    """(n,) fractions -> (n,) the filter as s8 bytes, tap 0 lowest (a
    uint64's bits in an int64)."""
    kern = KERNEL8 if taps == 8 else KERNEL4
    words = [sum((int(c) & 255) << (8 * k) for k, c in enumerate(kern[int(x)])) for x in f]
    return np.array([v - (1 << 64) if v >> 63 else v for v in words], dtype=np.int64)


def band_word(taps64, first):
    """Taps first .. first + 3 of each filter as a word, 0 outside 0..7."""
    taps64, first = np.broadcast_arrays(np.asarray(taps64, np.int64), np.asarray(first))
    out = np.zeros(taps64.shape, np.int64)
    for k in range(4):
        idx = first + k
        ok = (idx >= 0) & (idx < 8)
        out |= np.where(ok, (taps64 >> (8 * np.clip(idx, 0, 7))) & 255, 0) << (8 * k)
    return out


def bands(taps, xf, yf):
    """(h, v) (n, 32, 4): the lanes' A registers of the horizontal and the
    vertical band (mctc::bands)."""
    x, y = filter_bytes(taps, xf)[:, None], filter_bytes(taps, yf)[:, None]
    c0, c1, e = 4 * T - strip_column(G), 4 * T - strip_column(G + 8), 2 * T - G
    pair = lambda f, first: band_word(f, first) & 0xFFFF
    h = np.stack([band_word(x, c0), band_word(x, c1), band_word(x, c0 + 16),
                  band_word(x, c1 + 16)], -1)
    v = np.stack([pair(y, e) | pair(y, e + 8) << 16, pair(y, e - 8) | pair(y, e) << 16,
                  np.zeros_like(pair(y, e)), pair(y, e + 8)], -1)
    return h, v


# ---- mma.sync m16n8k32 on the lanes' registers ---------------------------------------

def lane_bytes(words, signed):
    b = (np.asarray(words, np.int64)[..., None] >> (8 * np.arange(4))) & 255
    return np.where(b >= 128, b - 256, b) if signed else b


_I4 = np.arange(4)
_A_ROW = (G[:, None, None] + 8 * (np.arange(4)[None, :, None] & 1)) + 0 * _I4
_A_COL = 4 * T[:, None, None] + _I4 + 16 * (np.arange(4)[None, :, None] >> 1)
_B_K = 4 * T[:, None, None] + _I4 + 16 * np.arange(2)[None, :, None]
_B_N = np.broadcast_to(G[:, None, None], _B_K.shape)
_D_ROW = G[:, None] + 8 * (np.arange(4) >> 1)
_D_COL = 2 * T[:, None] + (np.arange(4) & 1)


def wrap32(v):
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def mma(d, a, b, b_signed):
    """d (n, 32, 4) += A B, m16n8k32, A (n, 32, 4) s8 and B (n, 32, 2) the
    lanes' registers: A register r byte i is A[g + 8 (r & 1)][4t + i + 16
    (r >> 1)], B register s byte i is B[4t + i + 16 s][g], D register r is
    D[g + 8 (r >> 1)][2t + (r & 1)] (PTX ISA, mma.m16n8k32, 8-bit integers)."""
    n = a.shape[0]
    PRODUCTS["m16n8k32"] += n
    am = np.zeros((n, 16, 32), np.int64)
    am[:, _A_ROW, _A_COL] = lane_bytes(a, True)
    bm = np.zeros((n, 32, 8), np.int64)
    bm[:, _B_K, _B_N] = lane_bytes(b, b_signed)
    return wrap32(d + (am @ bm)[:, _D_ROW, _D_COL])


def byte_perm(x, y, s):
    v = (np.asarray(y, np.int64) << 32) | (np.asarray(x, np.int64) & 0xFFFFFFFF)
    return sum(((v >> (8 * ((s >> (4 * i)) & 7))) & 255) << (8 * i) for i in range(4))


def funnel_r(lo, hi, sh):
    return (((hi & 0xFFFFFFFF) << 32 | (lo & 0xFFFFFFFF)) >> sh) & 0xFFFFFFFF


def lds32(smem, addr):
    return (smem[addr[..., None] + _I4] << (8 * _I4)).sum(-1)


def wrap16(v):
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


# ---- device memory -------------------------------------------------------------------

class Stack:
    """A window stack in a flat device memory: block i's window at addr + i
    * stride, rows `row` bytes apart, its (rows, width) bytes from wins."""

    def __init__(self, wins, row, stride, addr, rng):
        n, rows, width = wins.shape
        assert row >= width and stride >= rows * row
        self.addr, self.row, self.stride = addr, row, stride
        self.mem = rng.integers(0, 256, addr + n * stride + 64).astype(np.int64)
        for i in range(n):
            for r in range(rows):
                a = addr + i * stride + r * row
                self.mem[a:a + width] = wins[i, r]


def stack(wins, rng, row_pad=0, gap=0, addr=4096):
    n, rows, width = wins.shape
    row = width + row_pad
    return Stack(wins, row, rows * row + gap, addr, rng)


# ---- the kernel's steps --------------------------------------------------------------

def stage(g, stacks, n, taps, rng):
    """Step 1 for every CTA (one a block): (n, smem) bytes, poisoned, with
    the block's windows' aligned 16-byte chunks at p * win_bytes + r * ws +
    16q."""
    smem = rng.integers(0, 256, (n, g.smem)).astype(np.int64)
    rows, width = g.h + taps - 1, g.w + taps - 1
    qw = (width + 15) // 16 + 1
    for i in range(n):
        for p, st in enumerate(stacks):
            dst = p * g.win_bytes
            for r in range(rows):
                a = st.addr + i * st.stride + r * st.row
                chunks = sum(1 for q in range(qw) if 16 * q < (a & 15) + width)
                smem[i, dst + r * g.ws:dst + r * g.ws + 16 * chunks] = \
                    st.mem[(a & ~15):(a & ~15) + 16 * chunks]
    return smem.reshape(-1)


class Window:
    """A staged window of each block as the warps address it (Staged)."""

    def __init__(self, g, st, n, p):
        i = np.arange(n)
        self.s = i * g.smem + p * g.win_bytes
        self.base = (st.addr + i * st.stride) & 15
        self.step = st.row & 15

    def offset(self, r):
        return (self.base[:, None] + r * self.step) & 15


def h_chunk(g, smem, w, s, c, a):
    """Step 2: chunk c of strip s -> (lo, hi) (n, 32, 2) words, and the
    products' int16 values (for the range checks)."""
    r = 16 * c + G
    p = w.s[:, None] + r * g.ws + 16 * s + 4 * T
    d = []
    for rr, p0 in ((r, p), (r + 8, p + 8 * g.ws)):
        o = w.offset(rr)
        pp, sh = p0 + (o & 12), 8 * (o & 3)
        b = np.stack([funnel_r(lds32(smem, pp), lds32(smem, pp + 4), sh),
                      funnel_r(lds32(smem, pp + 16), lds32(smem, pp + 20), sh)], -1)
        d.append(mma(np.zeros(b.shape[:2] + (4,), np.int64), a, b, False))
    lo, hi = [], []
    for half in range(2):
        x0 = byte_perm(d[0][..., 2 * half], d[0][..., 2 * half + 1], 0x5140)
        x1 = byte_perm(d[1][..., 2 * half], d[1][..., 2 * half + 1], 0x5140)
        lo.append(byte_perm(x0, x1, 0x5410))
        hi.append(byte_perm(x0, x1, 0x7632))
    return np.stack(lo, -1), np.stack(hi, -1), wrap16(np.concatenate(d, -1))


def v_acc(d, a, k0, k1, half):
    """Step 3: d + acc of the step's 16 rows and the half's 8 columns."""
    d = mma(d, a, np.stack([k0[1][..., half], k1[1][..., half]], -1), True)
    d = wrap32(d * 256)
    return mma(d, a, np.stack([k0[0][..., half], k1[0][..., half]], -1), False)


def store_rows(out, g, y0, x0, v0, v1):
    """Step 4 in place on out (n, h * w + guard)."""
    x = x0 + 4 * T
    for half in range(2):
        y = y0 + G + 8 * half
        r = 2 * half
        vals = [v0[..., r], v0[..., r + 1], v1[..., r], v1[..., r + 1]]
        for k in range(4):
            ok = (y < g.h) & (x + k < g.w)
            lanes = np.nonzero(ok)[0]
            out[:, y[lanes] * g.w + x[lanes] + k] = vals[k][:, lanes]


def mirror(wins, fracs, taps, rng, layout=(0, 0, 4096)):
    """B5 (one window stack) or B6 (two) through the mirror: wins (paths,
    n, h + taps - 1, w + taps - 1) uint8, fracs (4, n) ints (taken modulo
    the phase count as the kernel does), layout (row padding, gap between
    blocks, first address).  Returns (out (n, h, w), hp (lo, hi) ranges,
    guard bytes changed)."""
    paths, n, rows, width = wins.shape
    h, w = rows - taps + 1, width - taps + 1
    g = geometry(h, w, paths)
    stacks = [stack(wins[p], rng, *layout[:2], addr=layout[2] + 7919 * p) for p in range(paths)]
    smem = stage(g, stacks, n, taps, rng)
    fr = np.asarray(fracs) & (PHASES[taps] - 1)
    bnd = [bands(taps, fr[2 * p], fr[2 * p + 1]) for p in range(paths)]
    win = [Window(g, stacks[p], n, p) for p in range(paths)]
    guard = 64
    out = rng.integers(0, 256, (n, h * w + guard)).astype(np.int64)
    poison = out[:, h * w:].copy()
    hp = [0, 0]
    for task in range(g.tasks):
        run, s = divmod(task, g.strips)
        q0, q1 = run * SPW, min(run * SPW + SPW, g.steps)
        k0 = [h_chunk(g, smem, win[p], s, q0, bnd[p][0]) for p in range(paths)]
        for k in k0:
            hp = [min(hp[0], int(k[2].min())), max(hp[1], int(k[2].max()))]
        for q in range(q0, q1):
            k1 = [h_chunk(g, smem, win[p], s, q + 1, bnd[p][0]) for p in range(paths)]
            for k in k1:
                hp = [min(hp[0], int(k[2].min())), max(hp[1], int(k[2].max()))]
            v = []
            for half in range(2):
                d = [v_acc(np.full((n, 32, 4), 0 if paths == 2 else 8, np.int64), bnd[p][1],
                           k0[p], k1[p], half) for p in range(paths)]
                if paths == 2:
                    v.append(np.clip((wrap16(d[0] >> 6) + wrap16(d[1] >> 6) + 64) >> 7, 0, 255))
                else:
                    v.append(np.clip(d[0] >> 12, 0, 255))
            store_rows(out, g, 16 * q, 16 * s, v[0], v[1])
            k0 = k1
    changed = int((out[:, h * w:] != poison).sum())
    return out[:, :h * w].reshape(n, h, w), hp, changed


# ---- cases -----------------------------------------------------------------------------

SELFTEST = [(64, 64), (32, 16), (16, 16), (8, 4)]          # luma (w, h); chroma half each
ODD = [(5, 3), (33, 17), (7, 21), (48, 40)]                # no multiple of the 16 x 16 step


def every_fraction(taps, reps=1):
    p = PHASES[taps]
    f = np.arange(p * p * reps) % (p * p)
    return np.stack([f % p, f // p, (f * 3 + 1) % p, (f // p + f) % p])


def full_swing(rows, width, rng):
    yy, xx = np.meshgrid(np.arange(rows), np.arange(width), indexing="ij")
    planes = [((yy + xx) & 1) * 255, (xx & 1) * 255, (yy & 1) * 255,
              (((yy >> 1) + xx) & 1) * 255, rng.integers(0, 2, (rows, width)) * 255]
    return np.stack(planes + [255 - q for q in planes]).astype(np.uint8)


def adversarial(rows, width, taps, f, sign):
    """Rows whose every taps-th output reads 255 where KH[f]'s taps are
    positive (sign 1) or negative (-1) and 0 elsewhere: the horizontal pass
    at its ends."""
    kern = KERNEL8 if taps == 8 else KERNEL4
    row = (sign * kern[f][np.arange(width) % taps] > 0) * 255
    return np.broadcast_to(row, (rows, width)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def case(taps, w, h, content):
    """(wins (2, n, rows, width), fracs (4, n)) of a case, made from a seed:
    random blocks at every (xf, yf) pair; for full swing, each pair twice,
    the first window adversarial to its fraction (both signs) or one of
    full_swing's planes, the second one of those planes."""
    rng = np.random.default_rng(taps * 1000 + w * 10 + h + (content == "full swing"))
    rows, width = h + taps - 1, w + taps - 1
    if content == "full swing":
        planes = full_swing(rows, width, rng)
        fr = every_fraction(taps, reps=2)
        n = fr.shape[1]
        w0 = [adversarial(rows, width, taps, fr[0, j], 1 - 2 * (j % 2)) if j < n // 2
              else planes[j % len(planes)] for j in range(n)]
        wins = np.stack([np.stack(w0), planes[(np.arange(n) + 3) % len(planes)]])
    else:
        fr = every_fraction(taps)
        n = fr.shape[1]
        wins = rng.integers(0, 256, (2, n, rows, width), dtype=np.uint8)
    return wins, fr


@functools.lru_cache(maxsize=None)
def jax_out(taps, w, h, content):
    """hevcasm_tpu's Pallas kernels in interpret mode, once a case."""
    wins, fr = case(taps, w, h, content)
    j = [jnp.asarray(f.astype(np.int32)) for f in fr]
    uni = np.asarray(pred_uni_pallas(jnp.asarray(wins[0]), j[0], j[1], taps=taps))
    bi = np.asarray(pred_bi_pallas(jnp.asarray(wins[0]), jnp.asarray(wins[1]), *j, taps=taps))
    return uni, bi


def plain_out(taps, wins, fr):
    t = [torch.as_tensor(f.astype(np.int32)) for f in fr]
    return (mc.pred_uni_ref(wins[0], t[0], t[1], taps).numpy(),
            mc.pred_bi_ref(wins[0], wins[1], *t, taps).numpy())


def shapes(taps, which):
    return [(w * taps // 8 or 1, h * taps // 8 or 1) if which == "self-test" else (w, h)
            for w, h in (SELFTEST if which == "self-test" else ODD)]


CASES = [(taps, w, h, content)
         for taps in (8, 4) for which in ("self-test", "odd")
         for w, h in shapes(taps, which)
         for content in (("random", "full swing") if (w, h) in ((16, 16), (8, 8), (33, 17))
                         else ("random",))]


@pytest.mark.parametrize("taps,w,h,content", CASES,
                         ids=[f"{t}tap {w}x{h} {c}" for t, w, h, c in CASES])
def test_mirror_matches_jax_and_the_plain_version(taps, w, h, content):
    wins, fr = case(taps, w, h, content)
    rng = np.random.default_rng(w + h + taps)
    want_uni, want_bi = jax_out(taps, w, h, content)
    plain_uni, plain_bi = plain_out(taps, wins, fr)
    np.testing.assert_array_equal(plain_uni, want_uni)
    np.testing.assert_array_equal(plain_bi, want_bi)
    # Rows 3 bytes wider than the window and 5 bytes between blocks: rows
    # and blocks start at every byte offset of a word.
    for wi, want in ((wins[:1], want_uni), (wins, want_bi)):
        got, hp, changed = mirror(wi, fr, taps, rng, layout=(3, 5, 4097))
        np.testing.assert_array_equal(got, want)
        assert changed == 0, "a store past the block"
        lo, hi = HI_ENDS[taps]
        assert lo * 256 <= hp[0] and hp[1] < (hi + 1) * 256
        if content == "full swing":
            # The hi byte at both its ends.
            assert hp[0] >> 8 == lo and hp[1] >> 8 == hi, hp


def test_device_fractions_are_taken_modulo_the_phase_count():
    wins, fr = case(8, 16, 16, "random")
    wide = fr + np.array([[4], [-8], [12], [-4]])
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(mirror(wins, wide, 8, rng)[0], mirror(wins, fr, 8, rng)[0])


def test_geometry_is_the_wrappers():
    # The wrapper's shared-memory check (mc._smem) is the kernel's tiling;
    # a 4 x 8000 bi block needs more than a CTA may take, a 128 x 128 one fits.
    for h in (1, 2, 4, 15, 16, 17, 64, 65, 128):
        for w in (1, 2, 4, 8, 15, 16, 17, 32, 64, 100, 128, 135):
            for bi in (False, True):
                assert mc._smem(bi, h, w) == geometry(h, w, 2 if bi else 1).smem
    assert mc._smem(True, 4, 8000) > mc.MAX_SMEM >= mc._smem(True, 128, 128)
    g = geometry(64, 64, 1)
    assert (g.strips, g.steps, g.tasks, g.ws, g.rows, g.warps) == (4, 4, 4, 112, 80, 4)
    g = geometry(32, 32, 2)
    assert (g.tasks, g.warps, g.smem) == (2, 2, 2 * 48 * 80)
    # Rows WS bytes apart put the 8 rows x 4 words of a B fragment on 32 banks.
    for strips in range(1, 12):
        ws = 16 * ((strips + 2) | 1)
        assert ws >= 16 * strips + 20
        banks = {(ws // 4 * r + t) % 32 for r in range(8) for t in range(4)}
        assert len(banks) == 32


def test_bands_are_the_filters_in_the_lanes_order():
    # The A registers, read back through the fragment layout, are the
    # banded FIR matrices: rows in strip_column order for the horizontal
    # band, columns in the order of the chunk words for the vertical one.
    assert sorted(strip_column(np.arange(16))) == list(range(16))
    k = np.arange(32)
    row_of_k = 16 * (k >> 4) + 2 * ((k >> 2) & 3) + (k & 1) + 8 * ((k >> 1) & 1)
    assert sorted(row_of_k) == list(range(32))
    for taps, kern in ((8, KERNEL8), (4, KERNEL4)):
        f = np.arange(PHASES[taps])
        hb, vb = bands(taps, f, f)
        for ph in f:
            ah = np.zeros((16, 32), np.int64)
            ah[_A_ROW, _A_COL] = lane_bytes(hb[ph], True)
            av = np.zeros((16, 32), np.int64)
            av[_A_ROW, _A_COL] = lane_bytes(vb[ph], True)
            for m in range(16):
                want = np.zeros(32, np.int64)
                want[strip_column(m):strip_column(m) + taps] = kern[ph]
                np.testing.assert_array_equal(ah[m], want)
                want = np.zeros(32, np.int64)
                want[m:m + taps] = kern[ph]
                np.testing.assert_array_equal(av[m], want[row_of_k])


def test_product_counts_equal_chip_smokes_design_floor():
    for taps, w, h in ((8, 64, 64), (4, 32, 32), (8, 33, 17)):
        wins, fr = case(taps, w, h, "random")
        n = wins.shape[1]
        for paths in (1, 2):
            PRODUCTS["m16n8k32"] = 0
            mirror(wins[:paths], fr, taps, np.random.default_rng(0))
            assert PRODUCTS["m16n8k32"] == chip_smoke.mc_tc_products(n, h, w, paths == 2)


def test_phase_cost_edits_still_match_the_header():
    # tools/mc_phase_costs.py edits mc_tc.cuh by text; each edit must find
    # its text once.
    from tools import mc_phase_costs as tool

    csrc = Path(build.CSRC)
    for name, edits in tool.VARIANTS.items():
        tool.edited_header(edits, csrc)
    assert 'extern "C" int hevc_pred_uni(' in (csrc / tool.SOURCE).read_text()
    assert "refine_core.cuh" not in (csrc / "mc.cu").read_text()


# ---- the header itself, on an emulated warp -------------------------------------

EMULATED_MAIN = r"""
#include "mc_tc.cuh"

#include <cstdio>
#include <random>
#include <vector>

// stdin: n h w taps bi row per_block seed, then each window stack's n x
// (h + taps - 1) x row bytes, then the 4 x n fractions; stdout: the n x h x
// w output bytes, then the number of guard bytes past them that changed.
// A CTA of one warp: 32 threads, one a lane; shared memory poisoned.
template <int T, bool BI>
void run(const McArgs& a, const mctc::Geom& g, unsigned seed) {
  std::vector<uint8_t> smem(g.smem);
  std::mt19937 poison(seed);
  for (long long cta = 0; cta < a.n; ++cta) {
    for (auto& b : smem) b = static_cast<uint8_t>(poison());
    emu_run_block([&] { mctc::run_cta<T, BI>(a, g, cta, 32, smem.data()); });
  }
}

int main() {
  int n, h, w, taps, bi, row, per_block;
  unsigned seed;
  if (scanf("%d %d %d %d %d %d %d %u", &n, &h, &w, &taps, &bi, &row, &per_block, &seed) != 8)
    return 1;
  const int rows = h + taps - 1;
  std::vector<uint8_t> win[2];
  for (int p = 0; p < 1 + bi; ++p) {
    win[p].resize(static_cast<size_t>(n) * rows * row + 16);
    for (size_t k = 0; k + 16 < win[p].size(); ++k) {
      int x;
      if (scanf("%d", &x) != 1) return 1;
      win[p][k] = static_cast<uint8_t>(x);
    }
  }
  std::vector<int32_t> fr[4];
  for (auto& f : fr) {
    f.resize(n);
    for (auto& v : f)
      if (scanf("%d", &v) != 1) return 1;
  }
  const int guard = 64;
  std::vector<uint8_t> out(static_cast<size_t>(n) * h * w + guard, 77);
  McArgs a{};
  for (int p = 0; p < 2; ++p) {
    a.win[p] = reinterpret_cast<long long>(win[bi ? p : 0].data());
    a.win_stride[p] = static_cast<long long>(rows) * row;
    a.win_row[p] = row;
  }
  for (int j = 0; j < 4; ++j) {
    a.frac[j] = per_block ? reinterpret_cast<long long>(fr[j].data()) : 0;
    a.frac_stride[j] = 1;
    a.val[j] = fr[j][0];
  }
  a.out = reinterpret_cast<long long>(out.data());
  a.n = n;
  a.h = h;
  a.w = w;
  a.taps = taps;
  const mctc::Geom g = mctc::geometry(h, w, bi ? 2 : 1);
  if (taps == 8 && bi) run<8, true>(a, g, seed);
  else if (taps == 8) run<8, false>(a, g, seed);
  else if (bi) run<4, true>(a, g, seed);
  else run<4, false>(a, g, seed);
  int changed = 0;
  for (int k = 0; k < guard; ++k) changed += out[out.size() - guard + k] != 77;
  for (size_t k = 0; k + guard < out.size(); ++k) printf("%d ", out[k]);
  printf("%d\n", changed);
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated_mc(tmp_path_factory):
    """mc_tc.cuh itself built for the CPU: tests/warp_emu.h runs a CTA of
    one warp as 32 threads; the header's inline PTX (the products and
    cp.async) becomes the emulated product and plain copies.  Skips without
    a C++20 compiler."""
    tmp = tmp_path_factory.mktemp("mc_emu")
    torch_testing.emulated_mc_tc(tmp)
    return torch_testing.build_emulator(tmp, EMULATED_MAIN, "mc")


EMULATED = [(8, 64, 64), (8, 16, 32), (8, 8, 4), (8, 33, 17), (8, 5, 3),
            (4, 32, 32), (4, 8, 16), (4, 4, 2), (4, 7, 21), (4, 1, 1)]


@pytest.mark.parametrize("taps,w,h", EMULATED, ids=[f"{t}tap {w}x{h}" for t, w, h in EMULATED])
def test_the_header_itself_on_an_emulated_warp(emulated_mc, taps, w, h):
    # The kernel's own source, lane by lane, against the plain version: rows
    # 3 bytes wider than the window (every byte offset), per-block and
    # shared fractions, random and full-swing content, uni and bi.
    rng = np.random.default_rng(taps + 3 * w + h)
    rows, width, row = h + taps - 1, w + taps - 1, w + taps + 2
    n = 3
    for content, per_block in (("random", 1), ("full swing", 0)):
        if content == "random":
            wins = rng.integers(0, 256, (2, n, rows, row), dtype=np.uint8)
        else:
            planes = full_swing(rows, row, rng)
            wins = np.stack([planes[:n], planes[n:2 * n]])
        fr = rng.integers(0, PHASES[taps], (4, n)).astype(np.int32)
        if not per_block:
            fr[:] = fr[:, :1]
        want = plain_out(taps, wins[..., :width], fr)
        for bi in (0, 1):
            stdin = " ".join(map(str, (n, h, w, taps, bi, row, per_block, 7,
                                       *wins[:1 + bi].ravel(), *fr.ravel())))
            out = torch_testing.run_emulator(
                emulated_mc, stdin, f"{taps}tap {w}x{h} {content} bi {bi}").split()
            vals = np.array(out, dtype=np.int64)
            assert vals[-1] == 0, "a store past the block"
            np.testing.assert_array_equal(vals[:-1].reshape(n, h, w), want[bi],
                                          err_msg=f"{content} {'bi' if bi else 'uni'}")
