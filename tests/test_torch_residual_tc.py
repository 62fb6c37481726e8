"""The tensor-core residual stage (csrc/residual_core.cuh residual_tile,
which B4 csrc/residual_ctu.cu runs at every TU size and K2, B3 and B19 at
8x8) on the CPU: an int64 mirror of its tiling, fragment by fragment.

Each warp's W x W tile is coded as the kernel codes it: the constant
fragments are the words of the kernel's compile-time table (built here by
the same rules, its unused words poisoned with random bytes), the source and
prediction words are read from the CTU's flat bytes at the lanes' offsets,
every operand of an mma.sync (m16n8k16 at W = 16, m16n8k32 at W = 32) is
assembled from the lanes' registers with its element types (s8 or u8) and
every result is taken back into the lanes' accumulator registers, from
which the byte splits, the quantizer, the counts' shuffles and the 16-bit
stores proceed as the kernel does.  The output planes and the nnz and bits
arrays start poisoned: every pixel and every TU must be written.

The mirror is held bit for bit against hevcasm_tpu's residual_pipeline_ctu
in interpret mode and against the port's plain residual_pipeline_ctu_ref
(its bits against the plain levels' Exp-Golomb sums), at 4x4 DST-VII, 4x4,
8x8, 16x16 and 32x32 TUs, on random content, on full-swing content (src
255 over pred 0 and the reverse, checkerboards, random 0/255) and at the
quantizer parameters' range edges.  With 8-bit input no forward pass can
leave int16 (the HEVC shifts keep every sum within +-32640), so the int16
wrap never changes a value; full-swing content drives the intermediates to
+-32640, the ends of the s8/u8 split, and the range-edge parameters drive
the levels, the dequantizer's clip and the inverse passes' clips.  The
mirror is test code.

The header itself (csrc/residual_core.cuh) is also compiled for the CPU,
with tests/warp_emu.h running a warp as 32 threads that meet at a barrier
at each shuffle and product (its inline PTX replaced by an emulated
mma.sync), and held against the plain version on the same cases.  On the
card the kernels are held against the plain version in test_torch_cuda.py
and chip_smoke.py."""

import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.kernels.residual_pallas import block_diag_t
from hevcasm_tpu.kernels.residual_pallas import residual_pipeline_ctu as jax_residual_ctu

import chip_smoke
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import build, residual_ctu
from hevcasm_tpu_torch.ops.residual import residual_levels

B = 64
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
VARIANTS = {(4, 1): 0, (4, 0): 1, (8, 0): 2, (16, 0): 3, (32, 0): 4}   # (tu, tr_type) -> table
# The words of a variant the kernel reads (residual_core.cuh's table layout).
USED_WORDS = {16: [0, 1, 8, 10, 16, 17, 24, 26], 32: list(range(32))}

# ---- the fragment table, as residual_core.cuh frag_table builds it -----------


def perm(p):
    p = np.asarray(p)
    return (p & 16) + 2 * ((p & 15) >> 2) + (p & 1) + 8 * ((p >> 1) & 1)


def t32():
    first_col = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
                 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4]
    t = np.zeros((32, 32), np.int64)
    for k in range(32):
        for j in range(32):
            phase, sign = (k * (2 * j + 1)) % 128, 1
            if phase >= 64:
                sign, phase = -1, phase - 64
            val = -first_col[64 - phase] if phase > 32 else 0 if phase == 32 else first_col[phase]
            t[k, j] = sign * val
    return t


def pack_bytes(vals):
    """(..., 4) ints -> (...) words, byte i from vals[..., i]."""
    v = np.asarray(vals, np.int64) & 255
    return (v << (8 * np.arange(4))).sum(-1)


@functools.lru_cache(maxsize=None)
def frag_table(poison_seed=None):
    """(5, 32, 32) int64: variant, word, lane.  With a seed, the words the
    kernel never reads are random instead of 0."""
    dst4 = np.array([[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55],
                     [55, -84, 74, -29]])
    full = t32()
    words = np.zeros((5, 32, 32), np.int64)
    if poison_seed is not None:
        words[:] = np.random.default_rng(poison_seed).integers(0, 1 << 32, words.shape)
    i4 = np.arange(4)
    for v in range(5):
        tu = 4 if v == 0 else 2 << v
        w = 32 if tu == 32 else 16
        band = np.zeros((32, 32), np.int64)
        for a in range(w):
            for b in range(w):
                if a // tu == b // tu:
                    band[a, b] = dst4[a % 4, b % 4] if v == 0 else full[(a % tu) * (32 // tu), b % tu]
        for mt in range(w // 16):
            for r in range(w // 8):
                row = (16 * mt + G + 8 * (r & 1))[:, None]
                k = 4 * T[:, None] + i4 + 16 * (r >> 1)
                words[v, 4 * mt + r] = pack_bytes(band[row, k])
                words[v, 16 + 4 * mt + r] = pack_bytes(band[perm(k), row])
        for j in range(w // 8):
            for s in range(w // 16):
                k = perm(4 * T[:, None] + i4 + 16 * s)
                col = (8 * j + G)[:, None]
                words[v, 8 + 2 * j + s] = pack_bytes(band[col, k])
                words[v, 24 + 2 * j + s] = pack_bytes(band[k, col])
    return words


# ---- mma.sync on the lanes' registers ----------------------------------------

PRODUCTS = {"m16n8k16": 0, "m16n8k32": 0}


def lane_bytes(words, signed):
    """(n, 32, regs) words -> (n, 32, regs, 4) elements."""
    b = (np.asarray(words, np.int64)[..., None] >> (8 * np.arange(4))) & 255
    return np.where(b >= 128, b - 256, b) if signed else b


def mma(d, a, a_signed, b, b_signed):
    """d (n, 32, 4) += A B, with A (n, 32, k/8) and B (n, 32, k/16) the
    lanes' registers: A register r byte i is A[g + 8 (r & 1)][4t + i + 16
    (r >> 1)], B register s byte i is B[4t + i + 16 s][g], D register r is
    D[g + 8 (r >> 1)][2t + (r & 1)] (PTX ISA, mma.m16n8k16 / m16n8k32 with
    8-bit integer types)."""
    n, _, ar = a.shape
    k = 8 * ar
    PRODUCTS[f"m16n8k{k}"] += n
    ab, bb = lane_bytes(a, a_signed), lane_bytes(b, b_signed)
    am = np.zeros((n, 16, k), np.int64)
    bm = np.zeros((n, k, 8), np.int64)
    cols = 4 * T[:, None] + np.arange(4)
    for r in range(ar):
        am[:, (G + 8 * (r & 1))[:, None], cols + 16 * (r >> 1)] = ab[:, :, r]
    for s in range(k // 16):
        bm[:, cols + 16 * s, G[:, None]] = bb[:, :, s]
    prod = am @ bm
    r4 = np.arange(4)
    return d + prod[:, (G[:, None] + 8 * (r4 >> 1)), 2 * T[:, None] + (r4 & 1)]


# ---- the stage, lane by lane -------------------------------------------------


class Tile:
    def __init__(self, tu, dst):
        self.tu, self.var = tu, VARIANTS[(tu, int(dst))]
        self.w = 32 if tu == 32 else 16
        self.side, self.mt, self.ntl = B // self.w, self.w // 16, self.w // 8
        self.ar, self.br = self.w // 8, self.w // 16
        log2 = tu.bit_length() - 1
        self.s1, self.s2 = log2 - 1, log2 + 6


def wrap16(v):
    return ((v + 32768) & 0xFFFF) - 32768


def to_int32(v):
    v = v & 0xFFFFFFFF
    return np.where(v >= 1 << 31, v - (1 << 32), v)


def quantize(c, qscale, qshift, qoffset):
    t = to_int32(np.abs(c) * qscale + (qoffset << (qshift - 16)))
    q = t >> qshift
    return np.clip(np.where(c < 0, -q, q), -32768, 32767)


def dequantize(q, dscale, dshift):
    return np.clip(to_int32((q & 0xFFFFFFFF) * dscale + (1 << (dshift - 1))) >> dshift,
                   -32768, 32767)


def egk_bits(q):
    a = np.abs(q)
    return np.where(a > 0, 2 * np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 3, 0)


def split4(v0, v1, v2, v3):
    """The low 16 bits of four values: (hi bytes, lo bytes) words."""
    v = np.stack([v0, v1, v2, v3], -1)
    return pack_bytes((v >> 8) & 255), pack_bytes(v & 255)


def a_fragments(s, acc):
    """acc (ntl, n, 32, 4) -> hi, lo (n, 32, ar): register r holds acc[2
    (r >> 1) + (i >> 1)][2 (r & 1) + (i & 1)] in byte i."""
    hi, lo = [], []
    for r in range(s.ar):
        j, c = 2 * (r >> 1), 2 * (r & 1)
        h, l_ = split4(acc[j][..., c], acc[j][..., c + 1], acc[j + 1][..., c], acc[j + 1][..., c + 1])
        hi.append(h)
        lo.append(l_)
    return np.stack(hi, -1), np.stack(lo, -1)


def lds(mem, offs, nbytes):
    """(n, 32) little-endian words of nbytes at each lane's offset."""
    return sum(mem[:, offs + i].astype(np.int64) << (8 * i) for i in range(nbytes))


def words_of(table, s, base, count, n):
    return np.broadcast_to(np.stack([table[s.var, base + r] for r in range(count)], -1),
                           (n, 32, count))


class Trace:
    """Extremes the stage met: the forward passes' values before the int16
    wrap, the levels, the dequantizer's values before its clip, the inverse
    passes' values before theirs, and the pixels before the 8-bit clip."""

    def __init__(self):
        self.lo, self.hi = {}, {}

    def see(self, name, v):
        self.lo[name] = min(self.lo.get(name, 0), int(v.min()))
        self.hi[name] = max(self.hi.get(name, 0), int(v.max()))


def forward_rows(s, table, src, pred, off, mt, trace):
    n = src.shape[0]
    a = words_of(table, s, 4 * mt, s.ar, n)
    s1 = []
    for j in range(s.ntl):
        lane_off = off + (8 * j + G) * B + 4 * T
        bs = np.stack([lds(src, lane_off + 16 * q, 4) for q in range(s.br)], -1)
        bp = np.stack([lds(pred, lane_off + 16 * q, 4) for q in range(s.br)], -1)
        d = mma(np.zeros((n, 32, 4), np.int64), a, True, bp, False)
        d = (1 << (s.s1 - 1)) - d
        d = mma(d, a, True, bs, False)
        trace.see("forward rows", d >> s.s1)
        s1.append(d >> s.s1)
    return s1


def forward_columns(s, table, s1, mt, qp, dqh, dql, counts, trace):
    n = s1[0].shape[0]
    ah, al = a_fragments(s, s1)
    dq = []
    for j in range(s.ntl):
        b = words_of(table, s, 8 + 2 * j, s.br, n)
        d = mma(np.zeros((n, 32, 4), np.int64), ah, True, b, True)
        d = 256 * d + (1 << (s.s2 - 1))
        d = mma(d, al, False, b, True)
        trace.see("forward columns", d >> s.s2)
        q = quantize(wrap16(d >> s.s2), *qp[:3])
        trace.see("levels", q)
        e = egk_bits(q)
        for r in range(4):
            slot = 2 * j + (r >> 1) if s.tu <= 8 else 0
            counts[slot] = (counts[slot] + ((e[..., r] << 16) | (e[..., r] != 0))) & 0xFFFFFFFF
        trace.see("dequantized", to_int32((q & 0xFFFFFFFF) * qp[3] + (1 << (qp[4] - 1))) >> qp[4])
        dq.append(dequantize(q, *qp[3:]))
    for h in range(2):
        for q in range(s.br):
            dqh[2 * mt + h][q], dql[2 * mt + h][q] = split4(
                dq[2 * q][..., 2 * h], dq[2 * q][..., 2 * h + 1], dq[2 * q + 1][..., 2 * h],
                dq[2 * q + 1][..., 2 * h + 1])


def inverse_columns(s, table, dqh, dql, mt, trace):
    n = dqh[0][0].shape[0]
    a = words_of(table, s, 16 + 4 * mt, s.ar, n)
    r1 = []
    for u in range(s.ntl):
        d = mma(np.zeros((n, 32, 4), np.int64), a, True, np.stack(dqh[u], -1), True)
        d = 256 * d + 64
        d = mma(d, a, True, np.stack(dql[u], -1), False)
        trace.see("inverse columns", d >> 7)
        r1.append(np.clip(d >> 7, -32768, 32767))
    return r1


def inverse_rows(s, table, r1, pred, out, off, mt, trace):
    n = r1[0].shape[0]
    ah, al = a_fragments(s, r1)
    for j in range(s.ntl):
        b = words_of(table, s, 24 + 2 * j, s.br, n)
        d = mma(np.zeros((n, 32, 4), np.int64), ah, True, b, True)
        d = 256 * d + 2048
        d = mma(d, al, False, b, True)
        trace.see("inverse rows", d >> 12)
        for h in range(2):
            lane_off = off + (16 * mt + G + 8 * h) * B + 8 * j + 2 * T
            p = lds(pred, lane_off, 2)
            px = [(p & 255) + (d[..., 2 * h] >> 12), (p >> 8) + (d[..., 2 * h + 1] >> 12)]
            for i, v in enumerate(px):
                trace.see("pixels", v)
                out[np.arange(n)[:, None], lane_off + i] = np.clip(v, 0, 255)


def shfl_xor(v, o):
    return v[:, LANE ^ o]


def store_counts(s, counts, nnz, bits, ty, tx):
    """counts[4] (n, 32) uint32 reduced as residual_core.cuh store_counts
    reduces them, stored by the lanes that end with a TU's count."""
    k = B // s.tu
    m = 0xFFFFFFFF
    if s.tu >= 16:
        v = counts[0]
        for o in (16, 8, 4, 2, 1):
            v = (v + shfl_xor(v, o)) & m
        idx = np.where(LANE == 0, ty * k + tx, -1)
    else:
        x1 = 16 if s.tu == 8 else 8
        x2 = x1 // 2
        up1, up2 = (LANE & x1) != 0, (LANE & x2) != 0
        p0 = (np.where(up1, counts[2], counts[0])
              + shfl_xor(np.where(up1, counts[0], counts[2]), x1)) & m
        p1 = (np.where(up1, counts[3], counts[1])
              + shfl_xor(np.where(up1, counts[1], counts[3]), x1)) & m
        v = (np.where(up2, p1, p0) + shfl_xor(np.where(up2, p0, p1), x2)) & m
        slot = 2 * up1 + up2
        j, h = slot >> 1, slot & 1
        if s.tu == 8:
            for o in (4, 2, 1):
                v = (v + shfl_xor(v, o)) & m
            idx = np.where(LANE & 7, -1, (2 * ty + j) * k + 2 * tx + h)
        else:
            v = (v + shfl_xor(v, 1)) & m
            idx = np.where(LANE & 1, -1,
                           (4 * ty + 2 * j + ((LANE >> 1) & 1)) * k + 4 * tx + 2 * h + (LANE >> 4))
    writers = idx >= 0
    assert len(set(idx[writers])) == writers.sum()
    nnz[:, idx[writers]] = v[:, writers] & 0xFFFF
    bits[:, idx[writers]] = v[:, writers] >> 16


def residual_mirror(src, pred, tu, tr_type, qp, seed=0):
    """(rec, nnz, bits, trace) of n CTUs, tile by tile as the warps code
    them; src and pred (n, 64, 64) uint8; qp the five quantizer parameters."""
    s = Tile(tu, bool(tr_type))
    table = frag_table(poison_seed=seed)
    n = src.shape[0]
    rng = np.random.default_rng(seed)
    src_m, pred_m = src.reshape(n, -1), pred.reshape(n, -1)
    out = rng.integers(0, 256, (n, B * B)).astype(np.uint8)
    k = B // tu
    nnz = rng.integers(-1 << 20, 1 << 20, (n, k * k))
    bits = rng.integers(-1 << 20, 1 << 20, (n, k * k))
    trace = Trace()
    for ty in range(s.side):
        for tx in range(s.side):
            off = s.w * (ty * B + tx)
            dqh = [[None] * s.br for _ in range(s.ntl)]
            dql = [[None] * s.br for _ in range(s.ntl)]
            counts = [np.zeros((n, 32), np.int64) for _ in range(4)]
            for mt in range(s.mt):
                s1 = forward_rows(s, table, src_m, pred_m, off, mt, trace)
                forward_columns(s, table, s1, mt, qp, dqh, dql, counts, trace)
            store_counts(s, counts, nnz, bits, ty, tx)
            for mt in range(s.mt):
                r1 = inverse_columns(s, table, dqh, dql, mt, trace)
                inverse_rows(s, table, r1, pred_m, out, off, mt, trace)
    return out.reshape(n, B, B), nnz.reshape(n, k, k), bits.reshape(n, k, k), trace


# ---- cases -------------------------------------------------------------------

CONTENTS = chip_smoke.RESIDUAL_CONTENTS
QSETS = ["qp 32", *chip_smoke.RESIDUAL_EDGE_QARGS]


def qargs(qset, tu, tr_type):
    if qset in chip_smoke.RESIDUAL_EDGE_QARGS:
        return chip_smoke.RESIDUAL_EDGE_QARGS[qset]
    cfg = EncodeConfig(qp=32, tu=tu)
    return (*cfg.quant_params(bool(tr_type)), *cfg.dequant_params())


@functools.lru_cache(maxsize=None)
def batch(tu, tr_type, qset):
    """Every content's CTUs through the mirror, JAX and the plain version."""
    src, pred = chip_smoke.residual_ctus(np.random.default_rng(tu + 5 * tr_type))
    q = qargs(qset, tu, tr_type)
    mirror = residual_mirror(src, pred, tu, tr_type, q, seed=tu)
    jax_rec, jax_nnz = jax_residual_ctu(jnp.asarray(src), jnp.asarray(pred), *q, tu=tu,
                                        tr_type=tr_type)
    plain_rec, plain_nnz = residual_ctu.residual_pipeline_ctu_ref(src, pred, *q, tu=tu,
                                                                  tr_type=tr_type)
    _, levels, _ = residual_levels(src, pred, *q, tu=tu, tr_type=tr_type)
    k = B // tu
    plain_bits = egk_bits(levels.numpy().astype(np.int64)).sum((-2, -1)).reshape(-1, k, k)
    return mirror, (np.asarray(jax_rec), np.asarray(jax_nnz)), \
        (plain_rec.numpy(), plain_nnz.numpy(), plain_bits)


@pytest.mark.parametrize("content", range(len(CONTENTS)), ids=list(CONTENTS))
@pytest.mark.parametrize("qset", QSETS)
@pytest.mark.parametrize("tu,tr_type", list(VARIANTS), ids=["4 DST", "4", "8", "16", "32"])
def test_mirror_matches_jax_and_the_plain_version(tu, tr_type, qset, content):
    (rec, nnz, bits, _), (jax_rec, jax_nnz), (plain_rec, plain_nnz, plain_bits) = \
        batch(tu, tr_type, qset)
    sl = slice(*CONTENTS[list(CONTENTS)[content]])
    np.testing.assert_array_equal(rec[sl], jax_rec[sl], err_msg="rec vs JAX")
    np.testing.assert_array_equal(nnz[sl], jax_nnz[sl], err_msg="nnz vs JAX")
    np.testing.assert_array_equal(rec[sl], plain_rec[sl], err_msg="rec vs plain")
    np.testing.assert_array_equal(nnz[sl], plain_nnz[sl], err_msg="nnz vs plain")
    np.testing.assert_array_equal(bits[sl], plain_bits[sl], err_msg="bits vs plain levels")


@pytest.mark.parametrize("tu,tr_type", list(VARIANTS), ids=["4 DST", "4", "8", "16", "32"])
def test_full_swing_and_range_edges_reach_the_ends(tu, tr_type):
    # The cases do what they are there for: full swing drives the forward
    # passes to +-32640 (the s8/u8 split's ends, and no int16 wrap), the
    # range edges drive the levels to the int16 clip, the dequantizer and
    # the inverse columns past their clips and the pixels past 0 and 255.
    fwd = batch(tu, tr_type, "qp 32")[0][3]
    top = 32640 if tr_type == 0 else None
    for name in ("forward rows", "forward columns"):
        assert -32768 <= fwd.lo[name] and fwd.hi[name] <= 32767, name
        if top:
            assert fwd.hi[name] == top and fwd.lo[name] == -top, name
    edge = batch(tu, tr_type, "qscale 2^15-1, qshift 16, dshift 1")[0][3]
    assert edge.hi["dequantized"] > 32767 and edge.lo["dequantized"] < -32768
    assert edge.hi["inverse columns"] > 32767 and edge.lo["inverse columns"] < -32768
    assert edge.hi["pixels"] > 255 and edge.lo["pixels"] < 0
    assert edge.hi["levels"] == quantize(np.int64(edge.hi["forward columns"]),
                                         *chip_smoke.RESIDUAL_EDGE_QARGS[
                                             "qscale 2^15-1, qshift 16, dshift 1"][:3])


def test_fragment_table_holds_the_block_diagonal_bands():
    # The words, read back through the fragments' element positions and the
    # contraction order, are kron(I, T) over the tile (JAX's block_diag_t).
    table = frag_table()
    i4 = np.arange(4)
    for (tu, tr_type), v in VARIANTS.items():
        w = 32 if tu == 32 else 16
        bd = block_diag_t(tu, w, tr_type)
        fwd, inv = np.zeros((w, w), np.int64), np.zeros((w, w), np.int64)
        for mt in range(w // 16):
            for r in range(w // 8):
                el = lane_bytes(table[v, 4 * mt + r][None, :, None], True)[0, :, 0]
                rows = (16 * mt + G + 8 * (r & 1))[:, None]
                fwd[rows, 4 * T[:, None] + i4 + 16 * (r >> 1)] = el
                el = lane_bytes(table[v, 16 + 4 * mt + r][None, :, None], True)[0, :, 0]
                inv[perm(4 * T[:, None] + i4 + 16 * (r >> 1)), rows] = el
        np.testing.assert_array_equal(fwd, bd)
        np.testing.assert_array_equal(inv, bd)
        for j in range(w // 8):
            for s in range(w // 16):
                k = perm(4 * T[:, None] + i4 + 16 * s)
                el = lane_bytes(table[v, 8 + 2 * j + s][None, :, None], True)[0, :, 0]
                np.testing.assert_array_equal(el, bd[(8 * j + G)[:, None], k])
                el = lane_bytes(table[v, 24 + 2 * j + s][None, :, None], True)[0, :, 0]
                np.testing.assert_array_equal(el, bd[k, (8 * j + G)[:, None]])
        unused = sorted(set(range(32)) - set(USED_WORDS[w]))
        assert not table[v, unused].any()


def test_the_permutation_is_the_accumulators_column_order():
    # Operand position 4t + i (+16) holds what lane (g, t)'s accumulators
    # hold in n tile 2 (i >> 1) (+2), column 2t + (i & 1).
    for p in range(32):
        t, i = (p & 15) >> 2, p & 3
        tile = 2 * (p >> 4) + (i >> 1)
        assert perm(p) == 8 * tile + 2 * t + (i & 1)
    assert sorted(perm(np.arange(32))) == list(range(32))


def test_k2_tiles_are_the_vertical_pass_tiles():
    # residual_ctu8 gives warp w the 16x16 tiles (2 (w >> 2) + s, w & 3):
    # exactly the pixels the warp's vertical-pass tiles cover
    # (refine_tc_core.cuh tile_y, tile_x), so K2 and B3 need only __syncwarp.
    for warp in range(8):
        residual = {(16 * (2 * (warp >> 2) + s) + y, 16 * (warp & 3) + x)
                    for s in range(2) for y in range(16) for x in range(16)}
        vertical = set()
        for lane in range(32):
            tid = 32 * warp + lane
            for j in range(4):
                for r in range(4):
                    y = 32 * (tid >> 7) + 8 * j + 2 * (tid & 3) + (r & 1)
                    x = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2) + 8 * (r >> 1)
                    vertical.add((y, x))
        assert residual == vertical


@pytest.mark.parametrize("tu,tr_type", list(VARIANTS), ids=["4 DST", "4", "8", "16", "32"])
def test_product_counts_equal_chip_smokes_design_floor(tu, tr_type):
    src, pred = chip_smoke.residual_ctus(np.random.default_rng(0))
    for key in PRODUCTS:
        PRODUCTS[key] = 0
    residual_mirror(src[:1], pred[:1], tu, tr_type, qargs("qp 32", tu, tr_type))
    assert (PRODUCTS["m16n8k16"], PRODUCTS["m16n8k32"]) == chip_smoke.residual_tc_products(1, tu)


def test_phase_cost_ablations_still_match_the_header():
    # tools/residual_phase_costs.py edits residual_core.cuh by text; each
    # edit of this checkout's design must find its text once.
    from tools import residual_phase_costs as tool

    csrc = Path(build.CSRC)
    design = tool.design_of(csrc)
    assert design == "tensor cores"
    text = (csrc / tool.HEADER).read_text()
    for name, edits in tool.DESIGNS[design].items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
        tool.edited_header(edits, csrc)
    for kernel, (source, entry) in tool.KERNELS.items():
        assert f'extern "C" int {entry}(' in (csrc / source).read_text(), kernel


# ---- the header itself, on an emulated warp -------------------------------------

EMULATED_MAIN = r"""
#include "residual_core.cuh"

#include <cstdio>
#include <thread>
#include <vector>

// stdin: n tu dst qscale qshift qoffset dscale dshift, then the n * 4096
// source and n * 4096 prediction bytes; stdout: the n * 4096 pixels, then
// the nnz and the bits of every TU.  32 threads, one a lane, code each tile.
template <int TU, bool DST>
void run(int n, const std::vector<uint8_t>& src, const std::vector<uint8_t>& pred,
         std::vector<uint8_t>& rec, std::vector<int32_t>& nnz, std::vector<int32_t>& bits,
         const QParams& q) {
  using S = restc::Tile<TU, DST>;
  const int k = B / TU;
  for (int i = 0; i < n; ++i)
    for (int ty = 0; ty < S::SIDE; ++ty)
      for (int tx = 0; tx < S::SIDE; ++tx) {
        std::barrier<> warp(32);
        g_warp_barrier = &warp;
        std::vector<std::thread> lanes;
        for (int l = 0; l < 32; ++l)
          lanes.emplace_back([&, l] {
            threadIdx.x = l;
            residual_tile<TU, DST>(&src[i * 4096], &pred[i * 4096], &rec[i * 4096],
                                   &nnz[i * k * k], &bits[i * k * k], ty, tx, q);
          });
        for (auto& lane : lanes) lane.join();
      }
}

int main() {
  int n, tu, dst;
  QParams q;
  if (scanf("%d %d %d %d %d %d %d %d", &n, &tu, &dst, &q.qscale, &q.qshift, &q.qoffset,
            &q.dscale, &q.dshift) != 8)
    return 1;
  std::vector<uint8_t> src(n * 4096), pred(n * 4096), rec(n * 4096, 77);
  for (auto* plane : {&src, &pred})
    for (auto& v : *plane) {
      int x;
      if (scanf("%d", &x) != 1) return 1;
      v = static_cast<uint8_t>(x);
    }
  const int k = 64 / tu;
  std::vector<int32_t> nnz(n * k * k, -99), bits(n * k * k, -99);
  if (tu == 4 && dst) run<4, true>(n, src, pred, rec, nnz, bits, q);
  else if (tu == 4) run<4, false>(n, src, pred, rec, nnz, bits, q);
  else if (tu == 8) run<8, false>(n, src, pred, rec, nnz, bits, q);
  else if (tu == 16) run<16, false>(n, src, pred, rec, nnz, bits, q);
  else run<32, false>(n, src, pred, rec, nnz, bits, q);
  for (auto v : rec) printf("%d ", v);
  for (auto v : nnz) printf("%d ", v);
  for (auto v : bits) printf("%d ", v);
  printf("\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated_stage(tmp_path_factory):
    """residual_core.cuh itself built for the CPU: tests/warp_emu.h runs a
    warp as 32 threads, and the header's mma.sync wrappers (the one block of
    inline PTX) become its emulated product.  Skips without a C++20
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to build the header for the CPU")
    tmp = tmp_path_factory.mktemp("residual_emu")
    text = (Path(build.CSRC) / "residual_core.cuh").read_text()
    start, end = text.index("#define RESTC_MMA("), text.index("#undef RESTC_MMA")
    emulated = "\n".join(
        f"template <int W> __device__ __forceinline__ void {name}(int (&d)[4], "
        f"const uint32_t (&a)[W / 8], const uint32_t (&b)[W / 16]) "
        f"{{ emu_mma<W, {a}, {b}>(d, a, b); }}"
        for name, a, b in (("mma_s8u8", "true", "false"), ("mma_s8s8", "true", "true"),
                           ("mma_u8s8", "false", "true")))
    (tmp / "residual_core.cuh").write_text(
        '#include "warp_emu.h"\n' + text[:start] + emulated + "\n" + text[end:])
    (tmp / "cuda_runtime.h").write_text("#pragma once\n")
    (tmp / "main.cpp").write_text(EMULATED_MAIN)
    exe = tmp / "stage"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-I", str(tmp), "-I",
                    str(Path(__file__).parent), "-o", str(exe), str(tmp / "main.cpp")],
                   check=True, capture_output=True, text=True)
    return exe


@pytest.mark.parametrize("tu,tr_type", list(VARIANTS), ids=["4 DST", "4", "8", "16", "32"])
def test_the_header_itself_on_an_emulated_warp(emulated_stage, tu, tr_type):
    # The kernel's own source, lane by lane, against the plain version, on
    # every content and quantizer set of the mirror's cases.
    src, pred = chip_smoke.residual_ctus(np.random.default_rng(tu + 5 * tr_type))
    n, k = src.shape[0], B // tu
    for qset in QSETS:
        _, _, (plain_rec, plain_nnz, plain_bits) = batch(tu, tr_type, qset)
        stdin = " ".join(map(str, (n, tu, tr_type, *qargs(qset, tu, tr_type),
                                   *src.ravel(), *pred.ravel())))
        out = subprocess.run([str(emulated_stage)], input=stdin, capture_output=True,
                             text=True, check=True, timeout=300).stdout.split()
        vals = np.array(out, dtype=np.int64)
        rec = vals[:n * B * B].reshape(n, B, B)
        nnz = vals[n * B * B:n * B * B + n * k * k].reshape(n, k, k)
        bits = vals[n * B * B + n * k * k:].reshape(n, k, k)
        np.testing.assert_array_equal(rec, plain_rec, err_msg=f"rec, {qset}")
        np.testing.assert_array_equal(nnz, plain_nnz, err_msg=f"nnz, {qset}")
        np.testing.assert_array_equal(bits, plain_bits, err_msg=f"bits, {qset}")
