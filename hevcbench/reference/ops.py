"""Plain H.265 Main-profile (8-bit) arithmetic, written from the standard.

The benchmark's reference encoder is built from these functions.  They are
plain PyTorch on whatever device their inputs lie on, and import nothing of
the measured program.  Integers stay integers: samples and accumulators
are int64, and the matrix products (the core transforms, the 8x8 Hadamard)
run as products in ``dtype``.  At the default float64 every operand and
partial sum is an integer below 2^53, so the product is exact; another
``dtype`` (the control) computes the same formula at a lower precision and
rounds it back to integers.

Sections of H.265 (04/2013): 8.4.4.2 intra sample prediction, 8.5.3.3.3
fractional sample interpolation, 8.6 scaling and transformation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EXACT = torch.float64

# H.265 table 8-11: luma quarter-sample interpolation filter, fractions 0..3.
LUMA_FILTER = ((0, 0, 0, 64, 0, 0, 0, 0),
               (-1, 4, -10, 58, 17, -5, 1, 0),
               (-1, 4, -11, 40, 40, -11, 4, -1),
               (0, 1, -5, 17, 58, -10, 4, -1))

# H.265 table 8-12: chroma eighth-sample interpolation filter, fractions 0..7.
CHROMA_FILTER = ((0, 64, 0, 0), (-2, 58, 10, -2), (-4, 54, 16, -2), (-6, 46, 28, -4),
                 (-4, 36, 36, -4), (-4, 28, 46, -6), (-2, 16, 54, -4), (-2, 10, 58, -2))

# The distinct magnitudes of the 32-point transform matrix (8.6.4.2):
# MAG[q] is the coefficient at the angle q * pi / 64, q = 0 .. 31.
_MAG = (64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
        64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4)

# HM's forward scaling (quantization) and the standard's levelScale.
QUANT_SCALE = (26214, 23302, 20560, 18396, 16384, 14564)
LEVEL_SCALE = (40, 45, 51, 57, 64, 72)

# intraPredAngle (table 8-5) and invAngle (table 8-6).
INTRA_ANGLE = {2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0, 11: -2,
               12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32, 19: -26,
               20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0, 27: 2, 28: 5,
               29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32}
INV_ANGLE = {-32: -256, -26: -315, -21: -390, -17: -482, -13: -630, -9: -910, -5: -1638,
             -2: -4096}


def _cos_coef(k: int, j: int) -> int:
    """Entry (k, j) of the 32-point matrix: the integer cosine of
    k (2j + 1) pi / 64."""
    p = (k * (2 * j + 1)) % 128
    if p > 64:                      # cos(2 pi - a) = cos(a)
        p = 128 - p
    sign = 1
    if p > 32:                      # cos(pi - a) = -cos(a)
        p, sign = 64 - p, -1
    return 0 if p == 32 else sign * _MAG[p]


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """The n-point core transform matrix: rows 0, 32/n, 2*32/n, ... of the
    32-point matrix, its first n columns."""
    step = 32 // n
    return np.array([[_cos_coef(k * step, j) for j in range(n)] for k in range(n)],
                    dtype=np.int64)


@functools.lru_cache(maxsize=None)
def hadamard8() -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    return h


def matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype = EXACT) -> torch.Tensor:
    """a @ b of integer tensors as a product in ``dtype``, rounded to int64."""
    return torch.matmul(a.to(dtype), b.to(dtype)).to(torch.float64).round().to(torch.int64)


def const(values: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=torch.int64, device=device)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """A store to int16: two's-complement wrap."""
    return ((x + 32768) & 0xFFFF) - 32768


def clip16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-32768, 32767)


def forward_transform(res: torch.Tensor, dtype=EXACT) -> torch.Tensor:
    """2-D forward transform of (..., n, n) residuals (8.6.4.2 run forward,
    as HM does): rows then columns, shifts log2(n) - 1 and log2(n) + 6,
    each stage stored to int16."""
    n = res.shape[-1]
    t = const(dct_matrix(n), res.device)
    log2 = n.bit_length() - 1
    x = res
    for shift in (log2 - 1, log2 + 6):
        y = matmul(t, x.transpose(-2, -1), dtype)
        x = wrap16((y + (1 << (shift - 1))) >> shift)
    return x


def inverse_transform(coeffs: torch.Tensor, dtype=EXACT) -> torch.Tensor:
    """2-D inverse transform (8.6.4.2): two stages with shifts 7 and 12,
    each clipped to 16 bits."""
    n = coeffs.shape[-1]
    t = const(dct_matrix(n), coeffs.device)
    x = coeffs
    for shift in (7, 12):
        y = matmul(x.transpose(-2, -1), t, dtype)
        x = clip16((y + (1 << (shift - 1))) >> shift)
    return x


def quant_params(qp: int, tu: int, intra: bool):
    """HM's forward quantizer (scale, shift, rounding offset at that shift)
    and the standard's inverse (scale, shift) for 8-bit samples."""
    log2 = tu.bit_length() - 1
    shift = 21 + qp // 6 - log2                    # 14 + qp/6 + (15 - 8 - log2)
    offset = (171 if intra else 85) << (shift - 9)
    return QUANT_SCALE[qp % 6], shift, offset, LEVEL_SCALE[qp % 6] << (qp // 6), log2 - 1


def split_tus(blocks: torch.Tensor, tu: int) -> torch.Tensor:
    """(n, B, B) -> (n * (B/tu)^2, tu, tu), raster TU order in each block."""
    n, b, _ = blocks.shape
    k = b // tu
    return blocks.reshape(n, k, tu, k, tu).transpose(2, 3).reshape(-1, tu, tu)


def merge_tus(tus: torch.Tensor, b: int) -> torch.Tensor:
    tu = tus.shape[-1]
    k = b // tu
    return tus.reshape(-1, k, k, tu, tu).transpose(2, 3).reshape(-1, b, b)


def code_residual(src: torch.Tensor, pred: torch.Tensor, qp: int, tu: int, intra: bool,
                  dtype=EXACT):
    """Residual, forward transform, quantization, scaling, inverse transform
    and reconstruction of (n, B, B) blocks at tu x tu DCT TUs.  Returns
    (recon (n, B, B) int64 in [0, 255], number of non-zero levels as a 0-d
    tensor)."""
    qscale, qshift, qoffset, dscale, dshift = quant_params(qp, tu, intra)
    b = src.shape[-1]
    coeffs = forward_transform(split_tus(src - pred, tu), dtype)
    level = (coeffs.abs() * qscale + qoffset) >> qshift
    level = clip16(torch.where(coeffs < 0, -level, level))
    scaled = clip16((level * dscale + (1 << (dshift - 1))) >> dshift)
    res = inverse_transform(scaled, dtype)
    recon = (split_tus(pred, tu) + res).clamp(0, 255)
    return merge_tus(recon, b), (level != 0).sum()


def tile(frame: torch.Tensor, b: int) -> torch.Tensor:
    """(H, W) -> (H/b * W/b, b, b), raster block order."""
    h, w = frame.shape
    return frame.reshape(h // b, b, w // b, b).transpose(1, 2).reshape(-1, b, b)


def untile(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = blocks.shape[-1]
    return blocks.reshape(h // b, w // b, b, b).transpose(1, 2).reshape(h, w)


def edge_pad(plane: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Reference picture boundary extension: each sample outside the
    picture takes the nearest sample inside it."""
    h, w = plane.shape
    rows = torch.arange(-top, h + bottom, device=plane.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=plane.device).clamp(0, w - 1)
    return plane[rows][:, cols]


def windows(plane: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size, size) windows of a plane at top-left starts (n, 2)."""
    r = torch.arange(size, device=plane.device)
    rows = starts[:, 0, None] + r
    cols = starts[:, 1, None] + r
    return plane[rows[:, :, None], cols[:, None, :]]


def block_positions(h: int, w: int, b: int, device) -> torch.Tensor:
    """(n, 2) [y, x] of each b x b block, raster order."""
    ys, xs = torch.meshgrid(torch.arange(0, h, b, device=device),
                            torch.arange(0, w, b, device=device), indexing="ij")
    return torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1)


def first_min(costs: torch.Tensor):
    """(index, value) of the first minimum along the last axis."""
    best = costs.amin(dim=-1, keepdim=True)
    idx = torch.arange(costs.shape[-1], device=costs.device)
    first = torch.where(costs == best, idx, costs.shape[-1]).amin(dim=-1)
    return first, best[..., 0]


def ssd_search(src: torch.Tensor, win: torch.Tensor, r: int):
    """Exhaustive integer search: the SSD of each (n, b, b) block against
    every displacement of its (n, b + 2r, b + 2r) window, the first minimum
    in row-major [dy, dx] order.  SSD = sum s^2 + sum w^2 - 2 sum s w: the
    window energies from an integral image, the correlation by FFT in
    float64, whose error (checked) is far below the 0.5 that rounding to
    the exact integer allows.  Returns (mv (n, 2) int64 in [-r, r], best
    SSD (n,) int64)."""
    n, b, _ = src.shape
    size, num = b + 2 * r, 2 * r + 1
    s = src.to(torch.float64)
    w = win.to(torch.float64)
    corr = torch.fft.irfft2(torch.fft.rfft2(w) * torch.fft.rfft2(s, s=(size, size)).conj(),
                            s=(size, size))[:, :num, :num]
    exact = corr.round()
    err = float((corr - exact).abs().max())
    if err > 0.25:
        raise ArithmeticError(f"FFT correlation off by {err} from an integer")
    w2 = win.to(torch.int64) ** 2
    integral = torch.nn.functional.pad(w2.cumsum(1).cumsum(2), (1, 0, 1, 0))
    energy = (integral[:, b:, b:] - integral[:, :num, b:] - integral[:, b:, :num]
              + integral[:, :num, :num])
    ssd = (src.to(torch.int64) ** 2).sum((1, 2))[:, None, None] + energy \
        - 2 * exact.to(torch.int64)
    idx, best = first_min(ssd.reshape(n, -1))
    return torch.stack([idx // num - r, idx % num - r], dim=-1), best


def interpolate(win: torch.Tensor, xfrac: torch.Tensor, yfrac: torch.Tensor,
                table) -> torch.Tensor:
    """The pre-shift accumulator of fractional sample interpolation
    (8.5.3.3.3, 8-bit: shift1 = 0): the horizontal filter over every row
    of the (n, h + t - 1, w + t - 1) windows, stored to int16, then the
    vertical filter; per-block fractions (n,).  Returns (n, h, w) int64."""
    taps = len(table[0])
    coef = const(np.array(table), win.device)
    h, w = win.shape[1] - taps + 1, win.shape[2] - taps + 1
    cx, cy = coef[xfrac], coef[yfrac]
    rows = sum(cx[:, k, None, None] * win[:, :, k:k + w] for k in range(taps))
    rows = wrap16(rows)
    return sum(cy[:, k, None, None] * rows[:, k:k + h, :] for k in range(taps))


def uni_pred(acc: torch.Tensor) -> torch.Tensor:
    """Uni-prediction samples from the accumulator: shift2 = 6 and the
    weighted-prediction shift 14 - 8, with their rounding, clipped."""
    return ((acc + 2048) >> 12).clamp(0, 255)


def quarter_pel(src: torch.Tensor, win: torch.Tensor):
    """Quarter-pel refinement at the integer MV: the 16 fractions (yf, xf)
    in 0..3, each scored by sum |acc - (src << 12)| >> 4 on its pre-shift
    accumulator, the first minimum in yf * 4 + xf order.  win (n, b + 7,
    b + 7) starts 3 samples before the integer position.  Returns (pred (n,
    b, b), frac (n,) = yf * 4 + xf)."""
    n, b, _ = src.shape
    accs, scores = [], []
    for yf in range(4):
        for xf in range(4):
            acc = interpolate(win, torch.full((n,), xf, device=win.device),
                              torch.full((n,), yf, device=win.device), LUMA_FILTER)
            accs.append(acc)
            scores.append(((acc - (src << 12)).abs() >> 4).sum((1, 2)))
    frac, _ = first_min(torch.stack(scores, dim=-1))
    acc = torch.stack(accs, dim=1)[torch.arange(n, device=src.device), frac]
    return uni_pred(acc), frac


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.to(torch.float64) - b.to(torch.float64)
    mse = max(float((d * d).mean()), 1e-10)
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


# ---- intra (8.4.4.2) -----------------------------------------------------

def substitute(left, above, corner, lav, aav, cav):
    """Reference sample substitution (8.4.4.2.2): in the scan order from
    p[-1][2n-1] up to p[-1][-1] and on to p[2n-1][-1], an unavailable sample
    takes the last available one before it, a leading unavailable run the
    first available one, and with none available every sample is 128."""
    n2 = left.shape[-1]
    s = torch.cat([left.flip(-1), corner[:, None], above], dim=-1)
    m = torch.cat([lav.flip(-1), cav[:, None], aav], dim=-1)
    pos = torch.arange(s.shape[-1], device=s.device).expand_as(s)
    last = torch.where(m, pos, -1).cummax(dim=-1).values
    first = torch.where(m, pos, s.shape[-1]).amin(dim=-1, keepdim=True).expand_as(s)
    v = torch.gather(s, -1, torch.where(last >= 0, last, first).clamp(max=s.shape[-1] - 1))
    v = torch.where(m.any(-1, keepdim=True), v, 128)
    return v[:, :n2].flip(-1), v[:, n2 + 1:], v[:, n2]


def smooth(left, above, corner, strong_allowed: bool):
    """Filtering of neighbouring samples (8.4.4.2.3) for a 32x32 block:
    the [1 2 1] filter along the scan order with both ends kept, or, where
    strong_intra_smoothing is on and both edges are flat within 1 << (8 -
    5), the bilinear strong filter."""
    n2 = left.shape[-1]
    s = torch.cat([left.flip(-1), corner[:, None], above], dim=-1)
    mid = (s[:, :-2] + 2 * s[:, 1:-1] + s[:, 2:] + 2) >> 2
    f = torch.cat([s[:, :1], mid, s[:, -1:]], dim=-1)
    lf, af, cf = f[:, :n2].flip(-1), f[:, n2 + 1:], f[:, n2]
    if strong_allowed and n2 == 64:
        flat = (((corner + above[:, 63] - 2 * above[:, 31]).abs() < 8)
                & ((corner + left[:, 63] - 2 * left[:, 31]).abs() < 8))
        k = torch.arange(64, device=left.device)
        a_s = ((63 - k) * corner[:, None] + (k + 1) * above[:, 63:64] + 32) >> 6
        l_s = ((63 - k) * corner[:, None] + (k + 1) * left[:, 63:64] + 32) >> 6
        a_s[:, 63], l_s[:, 63] = above[:, 63], left[:, 63]
        lf = torch.where(flat[:, None], l_s, lf)
        af = torch.where(flat[:, None], a_s, af)
        cf = torch.where(flat, corner, cf)
    return lf, af, cf


def uses_filtered(mode: int, n: int) -> bool:
    """filterFlag of 8.4.4.2.3 for luma-like blocks of size n >= 8."""
    if mode == 1:
        return False
    thres = {8: 7, 16: 1, 32: 0}[n]
    return min(abs(mode - 26), abs(mode - 10)) > thres


def planar_dc(left, above, n: int):
    """The planar (8.4.4.2.5) and DC (8.4.4.2.6, no edge filter at n >= 32)
    accumulators before their shift log2(n) + 1: two (m, n, n) int64."""
    x = torch.arange(n, device=left.device)
    planar = ((n - 1 - x)[None, None, :] * left[:, :n, None]
              + (x + 1)[None, None, :] * above[:, n, None, None]
              + (n - 1 - x)[None, :, None] * above[:, None, :n]
              + (x + 1)[None, :, None] * left[:, n, None, None] + n)
    dc = n + above[:, :n].sum(-1) + left[:, :n].sum(-1)
    return planar, dc[:, None, None].expand(-1, n, n)


@functools.lru_cache(maxsize=None)
def angular_tables(n: int):
    """The angular modes 2..34 as index tables into the reference vector
    R = [left (2n), above (2n), corner]: mode m's accumulator at sample i
    of the block is (32 - F[m][i]) * R[A[m][i]] + F[m][i] * R[B[m][i]] + 16
    (8.4.4.2.6, the negative extension of ref[] included, horizontal modes
    transposed).  Returns (A, B, F), each (33, n * n) int64 numpy."""
    left, above, corner = np.arange(2 * n), 2 * n + np.arange(2 * n), 4 * n
    tables = []
    for mode in range(2, 35):
        angle = INTRA_ANGLE[mode]
        main, side = (above, left) if mode >= 18 else (left, above)
        ref = {0: corner, **{k: main[k - 1] for k in range(1, 2 * n + 1)}}
        if angle < 0 and (n * angle) >> 5 < -1:
            for k in range((n * angle) >> 5, 0):
                i = -1 + ((k * INV_ANGLE[angle] + 128) >> 8)
                ref[k] = corner if i < 0 else side[min(i, 2 * n - 1)]
        a, b, f = (np.zeros((n, n), np.int64) for _ in range(3))
        for y in range(n):
            i_idx, i_fact = ((y + 1) * angle) >> 5, ((y + 1) * angle) & 31
            for x in range(n):
                a[y, x] = ref[x + i_idx + 1]
                b[y, x] = ref[min(x + i_idx + 2, 2 * n)]     # weight 0 past the run
                f[y, x] = i_fact
        if mode < 18:
            a, b, f = a.T, b.T, f.T
        tables.append((a.reshape(-1), b.reshape(-1), f.reshape(-1)))
    return tuple(np.stack(t) for t in zip(*tables))


def intra_accs(plain, filt, n: int):
    """All 35 modes' accumulators before their shifts, each from the plain
    or the filtered neighbours as filterFlag says, for blocks of size n >=
    32: (acc (m, 35, n, n) int64, shifts (35,) int64)."""
    dev = plain[0].device
    acc0 = planar_dc(filt[0], filt[1], n)[0]         # planar: filtered (filterFlag)
    acc1 = planar_dc(plain[0], plain[1], n)[1]       # DC: never filtered
    r_plain = torch.cat([plain[0], plain[1], plain[2][:, None]], dim=-1)
    r_filt = torch.cat([filt[0], filt[1], filt[2][:, None]], dim=-1)
    a, b, f = (const(t, dev) for t in angular_tables(n))
    use_filt = torch.tensor([uses_filtered(m, n) for m in range(2, 35)], device=dev)
    r = torch.where(use_filt[None, :, None], r_filt[:, None, :], r_plain[:, None, :])
    m = r.shape[0]
    ang = ((32 - f) * r.gather(2, a.expand(m, -1, -1)) + f * r.gather(2, b.expand(m, -1, -1))
           + 16).reshape(m, 33, n, n)
    acc = torch.cat([acc0[:, None], acc1[:, None], ang], dim=1)
    shifts = const([n.bit_length()] * 2 + [5] * 33, dev)
    return acc, shifts


def hadamard_8x8(x: torch.Tensor, dtype=EXACT) -> torch.Tensor:
    """H x H over every 8x8 tile of (..., n, n) blocks, tiles flattened:
    (..., n*n/64, 8, 8)."""
    *lead, n, _ = x.shape
    k = n // 8
    t = x.reshape(*lead, k, 8, k, 8).transpose(-3, -2).reshape(*lead, k * k, 8, 8)
    h = const(hadamard8(), x.device)
    return matmul(matmul(h, t, dtype), h, dtype)


def satd8(a: torch.Tensor, b: torch.Tensor, dtype=EXACT) -> torch.Tensor:
    """SATD summed over the 8x8 sub-blocks of (m, n, n) blocks: per
    sub-block (sum |H (a - b) H| + 2) // 4.  Returns (m,) int64."""
    t = hadamard_8x8(a - b, dtype)
    return ((t.abs().sum((-2, -1)) + 2) // 4).sum(-1)
