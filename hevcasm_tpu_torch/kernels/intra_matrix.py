"""All 35 intra modes of a 32x32 block as one constant matrix product, the
counterpart of ``hevcasm_tpu.kernels.intra_matrix`` (XLA matrix products in
the JAX package, no Pallas kernel).

At nTbS = 32 HEVC filters no DC/H/V edge (8.4.4.2.6 does so only below
32), so every mode's prediction is an affine map of the reference samples
followed by one arithmetic shift:

    pred_m = (A_m @ refs + b_m) >> s_m

with A_m integer.  The matrices are built in numpy from a mirror of
ops.pred_intra's formulas in which each reference sample is a basis vector
(``_basis``), so every gather and swap stays exact.

The mode decision (``intra_mode_decision_t``) folds the 8x8 Hadamard
transform of the SATD cost into the matrices: it scores each mode in the
transform domain against the block's own H8 X H8 and recovers the winning
mode's prediction by the inverse transform (H(HXH)H = 64X).  The metric is
finer than the SATD of the shifted prediction, so near-ties may pick
another mode than the classic sweep would; the prediction of the chosen
mode is exactly ops.pred_intra's.

Every product here is an integer product of operands and partial sums below
2^28, computed as a float64 matrix product, which holds them exactly on
any device (CUDA has no integer matrix product).  The Hadamard-domain
weights are kept whole (|w| <= 1824, a column's sum of |w| <= 4096, so
|acc| < 2^21).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.pred_intra import ANGLES, INV_ANGLES, filter_flag
from ..ops.satd import hadamard_matrix
from ..utils.tensor import as_tensor, first_min, to_device

__all__ = ["pred_intra_all_modes_mm", "mode_matrices", "mode_matrices_t",
           "intra_mode_decision_t"]

#: Blocks scored in one product: the Hadamard-domain accumulators of 512
#: blocks take 147 MB as float64, so a 1080p frame's 2040 blocks run in
#: four chunks and no temporary passes ~0.6 GB.
CHUNK = 512


def _basis(n):
    """Reference samples as basis vectors: component layout
    [left(2n), above(2n), corner, bias] (R = 4n + 2)."""
    r = 4 * n + 2
    eye = np.eye(r, dtype=np.int64)
    return eye[: 2 * n], eye[2 * n: 4 * n], eye[4 * n], eye[4 * n + 1]


def _planar_matrix(n):
    left, above, _, bias = _basis(n)
    w = np.zeros((n, n, left.shape[-1]), np.int64)
    for y in range(n):
        for x in range(n):
            w[y, x] += (n - 1 - x) * left[y] + (x + 1) * above[n]
            w[y, x] += (n - 1 - y) * above[x] + (y + 1) * left[n]
            w[y, x] += n * bias
    return w, n.bit_length()  # shift = log2(n) + 1


def _dc_matrix(n):
    left, above, _, bias = _basis(n)
    acc = n * bias + above[:n].sum(0) + left[:n].sum(0)
    return np.broadcast_to(acc, (n, n, left.shape[-1])).copy(), n.bit_length()


def _angular_matrix(n, mode):
    """A mirror of ops.pred_intra.pred_intra_angular with no edge filter
    (n == 32)."""
    left, above, corner, bias = _basis(n)
    angle = ANGLES[mode]
    vertical = mode >= 18
    if not vertical:
        left, above = above, left
    pos = np.concatenate([corner[None], above], axis=0)     # ref[0 .. 2n]
    if angle >= 0:
        ref, off = pos, 0
    else:
        inv = INV_ANGLES[angle]
        neg_len = -((n * angle) >> 5)
        neg = []
        for x in range(-1, -neg_len - 1, -1):
            y0 = -1 + ((x * inv + 128) >> 8)
            neg.append(corner if y0 < 0 else left[y0])
        ref = np.concatenate([np.stack(neg[::-1]), pos], axis=0)
        off = neg_len
    w = np.zeros((n, n, left.shape[-1]), np.int64)
    for y in range(n):
        idx = ((y + 1) * angle) >> 5
        fact = ((y + 1) * angle) & 31
        for x in range(n):
            g = off + x + idx + 1
            # The second sample past the run occurs only with fact == 0.
            g1 = min(g + 1, len(ref) - 1)
            w[y, x] = (32 - fact) * ref[g] + fact * ref[g1] + 16 * bias
    if not vertical:
        w = np.swapaxes(w, 0, 1)
    return w, 5


def _mode_affine(mode, n):
    """(w (n, n, 4n+2) int64 with the bias component, shift) of one mode."""
    if mode == 0:
        return _planar_matrix(n)
    if mode == 1:
        return _dc_matrix(n)
    return _angular_matrix(n, mode)


def _check_n(n):
    if n != 32:
        raise ValueError(f"the matrix form covers 32x32 blocks (no edge filter), got n={n}")


def _place(weights, mode, n):
    """(n*n, 2r1): a mode's weights in the plain or the filtered half of
    the [plain(129) || filtered(129)] reference vector, per filter_flag."""
    r1 = 4 * n + 1
    full = np.zeros((weights.shape[0], 2 * r1), np.int64)
    half = r1 if filter_flag(mode, n) else 0
    full[:, half: half + r1] = weights
    return full


@functools.lru_cache
def mode_matrices(n: int):
    """(w8 (258, 35*n*n) int8, bias (35*n*n,) int32, shifts (35*n*n,) int32),
    numpy.  Column m*n*n + y*n + x maps the centred reference vector
    [plain(129) - 128 || filtered(129) - 128] to mode m's accumulator at
    (y, x) before the shift; the centring (128 * the weights' sum) and the
    rounding term are folded into ``bias``."""
    _check_n(n)
    r1 = 4 * n + 1
    cols, biases, shifts = [], [], []
    for mode in range(35):
        w, s = _mode_affine(mode, n)
        w = w.reshape(n * n, r1 + 1)
        weights, b = w[:, :r1], w[:, r1]
        if weights.min() < 0 or weights.max() >= 128:
            raise AssertionError(f"mode {mode}: a weight outside int8")
        cols.append(_place(weights, mode, n))
        biases.append(b + 128 * weights.sum(-1))
        shifts.append(np.full(n * n, s, np.int64))
    w8 = np.concatenate(cols, axis=0).T.astype(np.int8)
    return w8, np.concatenate(biases).astype(np.int32), np.concatenate(shifts).astype(np.int32)


@functools.lru_cache
def mode_matrices_t(n: int):
    """The Hadamard-domain mode matrices of the mode decision, numpy.

    With T(X)[tile] = H8 @ X[tile] @ H8 over the 8x8 tiles, the transformed
    candidate of mode m is W_T_m @ refs + b_T_m, and its score against the
    block is sum_t (|accT_m[t] - (srcT[t] << s_m)| >> (s_m + 2)).

    Returns (wt (258, 35*n*n) int32 whole weights, bias_t (35*n*n,) int32
    with the centring folded in, shift_lane (35*n*n,) int32 = s_m + 2,
    src_scale_lane (35*n*n,) int32 = 1 << s_m, shifts (35,) int64).
    Columns of a mode in (tile_y, tile_x, u, v) order."""
    _check_n(n)
    h8 = hadamard_matrix(8).astype(np.int64)
    r1 = 4 * n + 1
    cols, biases, shifts = [], [], []
    for mode in range(35):
        w, s = _mode_affine(mode, n)
        w4 = w.reshape(4, 8, 4, 8, w.shape[-1])        # (ty, u, tx, v, R)
        t = np.einsum("au,cv,TuXvr->TXacr", h8, h8, w4).reshape(n * n, w.shape[-1])
        weights, b = t[:, :r1], t[:, r1]
        cols.append(_place(weights, mode, n))
        biases.append(b + 128 * weights.sum(-1))
        shifts.append(s)
    wt = np.concatenate(cols, axis=0).T.astype(np.int32)
    shifts = np.asarray(shifts, np.int64)
    return (wt, np.concatenate(biases).astype(np.int32),
            np.repeat(shifts + 2, n * n).astype(np.int32),
            np.repeat(1 << shifts, n * n).astype(np.int32), shifts)


@functools.lru_cache(maxsize=8)
def _tables(n: int, device: torch.device):
    w8, bias, shift = mode_matrices(n)
    return (to_device(w8, torch.float64, device), to_device(bias, torch.int32, device),
            to_device(shift, torch.int32, device))


@functools.lru_cache(maxsize=8)
def _tables_t(n: int, device: torch.device):
    """(wt float64, bias_t int32, per-mode shift s_m + 2 (35, 1), per-mode
    scale 1 << s_m (35, 1), per-mode s_m (35,), H8 float64), on device."""
    wt, bias_t, _, _, shifts = mode_matrices_t(n)
    return (to_device(wt, torch.float64, device), to_device(bias_t, torch.int32, device),
            to_device((shifts + 2)[:, None], torch.int32, device),
            to_device((1 << shifts)[:, None], torch.int32, device),
            to_device(shifts, torch.int32, device),
            to_device(hadamard_matrix(8), torch.float64, device))


def _centred_refs(left, above, corner, left_f, above_f, corner_f) -> torch.Tensor:
    """(m, 258) float64: [plain || filtered] reference vector minus 128."""
    left = as_tensor(left)
    dev = left.device
    parts = [left, above, as_tensor(corner, dev)[..., None],
             left_f, above_f, as_tensor(corner_f, dev)[..., None]]
    refs = torch.cat([as_tensor(p, dev).to(torch.int32) for p in parts], dim=-1)
    return (refs - 128).to(torch.float64)


def intra_mode_decision_t(blocks, left, above, corner, left_f, above_f, corner_f,
                          n: int = 32):
    """Mode decision and winning prediction in the Hadamard domain.

    blocks (m, n, n) uint8 source; left/above (m, 2n), corner (m,) the
    substituted plain reference set, *_f the filtered one
    (ops.pred_intra.filter_references).  Returns (pred (m, n, n) uint8,
    ops.pred_intra's prediction of the chosen mode; best (m,) int32, the
    first minimum; score (m, 35) int32).  No candidate plane is made."""
    _check_n(n)
    blocks = as_tensor(blocks)
    dev = blocks.device
    wt, bias_t, shift, scale, shifts, h8 = _tables_t(n, dev)
    m = blocks.shape[0]
    refs = _centred_refs(left, above, corner, left_f, above_f, corner_f)
    # The block's own H8 X H8, tiles in (ty, tx) order, lanes (u, v).
    x = blocks.to(torch.float64).reshape(m, 4, 8, 4, 8).transpose(2, 3)
    src_t = (h8 @ x @ h8).to(torch.int32).reshape(m, 1, n * n)
    scores, bests, wins = [], [], []
    for s in range(0, m, CHUNK):
        acc = ((refs[s:s + CHUNK] @ wt).to(torch.int32) + bias_t).reshape(-1, 35, n * n)
        score = ((acc - src_t[s:s + CHUNK] * scale).abs() >> shift).sum(-1, dtype=torch.int32)
        best, _ = first_min(score)
        idx = best.long()[:, None, None].expand(-1, 1, n * n)
        wins.append(torch.gather(acc, 1, idx)[:, 0])
        scores.append(score)
        bests.append(best)
    score, best = torch.cat(scores), torch.cat(bests)
    # The winner's accumulator back from the transform domain: 64 A@refs + b.
    t_win = torch.cat(wins).to(torch.float64).reshape(m, 4, 4, 8, 8)
    acc_win = ((h8 @ t_win @ h8).to(torch.int64) >> 6).transpose(2, 3).reshape(m, n, n)
    pred = acc_win >> shifts[best.long()][:, None, None]
    return pred.clamp(0, 255).to(torch.uint8), best, score


def pred_intra_all_modes_mm(left, above, corner, left_f, above_f, corner_f,
                            n: int = 32) -> torch.Tensor:
    """All 35 modes for a batch of blocks through the constant matrix.

    left/above (m, 2n) uint8, corner (m,): the substituted plain reference
    set; *_f the filtered set.  Returns (m, 35, n, n) uint8, equal to
    ops.pred_intra.pred_intra of each mode (filter_edge=False) on the set
    filter_flag selects."""
    _check_n(n)
    refs = _centred_refs(left, above, corner, left_f, above_f, corner_f)
    w8, bias, shift = _tables(n, refs.device)
    acc = (refs @ w8).to(torch.int32)
    pred = (acc + bias) >> shift
    return pred.reshape(refs.shape[0], 35, n, n).to(torch.uint8)
