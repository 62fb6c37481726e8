"""The ops this slice adds to hevcasm_tpu_torch, against hevcasm_tpu on the
CPU on the same numpy inputs from a seed: motion compensation with one
fraction per block (pred_uni, pred_uni_16, pred_bi, 8-tap and 4-tap), the
whole-frame residual pipeline (residual_impl="mxu"), the "mxu" quarter-pel
refinement, and the k-reference full search.  Every output is integer and
must be equal."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels.interp_xla import refine_quarter_pel_mxu
from hevcasm_tpu.kernels.xla_opt import residual_pipeline_frame as jax_frame
from hevcasm_tpu.kernels.xla_opt import ssd_grid_ref as jax_ssd_grid
from hevcasm_tpu.ops import pred_inter as jpred

from hevcasm_tpu_torch import registry
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.ops import pred_inter as tpred
from hevcasm_tpu_torch.ops.residual import residual_pipeline_frame


def same(ours, theirs, what=""):
    """Equal values, shapes and dtypes."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.dtype == theirs.dtype, (what, ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs, err_msg=what)


@pytest.fixture
def rng():
    return np.random.default_rng(0x4D43)


def every_fraction(taps):
    """(xfrac, yfrac) int32 arrays, one block per pair of filter rows: the
    4 quarter-pel rows of the 8-tap filter, the 8 eighth-pel rows of the
    4-tap one."""
    rows = range(4 if taps == 8 else 8)
    pairs = np.array(list(itertools.product(rows, repeat=2)), dtype=np.int32)
    return pairs[:, 0], pairs[:, 1]


def windows(rng, n, h, w, taps, content):
    shape = (n, h + taps - 1, w + taps - 1)
    if content == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # Saturated extremes: large int16 intermediates and clipped outputs.
    return rng.choice(np.array([0, 255], dtype=np.uint8), shape)


# ---- motion compensation with one fraction per block --------------------------

@pytest.mark.parametrize("taps", [8, 4])
@pytest.mark.parametrize("content", ["random", "extremes"])
def test_pred_uni_per_block_fractions(rng, taps, content):
    xf, yf = every_fraction(taps)
    win = windows(rng, len(xf), 8, 16, taps, content)
    ours = tpred.pred_uni(torch.as_tensor(win), torch.as_tensor(xf), torch.as_tensor(yf), taps)
    same(ours, jpred.pred_uni(jnp.asarray(win), jnp.asarray(xf), jnp.asarray(yf), taps))
    # Block i equals the shared-fraction path at its own fraction.
    for i in (0, len(xf) // 3, len(xf) - 1):
        same(ours[i], tpred.pred_uni(torch.as_tensor(win[i]), int(xf[i]), int(yf[i]), taps))


@pytest.mark.parametrize("taps", [8, 4])
@pytest.mark.parametrize("content", ["random", "extremes"])
def test_pred_uni_16_per_block_fractions(rng, taps, content):
    xf, yf = every_fraction(taps)
    win = windows(rng, len(xf), 8, 16, taps, content)
    ours = tpred.pred_uni_16(torch.as_tensor(win), torch.as_tensor(xf), torch.as_tensor(yf), taps)
    same(ours, jpred.pred_uni_16(jnp.asarray(win), jnp.asarray(xf), jnp.asarray(yf), taps))
    same(tpred.pred_uni_16(torch.as_tensor(win), 1, 3, taps),
         jpred.pred_uni_16(jnp.asarray(win), 1, 3, taps))


@pytest.mark.parametrize("taps", [8, 4])
def test_pred_bi_per_block_fractions(rng, taps):
    xf0, yf0 = every_fraction(taps)
    n = len(xf0)
    perm = rng.permutation(n)
    xf1, yf1 = xf0[perm], yf0[perm]
    w0 = windows(rng, n, 16, 8, taps, "random")
    w1 = windows(rng, n, 16, 8, taps, "extremes")
    args = [w0, w1, xf0, yf0, xf1, yf1]
    ours = tpred.pred_bi(*(torch.as_tensor(a) for a in args), taps)
    same(ours, jpred.pred_bi(*(jnp.asarray(a) for a in args), taps))
    same(tpred.pred_bi(torch.as_tensor(w0), torch.as_tensor(w1), 2, 1, 0, 3, taps),
         jpred.pred_bi(jnp.asarray(w0), jnp.asarray(w1), 2, 1, 0, 3, taps))


def test_pred_bi_is_registered():
    assert registry.get("pred_bi") is tpred.pred_bi


# ---- the whole-frame residual pipeline (residual_impl="mxu") -------------------

@pytest.mark.parametrize("tu,tr_type", [(4, 0), (4, 1), (8, 0), (16, 0), (32, 0)])
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_residual_pipeline_frame_matches_jax(rng, tu, tr_type, block, qp):
    cfg = EncodeConfig(tu=tu, qp=qp)
    args = (*cfg.quant_params(tr_type == 1), *cfg.dequant_params())
    src = rng.integers(0, 256, (3, block, block), dtype=np.uint8)
    pred = np.clip(src.astype(np.int16) + rng.integers(-60, 61, src.shape), 0, 255
                   ).astype(np.uint8)
    pred[0] = src[0]                                  # a CTU with no coded TU
    ours = residual_pipeline_frame(src, pred, *args, tu=tu, tr_type=tr_type)
    theirs = jax_frame(jnp.asarray(src), jnp.asarray(pred), *args, tu=tu, tr_type=tr_type)
    for name, o, t in zip(("recon", "nnz", "cbf", "bits"), ours, theirs):
        same(o, t, name)


# ---- refine_impl="mxu" -----------------------------------------------------------

@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("content", ["random", "shifted", "constant"])
def test_refine_matches_jax_mxu_refinement(rng, b, content):
    n = 4
    win = rng.integers(0, 256, (n, b + 7, b + 7), dtype=np.uint8)
    if content == "constant":                         # every fraction ties
        win[:] = 77
    if content == "random":
        src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    else:
        noise = rng.integers(-2, 3, (n, b, b))
        src = np.clip(win[:, 3:3 + b, 3:3 + b] + noise, 0, 255).astype(np.uint8)
    ours = registry.get("refine_qpel")(src, win)
    theirs = refine_quarter_pel_mxu(jnp.asarray(src), jnp.asarray(win))
    for name, o, t in zip(("pred", "frac", "cost"), ours, theirs):
        same(o, t, name)


# ---- full_search_multi --------------------------------------------------------------

def multi_case(rng, r, h=128, w=192, k=2):
    """k references of one frame; cur is reference 0 shifted, so the two
    references win different CTUs."""
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    cur = base[5:5 + h, 7:7 + w].copy()
    refs = [base[:h, :w].copy()] + [rng.integers(0, 256, (h, w), dtype=np.uint8)
                                    for _ in range(k - 1)]
    if k > 1:                                         # the top CTU row favours the last
        refs[-1][:64] = base[3:67, 2:2 + w]
    planes = np.stack([np.asarray(jctu.pad_frame(jnp.asarray(p), r + 3, r + 4, r + 3, r + 4))
                       for p in refs])
    src = np.array(jctu.tile_frame(jnp.asarray(cur), 64))
    grid = (h // 64, w // 64)
    pos = np.array(jmotion.ctu_positions(*grid, 64))
    return src, planes, pos, grid


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("use_grid", [True, False])
def test_full_search_multi_matches_jax(rng, joint, use_grid):
    r = 8
    src, planes, pos, grid = multi_case(rng, r)
    assert grid[1] % 2 == 1
    grid = grid if use_grid else None
    ours = tmotion.full_search_multi(src, planes, pos, r, grid=grid, joint=joint)
    theirs = jmotion.full_search_multi(jnp.asarray(src), jnp.asarray(planes), jnp.asarray(pos),
                                       r, grid_fn=jax_ssd_grid, grid=grid, joint=joint,
                                       metric="ssd")
    assert len(ours) == len(theirs) == (3 if joint else 2)
    for o, t in zip(ours, theirs):
        same(o, t)
    if joint:
        assert set(ours[1].tolist()) == {0, 1}, "both references should win CTUs"


def test_full_search_multi_one_reference_is_full_search(rng):
    r = 8
    src, planes, pos, grid = multi_case(rng, r, k=1)
    mv, ref_idx, best = tmotion.full_search_multi(src, planes, pos, r, grid=grid)
    mv1, best1 = tmotion.full_search(torch.as_tensor(src), torch.as_tensor(planes[0]),
                                     torch.as_tensor(pos), r, grid=grid)
    assert torch.equal(mv, mv1) and torch.equal(best, best1)
    assert int(ref_idx.abs().sum()) == 0
