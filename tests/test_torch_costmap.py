"""Kernels B12 and B13 on the CPU: hevcasm_tpu_torch's plain cost maps
(ops.pred_inter.qpel_costmap, refine_qpel_costmap_mxu and the *_ref
versions in kernels/costmap.py) against hevcasm_tpu's refine_qpel_costmap
and refine_qpel_costmap_dma (Pallas, run in interpret mode on the CPU) and
refine_qpel_costmap_mxu, on the same numpy inputs.  Every output is integer
and must be equal.  test_torch_cuda.py holds the CUDA kernels against these
plain versions on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels import interp_pallas as jpallas
from hevcasm_tpu.kernels import interp_xla as jxla

from torch_testing import jax_once, same
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.kernels import costmap
from hevcasm_tpu_torch.ops import pred_inter as tpred


def tiles(b, n, seed, extra=0, constant=None):
    """(src (n, b, b), windows (n, b+7+extra, b+7+extra)) uint8: a smooth
    picture and a copy of it moved by a sub-pixel amount, so the fractions
    differ; or constant windows, on which every fraction ties."""
    rng = np.random.default_rng(seed)
    w = b + 7 + extra
    if constant is not None:
        win = np.full((n, w, w), constant, np.uint8)
    else:
        base = rng.integers(0, 256, (n, w + 2, w + 2)).astype(np.float32)
        base = (base[:, :-2, :-2] + base[:, 1:-1, 1:-1] + base[:, 2:, 2:]) / 3
        win = np.clip(base + rng.normal(0, 2, base.shape), 0, 255).astype(np.uint8)
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    src[: n // 2] = win[: n // 2, 3:3 + b, 4:4 + b]        # near the integer MV
    return src, win


def jax_costmap(b, n, seed, extra=0, constant=None):
    return jax_once((b, n, seed, extra, constant), lambda: jpallas.refine_qpel_costmap(
        *map(jnp.asarray, tiles(b, n, seed, extra, constant))))


@pytest.mark.parametrize("b,n", [(8, 40), (16, 20), (32, 5), (64, 3)])
def test_costmap_matches_jax(b, n):
    src, win = tiles(b, n, seed=b)
    want = jax_costmap(b, n, b)
    same(tpred.qpel_costmap(torch.as_tensor(src), torch.as_tensor(win)), want)
    same(costmap.refine_qpel_costmap_ref(src, win), want)
    assert len(np.unique(want.reshape(n, 16).argmin(-1))) > 1, "fractions should differ"


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_costmap_reads_only_the_top_left_window(b):
    # Wider windows than b + 7, as the TPU kernel's aligned slabs are.
    src, win = tiles(b, 4, seed=100 + b, extra=5)
    want = jax_costmap(b, 4, 100 + b, extra=5)
    same(costmap.refine_qpel_costmap_ref(src, win), want)
    same(costmap.refine_qpel_costmap_ref(src, win[:, :b + 7, :b + 7].copy()), want)


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_costmap_mxu_matches_jax(b):
    src, win = tiles(b, 6, seed=200 + b)
    preds, costs = tpred.refine_qpel_costmap_mxu(torch.as_tensor(src), torch.as_tensor(win))
    jpreds, jcosts = jxla.refine_qpel_costmap_mxu(jnp.asarray(src), jnp.asarray(win))
    same(preds, jpreds)
    same(costs, jcosts)
    same(costs.reshape(6, 4, 4), tpred.qpel_costmap(torch.as_tensor(src), torch.as_tensor(win)))


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_constant_windows_tie_every_fraction(b):
    src, win = tiles(b, 3, seed=300 + b, constant=97)
    want = jax_costmap(b, 3, 300 + b, constant=97)
    got = costmap.refine_qpel_costmap_ref(src, win)
    same(got, want)
    # Every filter row sums to 64, so every fraction predicts the constant.
    assert (got == got[:, :1, :1]).all()


def test_refine_qpel_picks_the_costmap_first_minimum():
    src, win = tiles(16, 12, seed=7)
    pred, frac, cost = tpred.refine_qpel(torch.as_tensor(src), torch.as_tensor(win))
    jpred_, jfrac, jcost = jxla.refine_quarter_pel_mxu(jnp.asarray(src), jnp.asarray(win))
    same(pred, jpred_)
    same(frac, jfrac)
    same(cost, jcost)


# ---- B13: windows read from the plane ------------------------------------------

def plane_case(b, n, seed, constant=None):
    """A plane, tiles, and window offsets: random, with the first at (0, 0)
    and the last at the largest start that fits."""
    rng = np.random.default_rng(seed)
    hp, wp = 96, 136
    plane = (np.full((hp, wp), constant, np.uint8) if constant is not None
             else rng.integers(0, 256, (hp, wp), dtype=np.uint8))
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    offs = np.stack([rng.integers(0, hp - b - 6, n), rng.integers(0, wp - b - 6, n)],
                    axis=-1).astype(np.int32)
    offs[0] = (0, 0)
    offs[-1] = (hp - b - 7, wp - b - 7)
    for i in range(1, n // 2):
        y, x = offs[i]
        src[i] = plane[y + 3:y + 3 + b, x + 3:x + 3 + b]
    return src, plane, offs


@pytest.mark.parametrize("b,n", [(8, 37), (16, 21), (32, 6)])
@pytest.mark.parametrize("constant", [None, 40])
def test_costmap_dma_matches_jax(b, n, constant):
    src, plane, offs = plane_case(b, n, seed=b + (constant or 0), constant=constant)
    jcost, jwin = jpallas.refine_qpel_costmap_dma(
        jnp.asarray(src), jnp.asarray(plane), jnp.asarray(offs))
    cost, win = costmap.refine_qpel_costmap_dma_ref(src, plane, offs)
    same(cost, jcost)
    same(win, np.asarray(jwin)[:, :b + 7, :b + 7])
    same(cost, costmap.refine_qpel_costmap_ref(src, win))
    if constant is not None:
        assert (cost == cost[:, :1, :1]).all()


def test_costmap_dma_clamps_starts_past_the_plane():
    src, plane, offs = plane_case(16, 4, seed=9)
    past = offs + np.int32(50)
    cost, win = costmap.refine_qpel_costmap_dma_ref(src, plane, past)
    y = np.clip(past[:, 0], 0, plane.shape[0] - 23)
    x = np.clip(past[:, 1], 0, plane.shape[1] - 23)
    want = np.stack([plane[a:a + 23, c:c + 23] for a, c in zip(y, x)])
    same(win, want)
    same(cost, tpred.qpel_costmap(torch.as_tensor(src), torch.as_tensor(want)))


def test_wrappers_run_the_plain_version_on_the_cpu():
    src, plane, offs = plane_case(8, 5, seed=11)
    before = (costmap.refine_qpel_costmap.launches, costmap.refine_qpel_costmap_dma.launches)
    cost, win = costmap.refine_qpel_costmap_dma(src, plane, offs)
    same(cost, costmap.refine_qpel_costmap_dma_ref(src, plane, offs)[0])
    same(costmap.refine_qpel_costmap(src, win), cost)
    assert (costmap.refine_qpel_costmap.launches,
            costmap.refine_qpel_costmap_dma.launches) == before
    assert registry.get("refine_qpel_costmap_dma", Tier.REF) is costmap.refine_qpel_costmap_dma_ref
    assert registry.get("refine_qpel_costmap", Tier.REF) is costmap.refine_qpel_costmap_ref


@pytest.mark.parametrize("call", [
    lambda: costmap.refine_qpel_costmap_ref(np.zeros((2, 24, 24), np.uint8),
                                            np.zeros((2, 31, 31), np.uint8)),
    lambda: costmap.refine_qpel_costmap_ref(np.zeros((2, 16, 16), np.uint8),
                                            np.zeros((2, 22, 23), np.uint8)),
    lambda: costmap.refine_qpel_costmap_dma_ref(np.zeros((2, 64, 64), np.uint8),
                                                np.zeros((80, 80), np.uint8),
                                                np.zeros((2, 2), np.int32)),
    lambda: costmap.refine_qpel_costmap_dma_ref(np.zeros((2, 8, 8), np.uint8),
                                                np.zeros((80, 80), np.uint8),
                                                np.zeros((3, 2), np.int32)),
])
def test_shapes_the_kernels_do_not_take_raise(call):
    with pytest.raises(ValueError):
        call()
