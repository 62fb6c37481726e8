"""Kernels K2, B16 and B11 of hevcasm_tpu_torch (inter_ctu_fused_dma and
inter_ctu_fused[_batched]: quarter-pel refine fused with the 8x8 residual
pipeline, windows read from the plane or gathered; refine_quarter_pel_fused:
the refinement alone): their plain versions against the JAX kernels in
interpret mode on the CPU, every output, with refine windows at offset 0
and at the maximum.  The kernels themselves are held against their plain
versions in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels.interp_pallas import inter_ctu_fused as jax_fused
from hevcasm_tpu.kernels.interp_pallas import inter_ctu_fused_batched as jax_fused_batched
from hevcasm_tpu.kernels.interp_pallas import inter_ctu_fused_dma as jax_fused_dma
from hevcasm_tpu.kernels.interp_pallas import refine_quarter_pel_fused as jax_refine_fused

import torch_testing  # noqa: F401
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import inter_fused



def case(seed, r, qp=32, h=128, w=192, content="shift"):
    """The setup of tests/test_inter_fused.py test_fused_dma_matches_fused:
    the loop's padded plane and refine offsets pos + mv + R for random MVs,
    with the first CTU at offset (0, 0) and the last at the maximum."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    cur = base[5:5 + h, 7:7 + w] if content == "shift" else \
        rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = base[:h, :w]
    src = np.asarray(jctu.tile_frame(jnp.asarray(cur), 64))
    plane = np.asarray(jctu.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4))
    gr, gc = h // 64, w // 64
    mvs = rng.integers(-r, r + 1, (gr * gc, 2)).astype(np.int32)
    mvs[0], mvs[-1] = (-r, -r), (r, r)
    offsets = np.asarray(jmotion.ctu_positions(gr, gc, 64)) + mvs + r
    cfg = EncodeConfig(qp=qp, inter_impl="fused_dma")
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    return src, plane, offsets.astype(np.int32), qargs


@pytest.mark.parametrize("seed,r,qp,content", [
    (13, 8, 32, "shift"), (21, 32, 22, "random"), (5, 8, 45, "random")])
def test_plain_k2_matches_jax_kernel(seed, r, qp, content):
    src, plane, offsets, qargs = case(seed, r, qp, content=content)
    assert offsets.min() == 0 and (offsets.max(axis=0) + 71 == plane.shape).all()
    want = jax_fused_dma(jnp.asarray(src), jnp.asarray(plane), jnp.asarray(offsets),
                         *qargs, group=6)
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    names = ("rec", "frac", "cost", "nnz", "bits")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_quant_params_match_jax_config():
    ours, theirs = EncodeConfig(qp=37, inter_impl="fused_dma"), \
        JaxConfig(qp=37, inter_impl="fused_dma")
    assert ours.quant_params(False) == theirs.quant_params(False)


def test_plain_k2_equals_refine_plus_residual():
    """The plain version is the staged composition: windows gathered at the
    offsets, ops.pred_inter.refine_qpel, then ops.residual.residual_pipeline."""
    from hevcasm_tpu_torch.ops.pred_inter import refine_qpel
    from hevcasm_tpu_torch.ops.residual import residual_pipeline

    src, plane, offsets, qargs = case(3, 8)
    rec, frac, cost, nnz, bits = inter_fused.inter_ctu_fused_dma(
        src, plane, offsets, *qargs)
    win = tmotion.extract_windows(plane, offsets, 71)
    pred, frac_s, cost_s = refine_qpel(src, win)
    rec_s, nnz_s, cbf = residual_pipeline(src, pred, *qargs)
    assert torch.equal(rec, rec_s) and torch.equal(frac, frac_s)
    assert torch.equal(cost, cost_s)
    assert int(nnz.sum()) == int(nnz_s)
    assert torch.equal((nnz > 0).reshape(-1), cbf)
    assert bool(((bits > 0) == (nnz > 0)).all()) and bool((bits >= 3 * nnz).all())


def test_k2_wrapper_checks():
    src, plane, offsets, qargs = case(1, 8)
    scale, shift, offset, dscale, dshift = qargs
    before = inter_fused.inter_ctu_fused_dma.launches
    inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert inter_fused.inter_ctu_fused_dma.launches == before
    with pytest.raises(ValueError, match="shift"):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets, scale, 30, offset,
                                        dscale, dshift)
    with pytest.raises(ValueError, match="offsets"):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets[:-1], *qargs)
    with pytest.raises(ValueError, match="src_ctus"):
        inter_fused.inter_ctu_fused_dma(src[:, :32], plane, offsets, *qargs)


NAMES = ("rec", "frac", "cost", "nnz", "bits")


def assert_equal_outputs(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def slabs(plane, offsets):
    """The (72, 128) slabs hevcasm_tpu's loop gathers for B16, from the
    plane padded so that no gather clamps (tests/test_inter_fused.py)."""
    padded = np.pad(plane, ((0, 9), (0, 121)), mode="edge")
    return np.stack([padded[y:y + 72, x:x + 128] for y, x in offsets])


@pytest.mark.parametrize("seed,r,qp", [(13, 8, 32), (21, 32, 22)])
def test_plain_b16_matches_jax_kernels(seed, r, qp):
    src, plane, offsets, qargs = case(seed, r, qp, content="random" if r == 32 else "shift")
    win = slabs(plane, offsets)
    want = jax_fused(jnp.asarray(src), jnp.asarray(win), *qargs)
    assert_equal_outputs(inter_fused.inter_ctu_fused(src, win, *qargs), want)
    # The port takes the used 71x71 windows as they are, too.
    assert_equal_outputs(inter_fused.inter_ctu_fused(src, win[:, :71, :71], *qargs), want)
    for group in (4, 6):                                # n = 6: a remainder, then exact
        theirs = jax_fused_batched(jnp.asarray(src), jnp.asarray(win), *qargs, group=group)
        assert_equal_outputs(inter_fused.inter_ctu_fused_batched(src, win, *qargs,
                                                                 group=group), theirs)


def test_b16_wrapper_checks_and_registry():
    src, plane, offsets, qargs = case(1, 8)
    win = slabs(plane, offsets)
    before = inter_fused.inter_ctu_fused.launches
    inter_fused.inter_ctu_fused_batched(src, win, *qargs, group=4)
    assert inter_fused.inter_ctu_fused.launches == before    # CPU: the plain version
    with pytest.raises(ValueError, match="windows"):
        inter_fused.inter_ctu_fused(src, win[:, :70], *qargs)
    with pytest.raises(ValueError, match="src"):
        inter_fused.inter_ctu_fused(src[:, :32, :32], win, *qargs)
    with pytest.raises(ValueError, match="shift"):
        inter_fused.inter_ctu_fused(src, win, qargs[0], 30, *qargs[2:])
    for op in ("inter_ctu_fused", "refine_quarter_pel_fused"):
        assert registry.tiers_of(op) == Tier.REF | Tier.KERNEL, op
    assert registry.get("inter_ctu_fused", Tier.REF) is inter_fused.inter_ctu_fused_ref


@pytest.mark.parametrize("b,n,extra", [(8, 5, 0), (16, 4, 3), (32, 3, 0), (64, 2, 9)])
def test_plain_b11_matches_jax_kernel(b, n, extra):
    rng = np.random.default_rng(b + n)
    base = rng.integers(0, 256, (n, b + 32, b + 32), dtype=np.uint8)
    src = base[:, 3:3 + b, 2:2 + b].copy()               # a (-1, -2) shift, so fractions
    win = base[:, :b + 7 + extra, :b + 7 + extra].copy()  # do work
    want = jax_refine_fused(jnp.asarray(src), jnp.asarray(win))
    got = inter_fused.refine_quarter_pel_fused(src, win)
    assert_equal_outputs(got, want, ("pred", "frac", "cost"))


def test_b11_wrapper_checks():
    src = np.zeros((2, 12, 12), np.uint8)
    with pytest.raises(ValueError, match="b in"):
        inter_fused.refine_quarter_pel_fused(src, np.zeros((2, 19, 19), np.uint8))
    with pytest.raises(ValueError, match="windows"):
        inter_fused.refine_quarter_pel_fused(np.zeros((2, 16, 16), np.uint8),
                                             np.zeros((2, 22, 23), np.uint8))
    before = inter_fused.refine_quarter_pel_fused.launches
    pred, frac, cost = inter_fused.refine_quarter_pel_fused(
        np.zeros((2, 16, 16), np.uint8), np.zeros((2, 23, 23), np.uint8))
    assert inter_fused.refine_quarter_pel_fused.launches == before
    assert tuple(pred.shape) == (2, 16, 16) and frac.tolist() == [0, 0]
