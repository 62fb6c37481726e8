"""The plain versions of kernels B5 and B6 (kernels.mc on CPU tensors)
against hevcasm_tpu's Pallas pred_uni_pallas / pred_bi_pallas in interpret
mode, as tests/test_mc_pallas.py runs them: both filter families, every
fraction (as ints and as per-block arrays), h = 2, leading axes, and the
wrappers' checks.  The kernels themselves are held against their plain
versions in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels.mc_pallas import pred_bi_pallas, pred_uni_pallas

import torch_testing  # noqa: F401
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.kernels import mc
from hevcasm_tpu_torch.ops import pred_inter

PHASES = {8: 4, 4: 8}


@pytest.fixture
def rng():
    return np.random.default_rng(0xB5B6)


def all_fractions(taps):
    """(xf, yf) per block: every pair of the family's fractions."""
    p = PHASES[taps]
    xf, yf = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    return xf.reshape(-1).astype(np.int32), yf.reshape(-1).astype(np.int32)


@pytest.mark.parametrize("taps,w,h", [(8, 16, 8), (8, 8, 4), (4, 8, 2), (4, 12, 6)])
def test_b5_plain_matches_jax_at_every_fraction(rng, taps, w, h):
    xf, yf = all_fractions(taps)
    win = rng.integers(0, 256, (xf.size, h + taps - 1, w + taps - 1), dtype=np.uint8)
    want = np.asarray(pred_uni_pallas(jnp.asarray(win), jnp.asarray(xf), jnp.asarray(yf),
                                      taps=taps))
    before = mc.pred_uni.launches
    got = mc.pred_uni(win, xf, yf, taps)
    assert mc.pred_uni.launches == before             # a CPU tensor launches nothing
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    got_b = mc.pred_uni_batched(torch.as_tensor(win), torch.as_tensor(xf), torch.as_tensor(yf),
                                h, w, taps)
    np.testing.assert_array_equal(got_b.numpy(), want)


@pytest.mark.parametrize("taps,xf,yf", [(8, 0, 0), (8, 3, 1), (4, 7, 0), (4, 2, 5)])
def test_b5_int_fractions_and_leading_axes(rng, taps, xf, yf):
    win = rng.integers(0, 256, (2, 3, 4 + taps - 1, 8 + taps - 1), dtype=np.uint8)
    want = np.asarray(pred_uni_pallas(jnp.asarray(win), xf, yf, taps=taps))
    got = mc.pred_uni(win, xf, yf, taps)
    assert tuple(got.shape) == (2, 3, 4, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # One fraction per block of the flattened leading axes, as JAX takes them.
    xfs = rng.integers(0, PHASES[taps], (6,)).astype(np.int32)
    want = np.asarray(pred_uni_pallas(jnp.asarray(win), jnp.asarray(xfs), yf, taps=taps))
    np.testing.assert_array_equal(mc.pred_uni(win, xfs, yf, taps).numpy(), want)


@pytest.mark.parametrize("taps,w,h", [(8, 16, 16), (8, 8, 4), (4, 8, 2), (4, 16, 16)])
def test_b6_plain_matches_jax_at_every_fraction(rng, taps, w, h):
    xf, yf = all_fractions(taps)
    n = xf.size
    w0 = rng.integers(0, 256, (n, h + taps - 1, w + taps - 1), dtype=np.uint8)
    w1 = rng.integers(0, 256, (n, h + taps - 1, w + taps - 1), dtype=np.uint8)
    xf1, yf1 = np.roll(xf, 3), np.roll(yf, 5)
    fr = [jnp.asarray(f) for f in (xf, yf, xf1, yf1)]
    want = np.asarray(pred_bi_pallas(jnp.asarray(w0), jnp.asarray(w1), *fr, taps=taps))
    before = mc.pred_bi.launches
    got = mc.pred_bi(w0, w1, xf, yf, xf1, yf1, taps)
    assert mc.pred_bi.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    got_b = mc.pred_bi_batched(w0, w1, xf, yf, xf1, yf1, h, w, taps)
    np.testing.assert_array_equal(got_b.numpy(), want)


@pytest.mark.parametrize("taps,fr", [(8, (0, 0, 0, 0)), (8, (1, 2, 3, 1)), (4, (1, 2, 3, 1)),
                                     (4, (7, 6, 0, 5))])
def test_b6_int_fractions_and_leading_axes(rng, taps, fr):
    shape = (3, 2, 2 + taps - 1, 4 + taps - 1)
    w0 = rng.integers(0, 256, shape, dtype=np.uint8)
    w1 = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(pred_bi_pallas(jnp.asarray(w0), jnp.asarray(w1), *fr, taps=taps))
    got = mc.pred_bi(w0, w1, *fr, taps)
    assert tuple(got.shape) == (3, 2, 2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_plain_reads_the_top_left_of_larger_windows(rng):
    win = rng.integers(0, 256, (4, 20, 30), dtype=np.uint8)
    got = mc.pred_uni_batched(win, 2, 1, 8, 16)
    want = pred_inter.pred_uni(win[:, :15, :23], 2, 1)
    assert torch.equal(got, want)
    w1 = rng.integers(0, 256, (4, 20, 30), dtype=np.uint8)
    got = mc.pred_bi_batched(win, w1, 1, 5, 7, 2, 12, 20, taps=4)
    assert torch.equal(got, pred_inter.pred_bi(win[:, :15, :23], w1[:, :15, :23], 1, 5, 7, 2,
                                               taps=4))


def test_wrappers_check_what_they_take(rng):
    win = torch.as_tensor(rng.integers(0, 256, (2, 11, 15), dtype=np.uint8))
    with pytest.raises(ValueError, match="taps"):
        mc.pred_uni(win, 0, 0, taps=6)
    with pytest.raises(ValueError, match="windows must be"):
        mc.pred_uni_batched(win, 0, 0, 8, 16)
    with pytest.raises(ValueError, match="windows must be"):
        mc.pred_bi_batched(win, win, 0, 0, 0, 0, 4, 9)
    with pytest.raises(ValueError, match="differ"):
        mc.pred_bi(win, win[:, :10], 0, 0, 0, 0)


def test_registered_at_ref_and_kernel():
    for op, fn in (("pred_uni", mc.pred_uni), ("pred_bi", mc.pred_bi)):
        assert registry.tiers_of(op) == Tier.REF | Tier.KERNEL
        assert registry._REGISTRY[(op, Tier.KERNEL)] is fn
        assert registry._REGISTRY[(op, Tier.REF)] is getattr(pred_inter, op)
    assert mc.pred_uni_ref is pred_inter.pred_uni and mc.pred_bi_ref is pred_inter.pred_bi
