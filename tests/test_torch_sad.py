"""The SAD metric of hevcasm_tpu_torch against hevcasm_tpu on the CPU:
ops.sad (sad, sad_multiref, sad_grid) against hevcasm_tpu.ops.sad, the
plain version of kernel B9 (kernels.sad.sad_grid) against the JAX Pallas
sad_grid in interpret mode, and the registry's grid scorers by metric.  The
kernel itself is held against its plain version in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels import sad_pallas
from hevcasm_tpu.ops.sad import sad as jax_sad
from hevcasm_tpu.ops.sad import sad_grid as jax_sad_grid
from hevcasm_tpu.ops.sad import sad_multiref as jax_sad_multiref

from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import motion
from hevcasm_tpu_torch.kernels import sad as ksad
from hevcasm_tpu_torch.kernels import search
from hevcasm_tpu_torch.ops.sad import sad, sad_grid, sad_multiref


@pytest.fixture
def rng():
    return np.random.default_rng(0x5AD)


@pytest.mark.parametrize("shape", [(8, 8), (5, 16, 16), (2, 3, 64, 64), (4, 8, 16)])
def test_sad_matches_jax(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = rng.integers(0, 256, shape, dtype=np.uint8)
    got = sad(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sad(a, b)))


@pytest.mark.parametrize("lead,k,h,w", [((), 4, 8, 8), ((6,), 4, 16, 16), ((2, 3), 7, 8, 32)])
def test_sad_multiref_matches_jax(rng, lead, k, h, w):
    src = rng.integers(0, 256, (*lead, h, w), dtype=np.uint8)
    refs = rng.integers(0, 256, (*lead, k, h, w), dtype=np.uint8)
    got = sad_multiref(src, refs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (*lead, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sad_multiref(src, refs)))


@pytest.mark.parametrize("n,b,ndy,ndx,extra", [(4, 8, 17, 17, 0), (3, 16, 9, 33, 2),
                                               (2, 64, 7, 7, 1), (1, 32, 5, 3, 0)])
def test_sad_grid_matches_jax(rng, n, b, ndy, ndx, extra):
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (n, b + ndy - 1 + extra, b + ndx - 1 + extra), dtype=np.uint8)
    got = sad_grid(src, win, ndy, ndx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, ndy, ndx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sad_grid(src, win, ndy, ndx)))


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_sad_grid_takes_any_leading_axes_and_checks_the_window(rng, lead):
    src = rng.integers(0, 256, (*lead, 16, 16), dtype=np.uint8)
    win = rng.integers(0, 256, (*lead, 24, 24), dtype=np.uint8)
    got = sad_grid(src, win, 9, 9)
    assert tuple(got.shape) == (*lead, 9, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sad_grid(src, win, 9, 9)))
    with pytest.raises(ValueError, match="smaller"):
        sad_grid(src, win[..., :23, :], 9, 9)


@pytest.mark.parametrize("b,n,num", [(8, 5, 17), (16, 3, 9), (64, 2, 7)])
def test_plain_b9_matches_jax_kernel(rng, b, n, num):
    # hevcasm_tpu's Pallas kernel in interpret mode, as its own tests run it.
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (n, b + num - 1 + 3, b + num - 1 + 3), dtype=np.uint8)
    want = np.asarray(sad_pallas.sad_grid(jnp.asarray(src), jnp.asarray(win), num, num))
    got = ksad.sad_grid_ref(src, win, num, num)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_b9_constant_window_ties_every_candidate():
    src = np.full((3, 16, 16), 40, np.uint8)
    win = np.full((3, 32, 32), 97, np.uint8)
    got = ksad.sad_grid_ref(src, win, 17, 17)
    assert int(got.min()) == int(got.max()) == 256 * 57


def test_b9_wrapper_runs_the_plain_version_on_cpu_and_is_registered(rng):
    src = torch.as_tensor(rng.integers(0, 256, (4, 8, 8), dtype=np.uint8))
    win = torch.as_tensor(rng.integers(0, 256, (4, 24, 24), dtype=np.uint8))
    before = ksad.sad_grid.launches
    got = ksad.sad_grid(src, win, 17, 17)
    assert ksad.sad_grid.launches == before             # a CPU tensor launches nothing
    assert torch.equal(got, sad_grid(src, win, 17, 17))
    assert registry.get("sad_grid", Tier.REF) is sad_grid is ksad.sad_grid_ref
    assert registry.tiers_of("sad_grid") == Tier.REF | Tier.KERNEL
    for op in ("sad", "sad_multiref"):
        assert registry.tiers_of(op) == Tier.REF


@pytest.mark.parametrize("metric,op", [("sad", "sad_grid"), ("ssd", "ssd_grid")])
def test_grid_metric_fn_follows_the_metric_and_the_tiers(metric, op):
    assert motion.grid_metric_fn(metric, Tier.REF) is registry.get(op, Tier.REF)
    assert motion.grid_metric_fn(metric) is registry.get(op)
    kernel = {"sad": ksad.sad_grid, "ssd": search.ssd_grid}[metric]
    if torch.cuda.is_available():
        assert motion.grid_metric_fn(metric) is kernel
    with pytest.raises(RuntimeError, match=op):
        motion.grid_metric_fn(metric, Tier.NONE)
