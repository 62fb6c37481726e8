"""The SAD metric of hevcasm_tpu_torch against hevcasm_tpu on the CPU:
ops.sad (sad, sad_multiref, sad_grid) against hevcasm_tpu.ops.sad, the
plain versions of kernels B9 (kernels.sad.sad_grid) and B10
(kernels.sad.sad / sad_multiref) against the JAX Pallas sad_grid, sad and
sad_multiref in interpret mode, the grid ops' 2-D and 4-D inputs (B8's and
B9's wrappers and the REF ssd_grid against JAX), and the registry's grid
scorers by metric.  The kernels themselves are held against their plain
versions in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels import sad_pallas
from hevcasm_tpu.kernels.xla_opt import ssd_grid_ref as jax_ssd_grid_ref
from hevcasm_tpu.ops.sad import sad as jax_sad
from hevcasm_tpu.ops.sad import sad_grid as jax_sad_grid
from hevcasm_tpu.ops.sad import sad_multiref as jax_sad_multiref

import torch_testing  # noqa: F401
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
        assert registry.tiers_of(op) == Tier.REF | Tier.KERNEL


@pytest.mark.parametrize("metric,op", [("sad", "sad_grid"), ("ssd", "ssd_grid")])
def test_grid_metric_fn_follows_the_metric_and_the_tiers(metric, op):
    assert motion.grid_metric_fn(metric, Tier.REF) is registry.get(op, Tier.REF)
    assert motion.grid_metric_fn(metric) is registry.get(op)
    kernel = {"sad": ksad.sad_grid, "ssd": search.ssd_grid}[metric]
    if torch.cuda.is_available():
        assert motion.grid_metric_fn(metric) is kernel
    with pytest.raises(RuntimeError, match=op):
        motion.grid_metric_fn(metric, Tier.NONE)


@pytest.mark.parametrize("n,h,w", [(5, 8, 4), (3, 12, 16), (2, 64, 48), (1, 4, 8)])
def test_plain_b10_sad_matches_jax_kernel(rng, n, h, w):
    src = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (n, h + 1, w + 1), dtype=np.uint8)[:, 1:, 1:]   # a view
    want = np.asarray(sad_pallas.sad(jnp.asarray(src), jnp.asarray(ref)))
    before = ksad.sad.launches
    got = ksad.sad(src, ref)
    assert ksad.sad.launches == before                   # a CPU tensor launches nothing
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    # 2-D input squeezes, as the TPU kernel's does.
    want0 = np.asarray(sad_pallas.sad(jnp.asarray(src[0]), jnp.asarray(ref[0])))
    got0 = ksad.sad(src[0], ref[0])
    assert got0.dim() == 0
    np.testing.assert_array_equal(got0.numpy(), want0)


@pytest.mark.parametrize("n,k,h,w", [(3, 4, 8, 16), (2, 1, 24, 32), (1, 7, 16, 12),
                                     (2, 4, 4, 8)])
def test_plain_b10_sad_multiref_matches_jax_kernel(rng, n, k, h, w):
    src = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    refs = rng.integers(0, 256, (n, k, h, w), dtype=np.uint8)
    want = np.asarray(sad_pallas.sad_multiref(jnp.asarray(src), jnp.asarray(refs)))
    got = ksad.sad_multiref(src, refs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # A 2-D src with (k, h, w) refs gives (k,), as the self-test calls it.
    want0 = np.asarray(sad_pallas.sad_multiref(jnp.asarray(src[0]), jnp.asarray(refs[0])))
    got0 = ksad.sad_multiref(src[0], refs[0])
    assert tuple(got0.shape) == (k,)
    np.testing.assert_array_equal(got0.numpy(), want0)


def test_b10_registered_at_kernel():
    assert registry._REGISTRY[("sad", Tier.KERNEL)] is ksad.sad
    assert registry._REGISTRY[("sad_multiref", Tier.KERNEL)] is ksad.sad_multiref
    assert ksad.sad_ref is sad and ksad.sad_multiref_ref is sad_multiref


@pytest.mark.parametrize("src_shape,win_shape", [((64, 64), (80, 80)), ((32, 32), (63, 65)),
                                                 ((2, 3, 16, 16), (2, 3, 40, 40))])
@pytest.mark.parametrize("op", ["ssd_grid", "sad_grid"])
def test_grid_ops_take_2d_and_4d_input_like_jax(rng, src_shape, win_shape, op):
    src = rng.integers(0, 256, src_shape, dtype=np.uint8)
    win = rng.integers(0, 256, win_shape, dtype=np.uint8)
    ndy, ndx = win_shape[-2] - src_shape[-2] + 1, win_shape[-1] - src_shape[-1] + 1
    if op == "ssd_grid":
        want = np.asarray(jax_ssd_grid_ref(jnp.asarray(src), jnp.asarray(win), ndy, ndx))
        fns = (registry.get("ssd_grid", Tier.REF), search.ssd_grid, search.ssd_grid_ref)
    else:
        want = np.asarray(jax_sad_grid(src, win, ndy, ndx))
        if len(src_shape) == 2:      # the TPU kernel takes (n, b, b) or (b, b)
            np.testing.assert_array_equal(
                np.asarray(sad_pallas.sad_grid(jnp.asarray(src), jnp.asarray(win), ndy, ndx)),
                want)
        fns = (registry.get("sad_grid", Tier.REF), ksad.sad_grid, ksad.sad_grid_ref)
    assert want.shape == (*src_shape[:-2], ndy, ndx)
    for fn in fns:
        got = fn(src, win, ndy, ndx)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape, fn
        np.testing.assert_array_equal(got.numpy(), want)
