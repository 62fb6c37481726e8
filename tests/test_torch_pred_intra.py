"""hevcasm_tpu_torch's new REF ops against hevcasm_tpu's on the CPU, on the
same numpy inputs from a seed: intra prediction (every mode, n = 4 to 32,
filter_edge both ways, and the reference-sample substitution, smoothing
and filter decision), SATD and the linear SSD.  Every output is integer
and must be equal in value and dtype."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu import registry as jregistry
from hevcasm_tpu.config import Tier as JTier

from torch_testing import same
from hevcasm_tpu_torch import Tier, registry

# The ops packages export functions named like these modules.
jintra = importlib.import_module("hevcasm_tpu.ops.pred_intra")
jsatd = importlib.import_module("hevcasm_tpu.ops.satd")
jssd = importlib.import_module("hevcasm_tpu.ops.ssd")
tintra = importlib.import_module("hevcasm_tpu_torch.ops.pred_intra")
tsatd = importlib.import_module("hevcasm_tpu_torch.ops.satd")
tssd = importlib.import_module("hevcasm_tpu_torch.ops.ssd")

SELFTEST_MODES = (0, 1, 10, 26, 2, 18, 34, 23)


def neighbours(n, seed, lead=(3,)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (*lead, 2 * n), dtype=np.uint8),
            rng.integers(0, 256, (*lead, 2 * n), dtype=np.uint8),
            rng.integers(0, 256, lead, dtype=np.uint8))


@pytest.mark.parametrize("filter_edge", [False, True])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_pred_intra_matches_jax_at_the_selftest_modes(n, filter_edge):
    left, above, corner = neighbours(n, n)
    for mode in SELFTEST_MODES:
        want = jintra.pred_intra(mode, jnp.asarray(left), jnp.asarray(above),
                                 jnp.asarray(corner), n, filter_edge)
        same(tintra.pred_intra(mode, left, above, corner, n, filter_edge), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_all_modes_match_jax(n):
    left, above, corner = neighbours(n, 100 + n, lead=(2,))
    want = jintra.pred_intra_all_modes(jnp.asarray(left), jnp.asarray(above),
                                       jnp.asarray(corner), n)
    same(tintra.pred_intra_all_modes(left, above, corner, n), want)


@pytest.mark.parametrize("n", [4, 8, 32])
def test_angular_edge_filter_and_unbatched_blocks_match_jax(n):
    left, above, corner = neighbours(n, 200 + n, lead=())
    for mode in (10, 26, 11, 25, 2, 34):
        for fe in (False, True):
            want = jintra.pred_intra_angular(jnp.asarray(left), jnp.asarray(above),
                                             jnp.asarray(corner), n, mode, fe)
            same(tintra.pred_intra_angular(left, above, corner, n, mode, fe), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_reference_processing_matches_jax(n):
    left, above, corner = neighbours(n, 300 + n, lead=(5,))
    rng = np.random.default_rng(400 + n)
    la, aa = rng.random((5, 2 * n)) < 0.5, rng.random((5, 2 * n)) < 0.5
    ca = rng.random((5,)) < 0.5
    la[1], aa[1], ca[1] = False, False, False          # nothing available
    la[2], ca[2] = False, False                        # a leading unavailable run
    la[3], aa[3], ca[3] = True, True, True
    want = jintra.substitute_references(*map(jnp.asarray, (left, above, corner, la, aa, ca)))
    for o, t in zip(tintra.substitute_references(left, above, corner, la, aa, ca), want):
        same(o, t)
    strong = np.array([True, False, True, False, True]) if n == 32 else None
    want = jintra.filter_references(jnp.asarray(left), jnp.asarray(above), jnp.asarray(corner),
                                    n, None if strong is None else jnp.asarray(strong))
    for o, t in zip(tintra.filter_references(left, above, corner, n, strong), want):
        same(o, t)
    if n == 32:
        smooth = np.tile(np.arange(64, dtype=np.uint8), (5, 1))
        for l_, a_ in ((left, above), (smooth, smooth)):
            same(tintra.strong_smoothing_condition(l_, a_, corner),
                 jintra.strong_smoothing_condition(jnp.asarray(l_), jnp.asarray(a_),
                                                   jnp.asarray(corner)))
    for mode in range(35):
        assert tintra.filter_flag(mode, n) == jintra.filter_flag(mode, n), (mode, n)


@pytest.mark.parametrize("n,lead", [(2, (7,)), (4, (3, 2)), (8, ()), (8, (9,))])
def test_satd_matches_jax(n, lead):
    rng = np.random.default_rng(500 + n)
    a = rng.integers(0, 256, (*lead, n, n), dtype=np.uint8)
    b = rng.integers(0, 256, (*lead, n, n), dtype=np.uint8)
    same(tsatd.satd(a, b), jsatd.satd(jnp.asarray(a), jnp.asarray(b)))
    with pytest.raises(ValueError, match="2, 4, 8"):
        tsatd.satd(np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8))


@pytest.mark.parametrize("shape", [(0x200,), (3, 64), (2, 2, 17)])
def test_ssd_linear_matches_jax(shape):
    rng = np.random.default_rng(600 + len(shape))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = rng.integers(0, 256, shape, dtype=np.uint8)
    same(tssd.ssd_linear(a, b), jssd.ssd_linear(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["ssd_linear", "satd", "pred_intra"])
def test_registered_at_ref_as_in_jax(op):
    assert registry.tiers_of(op) == Tier.REF
    assert jregistry.tiers_of(op) & JTier.REF
