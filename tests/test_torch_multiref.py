"""The multi-reference P frame end to end: hevcasm_tpu_torch's
encode_inter_frame_multiref against hevcasm_tpu's on the CPU, on the
scenarios of tests/test_multiref.py.  recon, mvs, ref_idx and nnz must be
equal; psnr_db may differ by 1e-3 dB, since the two sum the float mean in
different orders and precisions.  hevcasm_tpu's Pallas kernels (B16, B11,
B4 and K2 under the fused configurations) run in interpret mode; the port
runs their plain versions, and at R <= 32 the plain version of B7, the
multi-plane search.  test_torch_cuda.py runs the kernels on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode.loop import encode_inter_frame_multiref as jax_multiref

from torch_testing import jax_once
from hevcasm_tpu_torch.encode import (EncodeConfig, encode_inter_frame,
                                      encode_inter_frame_multiref)

PSNR_TOL_DB = 1e-3
KEYS = ("recon", "mvs", "ref_idx", "nnz")


def split_refs(h=128, w=256, seed=1):
    """tests/test_multiref.py's first scenario: ref0 equals cur on the left
    half and is noisy on the right, ref1 the other way round."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = np.stack([cur, cur]).astype(np.int16)
    refs[0, :, w // 2:] += rng.integers(-60, 61, (h, w - w // 2)).astype(np.int16)
    refs[1, :, : w // 2] += rng.integers(-60, 61, (h, w // 2)).astype(np.int16)
    return cur, np.clip(refs, 0, 255).astype(np.uint8)


def shifted_refs(h=128, w=192, seed=2):
    """The third scenario: cur is noise moved by (5, 7); the references are
    the noise at three other offsets."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    cur = base[5:5 + h, 7:7 + w]
    refs = np.stack([base[:h, :w], base[9:9 + h, 2:2 + w], base[1:1 + h, 11:11 + w]])
    return cur.copy(), refs


def rolled_refs(h=128, w=128, seed=3):
    """The fourth scenario: four references, cur rolled by 1, 3, 5, 7
    columns with growing noise."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = []
    for s in (1, 3, 5, 7):
        r = np.roll(cur, s, axis=1).astype(np.int16)
        r += rng.integers(-20 - 4 * s, 21 + 4 * s, (h, w)).astype(np.int16)
        refs.append(np.clip(r, 0, 255).astype(np.uint8))
    return cur, np.stack(refs)


SCENES = {"split": split_refs, "shifted": shifted_refs, "rolled": rolled_refs}
def jax_result(scene, **kw):
    def run():
        cur, refs = SCENES[scene]()
        out = jax_multiref(jnp.asarray(cur), jnp.asarray(refs), JaxConfig(**kw))
        return {k: np.asarray(v) for k, v in out.items()}

    return jax_once((scene, tuple(sorted(kw.items()))), run)


def port_result(scene, **kw):
    cur, refs = SCENES[scene]()
    return encode_inter_frame_multiref(cur, refs, EncodeConfig(**kw), device="cpu")


def assert_matches(ours, theirs):
    assert set(ours) == set(theirs) == set(KEYS) | {"psnr_db"}
    for k in KEYS:
        got = ours[k].numpy()
        assert got.dtype == theirs[k].dtype and got.shape == theirs[k].shape, k
        np.testing.assert_array_equal(got, theirs[k], err_msg=k)
    assert ours["psnr_db"].dtype == torch.float32
    assert abs(float(ours["psnr_db"]) - float(theirs["psnr_db"])) <= PSNR_TOL_DB


def test_split_references_match_jax_and_split_left_right():
    kw = dict(search_range=4, qp=27)
    ours = port_result("split", **kw)
    assert_matches(ours, jax_result("split", **kw))
    ref_idx = ours["ref_idx"].numpy().reshape(2, 4)
    assert (ref_idx[:, :2] == 0).all() and (ref_idx[:, 2:] == 1).all(), ref_idx


def test_one_reference_equals_the_single_reference_frame():
    cur, refs = shifted_refs()
    cfg = EncodeConfig(search_range=8, qp=30)
    multi = encode_inter_frame_multiref(cur, refs[:1], cfg, device="cpu")
    single = encode_inter_frame(cur, refs[0], cfg, device="cpu")
    for k in ("recon", "mvs", "nnz"):
        assert torch.equal(multi[k], single[k]), k
    assert not multi["ref_idx"].any()
    theirs = jax_multiref(jnp.asarray(cur), jnp.asarray(refs[:1]),
                          JaxConfig(search_range=8, qp=30))
    assert_matches(multi, {k: np.asarray(v) for k, v in theirs.items()})


# The six inter configurations of the multiref frame, and the SAD metric.
CONFIGS = {
    "stages": dict(),
    "sad": dict(me_metric="sad"),
    "sad_fused_dma": dict(me_metric="sad", inter_impl="fused_dma"),
    "fused": dict(inter_impl="fused"),
    "fused_batched": dict(inter_impl="fused_batched", fused_group=4),
    "fused_dma": dict(inter_impl="fused_dma"),
    "fused_refine": dict(fused_refine=True),
    "residual_pallas": dict(residual_impl="pallas"),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_shifted_references_match_jax(config):
    kw = dict(search_range=8, qp=32, **CONFIGS[config])
    ours = port_result("shifted", **kw)
    assert_matches(ours, jax_result("shifted", **kw))
    assert len(np.unique(ours["ref_idx"].numpy())) > 1


def test_four_references_match_jax_and_never_lose_to_one():
    kw = dict(search_range=8, qp=30)
    ours = port_result("rolled", **kw)
    assert_matches(ours, jax_result("rolled", **kw))
    cur, refs = rolled_refs()
    one = encode_inter_frame_multiref(cur, refs[:1], EncodeConfig(**kw), device="cpu")
    assert float(ours["psnr_db"]) >= float(one["psnr_db"]) - 1e-6


def test_search_range_32_runs_the_multi_plane_route():
    # R = 32 with 64x64 CTUs takes B7's route (its plain version here);
    # hevcasm_tpu on the CPU takes its grid route.  The integers agree.
    kw = dict(search_range=32, qp=30)
    assert_matches(port_result("rolled", **kw), jax_result("rolled", **kw))


def test_mega_runs_the_staged_route_and_search_impl_is_ignored():
    kw = dict(search_range=8, qp=32)
    staged = port_result("shifted", **kw)
    for extra in (dict(inter_impl="mega"), dict(search_impl="grid")):
        ours = port_result("shifted", **kw, **extra)
        for k in KEYS:
            assert torch.equal(ours[k], staged[k]), (extra, k)
    assert_matches(port_result("shifted", inter_impl="mega", **kw),
                   jax_result("shifted", inter_impl="mega", **kw))


@pytest.mark.parametrize("kw,key", [
    (dict(me_strategy="pyramid"), "pyramid"),
    (dict(pu_decision=True), "fixed CTU/TU geometry"),
    (dict(tu_sizes=(8, 16)), "fixed CTU/TU geometry"),
])
def test_guards_raise_like_jax(kw, key):
    cur, refs = split_refs(64, 128)
    with pytest.raises(ValueError, match=key):
        jax_multiref(jnp.asarray(cur), jnp.asarray(refs), JaxConfig(search_range=4, **kw))
    with pytest.raises(ValueError, match=key):
        encode_inter_frame_multiref(cur, refs, EncodeConfig(search_range=4, **kw),
                                    device="cpu")


def test_sad_metric_matches_jax_and_slab_off_32_is_rejected():
    # The SAD metric takes full_search_multi's grid route (B9's plain
    # version here) in both packages.
    kw = dict(search_range=4, qp=27, me_metric="sad")
    assert_matches(port_result("split", **kw), jax_result("split", **kw))
    for config in (JaxConfig, EncodeConfig):
        with pytest.raises(ValueError, match="search_impl"):
            config(search_range=8, search_impl="slab")


def test_refs_must_be_a_stack_of_planes():
    cur, refs = split_refs(64, 128)
    with pytest.raises(ValueError, match="refs"):
        encode_inter_frame_multiref(cur, refs[0], EncodeConfig(search_range=4), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        encode_inter_frame_multiref(cur, refs[:, :, :64], EncodeConfig(search_range=4),
                                    device="cpu")
