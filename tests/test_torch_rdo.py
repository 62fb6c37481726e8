"""The RDO P frame end to end: hevcasm_tpu_torch's encode_inter_frame with
pu_decision and/or tu_sizes against hevcasm_tpu's on the CPU, on the same
numpy frames (128 x 192, a grid of 2 x 3 CTUs, two motions; and the 64 x 64
split-motion frames of tests/test_partition.py).  Every integer output must
be equal; psnr_db may differ by 1e-3 dB, since the two sum the float mean
in different orders and precisions.  test_torch_cuda.py runs the kernel
path on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode.loop import encode_inter_frame as jax_encode

from hevcasm_tpu_torch.encode import ctu as ctu_mod, motion, partition
from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
from hevcasm_tpu_torch.ops.ssd import ssd_grid

PSNR_TOL_DB = 1e-3
SIX = tuple(partition.PU_LAYOUTS)
TUS = (4, 8, 16, 32)
VARIANTS = {
    "pu": dict(pu_decision=True),
    "six": dict(pu_decision=True, pu_layouts=SIX),
    "tu": dict(tu_sizes=TUS),
    "pu+tu": dict(pu_decision=True, tu_sizes=TUS),
}


def frames(h=128, w=192, seed=0):
    """(cur, ref) uint8: smoothed noise moved by (5, 7) pixels, with the
    bottom-left quarter moved by (-3, 2) instead."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 80, w + 80)).astype(np.float32)
    base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3).astype(np.uint8)
    cur, ref = base[5:5 + h, 7:7 + w].copy(), base[:h, :w].copy()
    cur[h // 2:, : w // 2] = base[h // 2 - 3:h - 3, 2:2 + w // 2]
    return cur, ref


def split_motion(kind, seed=0x48455643):
    """tests/test_partition.py's 64 x 64 frames: the halves ("halves") or
    the quadrants ("quadrants") of one CTU moving differently."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (96, 96), dtype=np.uint8)
    ref = base[8:72, 8:72].copy()
    cur = np.zeros((64, 64), np.uint8)
    if kind == "halves":
        cur[:32] = base[12:44, 10:74]
        cur[32:] = base[35:67, 5:69]
    else:
        shifts = {(0, 0): (3, 2), (0, 1): (-4, 1), (1, 0): (2, -5), (1, 1): (-3, -3)}
        for (qi, qj), (dy, dx) in shifts.items():
            cur[32 * qi:32 * qi + 32, 32 * qj:32 * qj + 32] = base[
                8 + 32 * qi + dy:40 + 32 * qi + dy, 8 + 32 * qj + dx:40 + 32 * qj + dx]
    return cur, ref


_JAX = {}


def jax_result(key, cur, ref, **cfg):
    if key not in _JAX:
        out = jax_encode(jnp.asarray(cur), jnp.asarray(ref), JaxConfig(qp=32, **cfg))
        _JAX[key] = {k: np.asarray(v) for k, v in out.items()}
    return _JAX[key]


def assert_matches(ours, theirs, extra=()):
    """Every key of hevcasm_tpu's result equal; ``extra`` names the keys
    only the port returns."""
    assert set(ours) == set(theirs) | set(extra), (sorted(ours), sorted(theirs))
    for k, want in theirs.items():
        got = ours[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (k, got.shape, want.shape)
        if k == "psnr_db":
            assert abs(float(got) - float(want)) <= PSNR_TOL_DB
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rdo_frame_matches_jax(r, variant):
    cur, ref = frames()
    kw = dict(search_range=r, **VARIANTS[variant])
    ours = encode_inter_frame(cur, ref, EncodeConfig(qp=32, **kw), device="cpu")
    # hevcasm_tpu drops tu_choice when pu_decision is on; the port keeps it.
    extra = ("tu_choice",) if variant == "pu+tu" else ()
    assert_matches(ours, jax_result((r, variant), cur, ref, **kw), extra)
    if "pu_layout" in ours:
        assert len(np.unique(ours["pu_layout"].numpy())) > 1, "the layouts should differ"
    if "tu_choice" in ours:
        assert len(np.unique(ours["tu_choice"].numpy())) > 1, "the TU sizes should differ"


def test_pu_plus_tu_choice_is_the_tu_selection_of_the_pu_prediction():
    cur, ref = frames()
    cfg = EncodeConfig(search_range=8, qp=32, **VARIANTS["pu+tu"])
    ours = encode_inter_frame(cur, ref, cfg, device="cpu")
    src = ctu_mod.tile_frame(torch.as_tensor(cur), 64)
    pos = motion.ctu_positions(2, 3, 64)
    rp = ctu_mod.pad_frame(torch.as_tensor(ref), 11, 12, 11, 12)
    win = motion.extract_windows(rp, pos + motion.PAD_L, 80)
    pred, *_ = partition.select_pu_layout_pruned(src, rp, pos, win, 8, partition.mv_lambda(32),
                                                 cfg.pu_layouts, ssd_grid)
    _, choice, nnz = partition.select_tu_recon(src, pred, cfg, TUS)
    assert torch.equal(ours["tu_choice"], choice) and torch.equal(ours["nnz"], nnz)


@pytest.mark.parametrize("kwargs", [
    dict(inter_impl="fused_dma"),
    dict(me_strategy="pyramid"),
    dict(search_impl="grid", refine_impl="ref", fused_refine=True),
])
def test_pu_decision_ignores_the_other_implementation_fields(kwargs):
    cur, ref = frames()
    kw = dict(search_range=8, pu_decision=True, **kwargs)
    ours = encode_inter_frame(cur, ref, EncodeConfig(qp=32, **kw), device="cpu")
    if "fused_refine" in kwargs:      # hevcasm_tpu's default-config result stands in
        theirs = jax_result((8, "pu"), cur, ref, search_range=8, **VARIANTS["pu"])
    else:
        theirs = jax_result((8, "pu", tuple(kwargs.items())), cur, ref, **kw)
    assert_matches(ours, theirs)
    plain = encode_inter_frame(cur, ref, EncodeConfig(qp=32, search_range=8, pu_decision=True),
                               device="cpu")
    for k in ours:
        assert torch.equal(ours[k], plain[k]), k


@pytest.mark.parametrize("kwargs", [
    dict(tu_sizes=TUS, refine_impl="ref", fused_refine=True),
    dict(tu_sizes=(8,), inter_impl="fused_dma"),
])
def test_tu_sizes_refine_with_the_sweep_whatever_the_fields_say(kwargs):
    cur, ref = frames()
    kw = dict(search_range=8, **kwargs)
    ours = encode_inter_frame(cur, ref, EncodeConfig(qp=32, **kw), device="cpu")
    assert_matches(ours, jax_result((8, "tu", tuple(kwargs.items())), cur, ref, **kw))


def test_tu_sizes_other_than_8_with_a_fused_inter_impl_raise_in_both_packages():
    # select_tu_recon re-checks the configuration at each TU size, and the
    # fused compositions hardwire 8x8 TUs.
    cur, ref = frames(64, 64)
    kw = dict(search_range=8, tu_sizes=(8, 16), inter_impl="fused_dma")
    with pytest.raises(ValueError, match="hardwires 8x8"):
        jax_encode(jnp.asarray(cur), jnp.asarray(ref), JaxConfig(**kw))
    with pytest.raises(ValueError, match="hardwires 8x8"):
        encode_inter_frame(cur, ref, EncodeConfig(**kw), device="cpu")


@pytest.mark.parametrize("kind,want", [("halves", "2NxN"), ("quadrants", None)])
def test_split_motion_frames_match_jax(kind, want):
    cur, ref = split_motion(kind)
    kw = dict(search_range=8, pu_decision=True)
    ours = encode_inter_frame(cur, ref, EncodeConfig(qp=32, **kw), device="cpu")
    assert_matches(ours, jax_result(kind, cur, ref, **kw))
    chosen = EncodeConfig().pu_layouts[int(ours["pu_layout"][0])]
    assert chosen == want if want else chosen != "2Nx2N"
    assert float(ours["psnr_db"]) > 30.0


def test_whole_ctu_layout_alone_raises_value_error():
    # hevcasm_tpu reaches a bare assert in its cost-map kernel here; the port
    # names the limit.
    cur, ref = frames(64, 64)
    with pytest.raises(ValueError, match="up to 32"):
        encode_inter_frame(cur, ref, EncodeConfig(search_range=8, pu_decision=True,
                                                  pu_layouts=("2Nx2N",)), device="cpu")


def test_empty_layouts_raise_value_error_in_both_packages():
    cur, ref = frames(64, 64)
    with pytest.raises(ValueError):
        jax_encode(jnp.asarray(cur), jnp.asarray(ref),
                   JaxConfig(search_range=8, pu_decision=True, pu_layouts=()))
    with pytest.raises(ValueError):
        encode_inter_frame(cur, ref, EncodeConfig(search_range=8, pu_decision=True,
                                                  pu_layouts=()), device="cpu")


def test_unknown_layout_raises_value_error_in_both_packages():
    for config in (JaxConfig, EncodeConfig):
        with pytest.raises(ValueError, match="pu_layouts entry"):
            config(pu_layouts=("2Nx2N", "64x8"))


def test_pu_decision_codes_through_b4_under_residual_impl_pallas():
    # The 64x64 CTUs with 8x8 DCT TUs take kernel B4's route (its plain
    # version on the CPU); the integers are those of the default residual.
    cur, ref = frames()
    kw = dict(qp=32, search_range=8, pu_decision=True)
    ours = encode_inter_frame(cur, ref, EncodeConfig(residual_impl="pallas", **kw),
                              device="cpu")
    plain = encode_inter_frame(cur, ref, EncodeConfig(**kw), device="cpu")
    assert set(ours) == set(plain)
    for k in ours:
        assert torch.equal(ours[k], plain[k]), k


@pytest.mark.parametrize("kwargs", [
    dict(pu_decision=True, me_metric="sad", search_range=32),
    dict(pu_decision=True, me_metric="sad", search_range=8, pu_layouts=SIX),
    dict(tu_sizes=TUS, search_impl="mv", search_range=32),
    dict(tu_sizes=TUS, me_metric="sad", me_strategy="pyramid", search_range=16),
])
def test_rdo_search_configurations_match_jax(kwargs):
    # The PU decision under the SAD metric scores its sub-block grids in
    # B9's plain version (never B14/B15, which are SSD); the TU-size
    # selection searches by search_impl "mv" (B17) and by the SAD pyramid.
    cur, ref = frames()
    key = tuple(sorted(kwargs.items()))
    ours = encode_inter_frame(cur, ref, EncodeConfig(qp=32, **kwargs), device="cpu")
    assert_matches(ours, jax_result(key, cur, ref, **kwargs))
    choice = "pu_layout" if "pu_layout" in ours else "tu_choice"
    assert len(np.unique(ours[choice].numpy())) > 1


def test_cli_info_lists_the_partition_kernels(capsys):
    from hevcasm_tpu_torch.cli import main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    for op in ("refine_qpel_costmap", "refine_qpel_costmap_dma", "base_grids_ctu",
               "base_layout_decide"):
        assert any(line.split()[:1] == [op] and "KERNEL" in line
                   for line in out.splitlines()), op
