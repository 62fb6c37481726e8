"""The 4:2:0 RD P frame on the CPU: encode_inter_frame_yuv with pu_decision
(five layouts, or all six down to 8x8) and/or tu_sizes (4-32).  Its luma is
encode_inter_frame's RD frame on the same planes (tests/test_torch_rdo.py
holds that one against hevcasm_tpu): recon, mvs, pu_layout, tu_choice and
the luma part of nnz.  Its MV field is each base tile's PU MV as the
unpruned PU decision (partition.select_pu_layout) gives it, and its chroma
is the plain per-tile composition (kernels.chroma_fused.chroma_p_fused_ref
on that field).  Without pu_decision and tu_sizes the frame is the fixed
one it was: its outputs and keys are those of encode_inter_frame's luma and
chroma_p_fused_ref's chroma at one MV a CTU.  128 x 192 frames, R = 8,
content in which several layouts and TU sizes win; about a second."""

import numpy as np
import pytest
import torch

import torch_testing  # noqa: F401
from hevcasm_tpu_torch import Tier
from hevcasm_tpu_torch.encode import ctu as ctu_mod
from hevcasm_tpu_torch.encode import loop, motion, partition, video
from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
from hevcasm_tpu_torch.kernels import chroma_fused

H, W, R, QP = 128, 192, 8, 32
SIX = tuple(partition.PU_LAYOUTS)
TUS = (4, 8, 16, 32)
VARIANTS = {
    "five": dict(pu_decision=True),
    "six": dict(pu_decision=True, pu_layouts=SIX),
    "tu": dict(tu_sizes=TUS),
    "five+tu": dict(pu_decision=True, tu_sizes=TUS),
    "six+tu": dict(pu_decision=True, pu_layouts=SIX, tu_sizes=TUS),
}
SEEDS = (0, 2)
FIXED_KEYS = {"recon", "mvs", "nnz", "psnr_y", "psnr_cb", "psnr_cr"}


def frames(seed):
    """(cur, ref) YuvFrames of numpy planes: smoothed noise moved by (5, 7)
    luma pixels, the bottom-left quarter by (3, -2) and a strip of the top
    by (-2, -9) instead (chroma by half as much): several PU layouts and
    TU sizes win."""
    rng = np.random.default_rng(seed)

    def plane(h, w, s):
        base = rng.integers(0, 256, (h + 80, w + 80)).astype(np.float32)
        base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3).astype(np.uint8)
        cur, ref = base[5 // s:5 // s + h, 7 // s:7 // s + w].copy(), base[:h, :w].copy()
        cur[h // 2:, :w // 2] = base[h // 2 - 3 // s:h - 3 // s, 2 // s:2 // s + w // 2]
        cur[:h // 4, w // 2:w // 2 + w // 8] = base[2:2 + h // 4,
                                                   w // 2 + 9 // s:w // 2 + 9 // s + w // 8]
        return cur, ref

    planes = [plane(H, W, 1), plane(H // 2, W // 2, 2), plane(H // 2, W // 2, 2)]
    return video.YuvFrame(*(p[0] for p in planes)), video.YuvFrame(*(p[1] for p in planes))


_CODED = {}


def coded(variant, seed):
    """(cur, ref, cfg, the 4:2:0 frame's outputs, the luma frame's), once a
    test process."""
    if (variant, seed) not in _CODED:
        cur, ref = frames(seed)
        cfg = EncodeConfig(search_range=R, qp=QP, **VARIANTS[variant])
        _CODED[variant, seed] = (cur, ref, cfg,
                                 video.encode_inter_frame_yuv(cur, ref, cfg, device="cpu"),
                                 encode_inter_frame(cur.y, ref.y, cfg, device="cpu"))
    return _CODED[variant, seed]


def plain_chroma(cur, ref, mv, cfg):
    """(rec_cb, nnz_cb, rec_cr, nnz_cr) of the plain composition at MVs
    (n, 2) or an MV field (n, k, k, 2)."""
    planes = [torch.as_tensor(p) for p in (cur.cb, cur.cr, ref.cb, ref.cr)]
    return chroma_fused.chroma_p_fused_ref(*planes, mv, cfg)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_luma_equals_encode_inter_frame(variant, seed):
    cur, ref, cfg, out, luma = coded(variant, seed)
    decided = {k for k in ("pu_layout", "tu_choice") if k in luma}
    assert set(out) == FIXED_KEYS | {"mv_field"} | decided
    assert torch.equal(out["recon"].y, luma["recon"])
    assert torch.equal(out["mvs"], luma["mvs"])
    for key in decided:
        assert out[key].dtype == torch.int32 and torch.equal(out[key], luma[key]), key
    _, nnz_cb, _, nnz_cr = plain_chroma(cur, ref, out["mv_field"], cfg)
    assert out["nnz"].dtype == torch.int32
    assert int(out["nnz"]) - int(nnz_cb) - int(nnz_cr) == int(luma["nnz"])
    assert torch.equal(out["psnr_y"], luma["psnr_db"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chroma_is_the_plain_per_tile_composition(variant, seed):
    cur, ref, cfg, out, _ = coded(variant, seed)
    rec_cb, nnz_cb, rec_cr, nnz_cr = plain_chroma(cur, ref, out["mv_field"], cfg)
    assert torch.equal(out["recon"].cb, rec_cb) and torch.equal(out["recon"].cr, rec_cr)
    assert out["recon"].cb.dtype == torch.uint8 and out["recon"].cb.shape == (H // 2, W // 2)
    # Each PU's chroma at its own MV: a field with tiles at other MVs than
    # the top-left PU's codes other chroma than one MV a CTU would.
    if cfg.pu_decision and (out["mv_field"] != out["mvs"][:, None, None]).any():
        one = plain_chroma(cur, ref, out["mvs"], cfg)
        assert not (torch.equal(one[0], rec_cb) and torch.equal(one[2], rec_cr))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mv_field_is_each_base_tiles_pu_mv(variant, seed):
    cur, ref, cfg, out, _ = coded(variant, seed)
    field = out["mv_field"]
    n = (H // 64) * (W // 64)
    assert field.dtype == torch.int32
    if not cfg.pu_decision:
        assert torch.equal(field, out["mvs"][:, None, None])
        return
    base = partition.base_for(cfg.pu_layouts)
    k = 64 // base
    assert tuple(field.shape) == (n, k, k, 2)
    # The unpruned PU decision: every layout refined, then selected.
    cur_y, (ref_y,), src_ctus, pos, grid = loop._prepare_frame(
        cfg, torch.as_tensor(cur.y), torch.as_tensor(ref.y))
    ref_padded = loop._pad_reference(ref_y, R)
    windows = motion.extract_windows(ref_padded, pos + motion.PAD_L, 64 + 2 * R)
    _, choice, mvq, _ = partition.select_pu_layout(
        src_ctus, ref_padded, pos, windows, R, partition.mv_lambda(QP), cfg.pu_layouts,
        motion.grid_metric_fn("ssd", Tier.REF))
    assert torch.equal(choice, out["pu_layout"])
    table = partition._tile_pu_table(cfg.pu_layouts, base)
    for i in range(n):
        name = cfg.pu_layouts[int(choice[i])]
        want = mvq[name][i, table[int(choice[i])]].reshape(k, k, 2)
        assert torch.equal(field[i], want), (i, name)


@pytest.mark.parametrize("impl", ["stages", "fused_dma"])
def test_the_fixed_frame_is_unchanged(impl):
    cur, ref = frames(0)
    cfg = EncodeConfig(search_range=R, qp=QP, inter_impl=impl)
    out = video.encode_inter_frame_yuv(cur, ref, cfg, device="cpu")
    luma = encode_inter_frame(cur.y, ref.y, cfg, device="cpu")
    assert set(out) == FIXED_KEYS
    assert torch.equal(out["recon"].y, luma["recon"]) and torch.equal(out["mvs"], luma["mvs"])
    rec_cb, nnz_cb, rec_cr, nnz_cr = plain_chroma(cur, ref, luma["mvs"], cfg)
    assert torch.equal(out["recon"].cb, rec_cb) and torch.equal(out["recon"].cr, rec_cr)
    assert int(out["nnz"]) == int(luma["nnz"]) + int(nnz_cb) + int(nnz_cr)


def test_the_content_exercises_the_decisions():
    """Over the seeds, more than one layout of each set and more than one
    TU size win."""
    for variant, key in (("five", "pu_layout"), ("six", "pu_layout"), ("tu", "tu_choice"),
                         ("six+tu", "tu_choice")):
        won = {int(v) for seed in SEEDS for v in coded(variant, seed)[3][key]}
        assert len(won) > 1, (variant, won)


def test_the_rd_frame_raises_where_encode_inter_frame_does():
    cur, ref = frames(0)
    with pytest.raises(ValueError):
        video.encode_inter_frame_yuv(
            cur, ref, EncodeConfig(search_range=R, pu_decision=True, pu_layouts=("2Nx2N",)),
            device="cpu")
    with pytest.raises(ValueError):
        video.encode_inter_frame_yuv(
            cur, ref, EncodeConfig(search_range=R, pu_decision=True, pu_layouts=()),
            device="cpu")
