"""hevcasm_tpu_torch's CUDA kernels on a card, each against its plain
PyTorch version, bit for bit.  Every test is marked ``cuda`` and skips where
torch.cuda.is_available() is false: a CUDA kernel has no CPU mode.

This file imports neither jax nor hevcasm_tpu, so it also runs on a machine
that has only PyTorch; tests/conftest.py imports jax, so there run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hevcasm_tpu_torch import Tier
from hevcasm_tpu_torch.encode import ctu as ctu_mod
from hevcasm_tpu_torch.encode import motion
from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
from hevcasm_tpu_torch.encode.video import (YuvFrame, encode_b_frame_yuv,
                                            encode_inter_frame_yuv)
from hevcasm_tpu_torch.kernels import bi_fused, inter_fused, search

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def random_u8(rng, shape, device):
    return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=device)


# ---- K1: ssd_grid_plane ------------------------------------------------------

@pytest.mark.parametrize("grid,r", [((2, 3), 8), ((3, 5), 32), ((1, 1), 1),
                                    ((2, 2), 17), ((17, 30), 32)])
def test_k1_matches_plain(cuda, grid, r):
    rng = np.random.default_rng(sum(grid) + r)
    gr, gc = grid
    plane = random_u8(rng, (gr * 64 + 2 * r, gc * 64 + 2 * r), cuda)
    src = random_u8(rng, (gr * gc, 64, 64), cuda)
    before = search.ssd_grid_plane.launches
    got = search.ssd_grid_plane(src, plane, grid, 2 * r + 1)
    assert search.ssd_grid_plane.launches == before + 1
    assert_bit_equal([got], [search.ssd_grid_plane_ref(src, plane, grid, 2 * r + 1)])


def test_k1_largest_sum_fits_int32(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    plane = torch.full((64 + 16, 128 + 16), 255, dtype=torch.uint8, device=cuda)
    got = search.ssd_grid_plane(src, plane, (1, 2), 17)
    assert int(got.min()) == int(got.max()) == 4096 * 255 * 255


def test_k1_rejects_what_it_does_not_take(cuda):
    src = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    plane = torch.zeros((64 + 16, 128 + 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        search.ssd_grid_plane(src.to(torch.int16), plane, (1, 2), 17)
    with pytest.raises(ValueError, match="contiguous"):
        search.ssd_grid_plane(src, plane[:, :-1], (1, 2), 17)


# ---- K2: inter_ctu_fused_dma -------------------------------------------------

def k2_case(seed, r, qp, h, w, device):
    """A random frame, the loop's padded plane, and refine offsets for random
    MVs with the first CTU at offset (0, 0) and the last at the maximum."""
    rng = np.random.default_rng(seed)
    src = ctu_mod.tile_frame(random_u8(rng, (h, w), device), 64).contiguous()
    plane = ctu_mod.pad_frame(random_u8(rng, (h, w), device), r + 3, r + 4, r + 3, r + 4)
    mvs = rng.integers(-r, r + 1, (src.shape[0], 2)).astype(np.int32)
    mvs[0], mvs[-1] = (-r, -r), (r, r)
    pos = motion.ctu_positions(h // 64, w // 64, 64, device)
    offsets = (pos + torch.as_tensor(mvs, device=device) + r).to(torch.int32).contiguous()
    cfg = EncodeConfig(qp=qp, inter_impl="fused_dma")
    return src, plane, offsets, (*cfg.quant_params(False), *cfg.dequant_params())


@pytest.mark.parametrize("seed,r,qp,h,w", [
    (13, 8, 32, 128, 192), (2, 32, 0, 256, 320), (7, 32, 22, 192, 128),
    (9, 32, 51, 1088, 1920)])
def test_k2_matches_plain(cuda, seed, r, qp, h, w):
    src, plane, offsets, qargs = k2_case(seed, r, qp, h, w, cuda)
    before = inter_fused.inter_ctu_fused_dma.launches
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert inter_fused.inter_ctu_fused_dma.launches == before + 1
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))


def test_k2_constant_plane_takes_the_first_fraction(cuda):
    src, plane, offsets, qargs = k2_case(4, 8, 32, 128, 192, cuda)
    plane = torch.full_like(plane, 97)
    got = inter_fused.inter_ctu_fused_dma(src, plane, offsets, *qargs)
    assert int(got[1].abs().max()) == 0              # every fraction ties
    assert_bit_equal(got, inter_fused.inter_ctu_fused_dma_ref(src, plane, offsets, *qargs))


def test_k2_rejects_what_it_does_not_take(cuda):
    src, plane, offsets, qargs = k2_case(1, 8, 32, 128, 192, cuda)
    with pytest.raises(TypeError):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets.long(), *qargs)
    with pytest.raises(ValueError, match="shift"):
        inter_fused.inter_ctu_fused_dma(src, plane, offsets, qargs[0], 15, *qargs[2:])


# ---- B3: bi_ctu_fused_dma ----------------------------------------------------

def b3_case(seed, r, qp, h, w, device, constant=False):
    """Two padded planes stacked by rows and refine offsets for random MVs,
    with the first CTU at offset 0 and the last at the maximum of each
    plane (offsets1 carries the lower plane's row offset)."""
    src, plane0, offsets0, qargs = k2_case(seed, r, qp, h, w, device)
    rng = np.random.default_rng(seed + 1)
    plane1 = ctu_mod.pad_frame(random_u8(rng, (h, w), device), r + 3, r + 4, r + 3, r + 4)
    if constant:
        plane0, plane1 = torch.full_like(plane0, 97), torch.full_like(plane1, 40)
    hp = plane0.shape[0]
    mvs = rng.integers(-r, r + 1, (src.shape[0], 2)).astype(np.int32)
    mvs[0], mvs[-1] = (-r, -r), (r, r)
    pos = motion.ctu_positions(h // 64, w // 64, 64, device)
    offsets1 = (pos + torch.as_tensor(mvs, device=device) + r
                + torch.tensor([hp, 0], dtype=torch.int32, device=device))
    flat = torch.cat([plane0, plane1]).contiguous()
    return src, flat, offsets0, offsets1.to(torch.int32).contiguous(), qargs


@pytest.mark.parametrize("seed,r,qp,h,w", [
    (13, 8, 32, 128, 192), (2, 32, 22, 256, 320), (7, 32, 37, 192, 128),
    (9, 32, 30, 1088, 1920)])
def test_b3_matches_plain(cuda, seed, r, qp, h, w):
    src, flat, off0, off1, qargs = b3_case(seed, r, qp, h, w, cuda)
    hp, wp = flat.shape[0] // 2, flat.shape[1]
    assert int(off0.min()) == 0 and tuple(off1[0].tolist()) == (hp, 0)
    assert tuple((off1[-1] + 71).tolist()) == (2 * hp, wp)
    before = bi_fused.bi_ctu_fused_dma.launches
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert bi_fused.bi_ctu_fused_dma.launches == before + 1
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_constant_planes_take_the_first_fractions(cuda):
    src, flat, off0, off1, qargs = b3_case(4, 8, 32, 128, 192, cuda, constant=True)
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert int(got[1].abs().max()) == int(got[2].abs().max()) == 0
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_clamps_starts_past_the_plane_like_the_plain_version(cuda):
    src, flat, off0, off1, qargs = b3_case(5, 8, 32, 128, 192, cuda)
    off1 = off1 + 9                                  # past the stacked plane's end
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert_bit_equal(got, bi_fused.bi_ctu_fused_dma_ref(src, flat, off0, off1, *qargs))


def test_b3_rejects_what_it_does_not_take(cuda):
    src, flat, off0, off1, qargs = b3_case(1, 8, 32, 128, 192, cuda)
    with pytest.raises(TypeError):
        bi_fused.bi_ctu_fused_dma(src, flat, off0, off1.long(), *qargs)
    with pytest.raises(ValueError, match="contiguous"):
        bi_fused.bi_ctu_fused_dma(src, flat[:, :-1], off0, off1, *qargs)


# ---- the slice -------------------------------------------------------------------

def pan_frames(h, w, seed=0):
    """A smooth picture panned by (2.25, 3.25) pixels, and the reference."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def picture(dy, dx):
        yy, xx = y + dy, x + dx
        v = 128 + 70 * np.sin(xx / 11 + yy / 17) + 40 * np.cos(xx / 23 - yy / 9)
        return np.clip(np.rint(v + rng.normal(0, 1.5, v.shape)), 0, 255).astype(np.uint8)

    return picture(2.25, 3.25), picture(0, 0)


@pytest.mark.parametrize("h,w,r", [(128, 256, 32), (128, 192, 8), (192, 320, 32)])
@pytest.mark.parametrize("impl", ["fused_dma", "stages"])
def test_card_matches_cpu(cuda, h, w, r, impl):
    cur, ref = pan_frames(h, w)
    kw = dict(refine_impl="ref", residual_impl="ref") if impl == "stages" else {}
    cfg = EncodeConfig(search_range=r, qp=32, inter_impl=impl, **kw)
    before = (search.ssd_grid_plane.launches, inter_fused.inter_ctu_fused_dma.launches)
    on_card = encode_inter_frame(torch.as_tensor(cur, device=cuda),
                                 torch.as_tensor(ref, device=cuda), cfg)
    assert search.ssd_grid_plane.launches == before[0] + 1
    assert inter_fused.inter_ctu_fused_dma.launches == before[1] + (impl == "fused_dma")
    on_cpu = encode_inter_frame(cur, ref, cfg, tiers=Tier.REF)
    for k in ("recon", "mvs", "sad", "nnz"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k
    assert abs(float(on_card["psnr_db"]) - float(on_cpu["psnr_db"])) <= 1e-3


def yuv_clip(h, w, device, seed=0):
    """(ref0, cur, ref1) 4:2:0 frames of a panned picture on ``device``."""
    frames = []
    for t in range(3):
        luma = pan_frames(h, w, seed)[0] if t == 1 else pan_frames(h, w, seed + t)[1]
        rng = np.random.default_rng(seed + 10 * t)
        chroma = [random_u8(rng, (h // 2, w // 2), device) for _ in range(2)]
        frames.append(YuvFrame(torch.as_tensor(luma, device=device), *chroma))
    return frames


@pytest.mark.parametrize("h,w,r", [(128, 192, 8), (192, 256, 32)])
@pytest.mark.parametrize("impl", ["fused_dma", "stages"])
@pytest.mark.parametrize("kind", ["P", "B"])
def test_yuv_frames_on_card_match_plain_and_cpu(cuda, h, w, r, impl, kind):
    ref0, cur, ref1 = yuv_clip(h, w, cuda)
    cfg = EncodeConfig(search_range=r, qp=32, inter_impl=impl)
    counts = (search.ssd_grid_plane, inter_fused.inter_ctu_fused_dma,
              bi_fused.bi_ctu_fused_dma)
    before = [k.launches for k in counts]

    def run(frames, **kw):
        if kind == "P":
            return encode_inter_frame_yuv(frames[1], frames[0], cfg, **kw)
        return encode_b_frame_yuv(frames[1], frames[0], frames[2], cfg, **kw)

    on_card = run((ref0, cur, ref1))
    fused = impl == "fused_dma"
    want = {"P": (1, fused, 0), "B": (2, 0, fused)}[kind]
    assert [k.launches - b for k, b in zip(counts, before)] == list(want)
    plain = run((ref0, cur, ref1), tiers=Tier.REF)
    on_cpu = run([YuvFrame(*(p.cpu() for p in f)) for f in (ref0, cur, ref1)])
    keys = [k for k in on_card if k != "recon" and not k.startswith("psnr")]
    for other in (plain, on_cpu):
        for a, b in zip(on_card["recon"], other["recon"]):
            assert torch.equal(a.cpu(), b.cpu())
        for k in keys:
            assert torch.equal(on_card[k].cpu(), other[k].cpu()), k
        for k in on_card:
            if k.startswith("psnr"):
                assert abs(float(on_card[k]) - float(other[k])) <= 1e-3, k
