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
from hevcasm_tpu_torch.kernels import inter_fused, search

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
