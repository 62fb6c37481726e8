"""hevcasm_tpu_torch's plain ops against hevcasm_tpu's on the CPU, on the same
numpy inputs from a seed: CTU tiling and padding, interpolation and the
quarter-pel sweep, transforms, quantization and the residual pipeline.
Every output is integer and must be equal."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.ops import pred_inter as jpred
from hevcasm_tpu.ops import residual as jres
from hevcasm_tpu.ops import transform as jtr

import torch_testing  # noqa: F401
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.ops import pred_inter as tpred
from hevcasm_tpu_torch.ops import residual as tres
from hevcasm_tpu_torch.ops import transform as ttr
from hevcasm_tpu_torch.utils.psnr import psnr as tpsnr
from hevcasm_tpu.utils.psnr import psnr as jpsnr

# The ops packages export functions named like these modules.
jquant = importlib.import_module("hevcasm_tpu.ops.quantize")
jssd = importlib.import_module("hevcasm_tpu.ops.ssd")
tquant = importlib.import_module("hevcasm_tpu_torch.ops.quantize")
tssd = importlib.import_module("hevcasm_tpu_torch.ops.ssd")


def same(ours, theirs):
    """Equal values, shapes and dtypes."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


@pytest.fixture
def rng():
    return np.random.default_rng(0x70524F54)


# ---- ctu -------------------------------------------------------------------

@pytest.mark.parametrize("h,w,ctu", [(128, 192, 64), (64, 96, 32), (16, 8, 8)])
def test_tile_untile(rng, h, w, ctu):
    frame = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    tiles = tctu.tile_frame(torch.as_tensor(frame), ctu)
    same(tiles, jctu.tile_frame(jnp.asarray(frame), ctu))
    same(tctu.untile_frame(tiles, h, w), frame)
    assert tctu.grid_shape(h, w, ctu) == jctu.grid_shape(h, w, ctu)


@pytest.mark.parametrize("pads", [(35, 36, 35, 36), (11, 12, 11, 12), (0, 3, 5, 0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_pad_frame_replicates_edges(rng, pads, dtype):
    frame = rng.integers(0, 200, (40, 24)).astype(dtype)
    same(tctu.pad_frame(torch.as_tensor(frame), *pads),
         jctu.pad_frame(jnp.asarray(frame), *pads))


def test_pad_frame_batched(rng):
    frame = rng.integers(0, 256, (3, 16, 8), dtype=np.uint8)
    same(tctu.pad_frame(torch.as_tensor(frame), 4, 5, 6, 7),
         jctu.pad_frame(jnp.asarray(frame), 4, 5, 6, 7))


@pytest.mark.parametrize("sub", [4, 8, 16])
def test_split_merge_blocks(rng, sub):
    blocks = rng.integers(0, 256, (3, 32, 32), dtype=np.uint8)
    split = tctu.split_blocks(torch.as_tensor(blocks), sub)
    same(split, jctu.split_blocks(jnp.asarray(blocks), sub))
    same(tctu.merge_blocks(split, 32), blocks)


def test_grid_shape_rejects_partial_ctus():
    with pytest.raises(ValueError, match="multiple"):
        tctu.grid_shape(100, 128, 64)


# ---- interpolation and the quarter-pel sweep --------------------------------

@pytest.mark.parametrize("taps,fracs", [(8, [(0, 0), (1, 0), (0, 3), (2, 2), (3, 1)]),
                                        (4, [(0, 0), (5, 0), (0, 7), (4, 4), (1, 6)])])
def test_pred_uni(rng, taps, fracs):
    win = rng.integers(0, 256, (4, 16 + taps - 1, 8 + taps - 1), dtype=np.uint8)
    for xf, yf in fracs:
        same(tpred.pred_uni(torch.as_tensor(win), xf, yf, taps),
             jpred.pred_uni(jnp.asarray(win), xf, yf, taps))


def test_wrap16_matches_int16_cast():
    x = np.array([-2**20, -32769, -32768, -1, 0, 32767, 32768, 65535, 2**20 + 5],
                 dtype=np.int32)
    same(tpred._wrap16(torch.as_tensor(x)), jpred._wrap16(jnp.asarray(x)))


def test_qpel_score(rng):
    acc = rng.integers(-2**21, 2**21, (3, 16, 16), dtype=np.int32)
    src = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    same(tpred.qpel_score(torch.as_tensor(acc), torch.as_tensor(src)),
         jpred.qpel_score(jnp.asarray(acc), jnp.asarray(src)))


@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("content", ["random", "shifted"])
def test_refine_qpel(rng, b, content):
    n = 3
    win = rng.integers(0, 256, (n, b + 7, b + 7), dtype=np.uint8)
    if content == "random":
        src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    else:  # the block at the integer MV with a little noise: fraction 0 wins
        noise = rng.integers(-2, 3, (n, b, b))
        src = np.clip(win[:, 3:3 + b, 3:3 + b] + noise, 0, 255).astype(np.uint8)
    ours = tpred.refine_qpel(src, win)
    theirs = jpred.refine_qpel(jnp.asarray(src), jnp.asarray(win))
    for o, t in zip(ours, theirs):
        same(o, t)


def test_refine_qpel_ties_take_the_first_fraction():
    # A constant window gives every fraction the same accumulator.
    win = np.full((2, 23, 23), 77, dtype=np.uint8)
    src = np.full((2, 16, 16), 10, dtype=np.uint8)
    pred, frac, cost = tpred.refine_qpel(src, win)
    assert frac.tolist() == [0, 0]
    same(frac, jpred.refine_qpel(jnp.asarray(src), jnp.asarray(win))[1])


# ---- transforms -------------------------------------------------------------

@pytest.mark.parametrize("n,tr_type", [(4, 0), (4, 1), (8, 0), (16, 0), (32, 0)])
def test_transforms(rng, n, tr_type):
    res = rng.integers(-255, 256, (5, n, n)).astype(np.int16)
    coeffs = ttr.forward_transform(torch.as_tensor(res), tr_type)
    same(coeffs, jtr.forward_transform(jnp.asarray(res), tr_type))
    # Extreme coefficients exercise the int16 wrap and the inverse clips.
    big = rng.integers(-32768, 32768, (5, n, n)).astype(np.int16)
    same(ttr.forward_transform(torch.as_tensor(big), tr_type),
         jtr.forward_transform(jnp.asarray(big), tr_type))
    same(ttr.inverse_transform(torch.as_tensor(big), tr_type),
         jtr.inverse_transform(jnp.asarray(big), tr_type))
    pred = rng.integers(0, 256, (5, n, n), dtype=np.uint8)
    same(ttr.inverse_transform_add(torch.as_tensor(big), torch.as_tensor(pred), tr_type),
         jtr.inverse_transform_add(jnp.asarray(big), jnp.asarray(pred), tr_type))


def test_transform_rejects_bad_sizes():
    with pytest.raises(ValueError):
        ttr.dct_matrix(64)
    with pytest.raises(ValueError):
        ttr.forward_transform(torch.zeros((1, 8, 8), dtype=torch.int16), tr_type=1)


# ---- quantization -----------------------------------------------------------

@pytest.mark.parametrize("qp,intra", [(0, False), (22, True), (32, False), (51, True)])
def test_quantize_family(rng, qp, intra):
    from hevcasm_tpu_torch.encode.loop import EncodeConfig

    cfg = EncodeConfig(qp=qp)
    scale, shift, offset = cfg.quant_params(intra)
    dscale, dshift = cfg.dequant_params()
    coeffs = rng.integers(-32768, 32768, (6, 8, 8)).astype(np.int16)
    coeffs[0] = 0                                      # a block with cbf false
    ours = tquant.quantize(torch.as_tensor(coeffs), scale, shift, offset)
    theirs = jquant.quantize(jnp.asarray(coeffs), scale, shift, offset)
    same(ours[0], theirs[0])
    same(ours[1], theirs[1])
    same(tquant.quantize_inverse(ours[0], dscale, dshift),
         jquant.quantize_inverse(theirs[0], dscale, dshift))
    pred = rng.integers(0, 256, (6, 8, 8), dtype=np.uint8)
    res = rng.integers(-600, 600, (6, 8, 8)).astype(np.int16)
    same(tquant.reconstruct(torch.as_tensor(pred), torch.as_tensor(res)),
         jquant.reconstruct(jnp.asarray(pred), jnp.asarray(res)))


@pytest.mark.parametrize("scale,shift,offset", [
    (0, 20, 100), (0x8000, 20, 100), (100, 15, 100), (100, 28, 100),
    (100, 20, -1), (100, 20, 0x8000), (np.array([100, 0]), 20, 100),
])
def test_quantize_range_checks(scale, shift, offset):
    coeffs = np.zeros((2, 4, 4), dtype=np.int16)
    with pytest.raises(ValueError) as theirs:
        jquant.quantize(jnp.asarray(coeffs), scale, shift, offset)
    with pytest.raises(ValueError) as ours:
        tquant.quantize(torch.as_tensor(coeffs), scale, shift, offset)
    assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]


# ---- residual pipeline ------------------------------------------------------

@pytest.mark.parametrize("tu,tr_type", [(4, 0), (4, 1), (8, 0), (16, 0), (32, 0)])
def test_residual_pipeline(rng, tu, tr_type):
    from hevcasm_tpu_torch.encode.loop import EncodeConfig

    cfg = EncodeConfig(tu=tu, qp=27)
    scale, shift, offset = cfg.quant_params(tr_type == 1)
    dscale, dshift = cfg.dequant_params()
    src = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    pred = np.clip(src.astype(np.int16) + rng.integers(-40, 41, src.shape), 0, 255
                   ).astype(np.uint8)
    args = (scale, shift, offset, dscale, dshift)
    ours = tres.residual_pipeline(src, pred, *args, tu=tu, tr_type=tr_type)
    theirs = jres.residual_pipeline(jnp.asarray(src), jnp.asarray(pred), *args,
                                    tu=tu, tr_type=tr_type)
    for o, t in zip(ours, theirs):
        same(o, t)


def test_bits_egk():
    q = np.array([0, 1, -1, 2, 3, -4, 7, 8, 255, -256, 32767, -32768], dtype=np.int16)
    want = [0 if v == 0 else 2 * (abs(int(v)).bit_length() - 1) + 3 for v in q]
    assert tres.bits_egk(torch.as_tensor(q)).tolist() == want


# ---- ssd and psnr ------------------------------------------------------------

def test_ssd(rng):
    a = rng.integers(0, 256, (4, 64, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (4, 64, 64), dtype=np.uint8)
    same(tssd.ssd(a, b), jssd.ssd(jnp.asarray(a), jnp.asarray(b)))


def test_psnr(rng):
    a = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-3, 4, a.shape), 0, 255).astype(np.uint8)
    ours = tpsnr(torch.as_tensor(a), torch.as_tensor(b))
    assert ours.dtype == torch.float32
    assert abs(float(ours) - float(jpsnr(jnp.asarray(a), jnp.asarray(b)))) < 1e-3


# ---- registry ----------------------------------------------------------------

def test_registry_dispatch_on_this_machine():
    from hevcasm_tpu_torch.kernels import search

    assert registry.tiers_of("ssd_grid_plane") == Tier.REF | Tier.KERNEL
    # B4 and B11 are also the KERNEL tiers of residual_pipeline and
    # refine_qpel, as hevcasm_tpu registers them as those ops' PALLAS tiers.
    assert registry.tiers_of("residual_pipeline") == Tier.REF | Tier.KERNEL
    assert registry.tiers_of("refine_qpel") == Tier.REF | Tier.KERNEL
    assert registry.tiers_of("quantize") == Tier.REF
    assert registry.get("ssd_grid_plane", Tier.REF) is search.ssd_grid_plane_ref
    table = registry.populate()
    assert set(table) == set(registry.ops())
    if torch.cuda.is_available():
        assert registry.get("ssd_grid_plane") is search.ssd_grid_plane
    else:
        # No card: the KERNEL tier is unavailable and lookups fall to REF.
        assert registry.get_tier("ssd_grid_plane", Tier.KERNEL) is None
        assert registry.get("ssd_grid_plane") is search.ssd_grid_plane_ref
    assert registry.get("no_such_op") is None


def test_cli_info(capsys):
    from hevcasm_tpu_torch.cli import main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "ssd_grid_plane" in out and "inter_ctu_fused_dma" in out
