"""The slice end to end: hevcasm_tpu_torch's 4:2:0 P and B frames
(encode_inter_frame_yuv, encode_b_frame_yuv) against hevcasm_tpu's on the
CPU, on the same numpy frames: 128x192 (a 2x3 CTU grid, odd width), R = 8.
recon (y, cb, cr), mvs / mvs0 / mvs1 and nnz must be equal; PSNR may differ
by 1e-3 dB, since the two sum the float means in different orders.  A
configuration hevcasm_tpu rejects must raise the same exception type in the
port.  test_torch_cuda.py runs the kernel path on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode.loop import encode_inter_frame as jax_encode
from hevcasm_tpu.encode.video import YuvFrame as JaxYuv
from hevcasm_tpu.encode.video import chroma_qp as jax_chroma_qp
from hevcasm_tpu.encode.video import encode_b_frame_yuv as jax_b
from hevcasm_tpu.encode.video import encode_inter_frame_yuv as jax_p

from torch_testing import jax_once, smooth_plane
from hevcasm_tpu_torch.encode import (EncodeConfig, YuvFrame, chroma_qp,
                                      encode_b_frame_yuv, encode_inter_frame,
                                      encode_inter_frame_yuv)
from hevcasm_tpu_torch.encode.video import _b_frame_luma

H, W = 128, 192
PSNR_TOL_DB = 1e-3
PSNR_KEYS = {"P": ("psnr_y", "psnr_cb", "psnr_cr"), "B": ("psnr_y",)}
INT_KEYS = {"P": ("mvs", "nnz"), "B": ("mvs0", "mvs1", "nnz")}


def clip(w=W, seed=0):
    """Three 4:2:0 frames (ref0, cur, ref1) as numpy planes: a smooth
    picture with a little noise, panned by (2.25, 3.25) luma pixels a frame
    (half that on chroma), so the MVs need quarter-pel fractions."""
    rng = np.random.default_rng(seed)

    def frame(t):
        dy, dx = 2.25 * t, 3.25 * t
        return (smooth_plane(H, w, dy, dx, rng),
                smooth_plane(H // 2, w // 2, dy / 2, dx / 2, rng, fy=7, fx=5),
                smooth_plane(H // 2, w // 2, dy / 2, dx / 2, rng, fy=5, fx=9))

    return frame(0), frame(1), frame(2)


def run_jax(kind, w=W, **kw):
    ref0, cur, ref1 = (JaxYuv(*map(jnp.asarray, f)) for f in clip(w))
    cfg = JaxConfig(**kw)
    out = jax_p(cur, ref0, cfg) if kind == "P" else jax_b(cur, ref0, ref1, cfg)
    return {k: (tuple(np.asarray(p) for p in v) if k == "recon" else np.asarray(v))
            for k, v in out.items()}


def run_port(kind, w=W, **kw):
    ref0, cur, ref1 = clip(w)
    cfg = EncodeConfig(**kw)
    if kind == "P":
        return encode_inter_frame_yuv(cur, ref0, cfg, device="cpu")
    return encode_b_frame_yuv(YuvFrame(*cur), ref0, ref1, cfg, device="cpu")


def jax_result(kind, **kw):
    return jax_once((kind, tuple(sorted(kw.items()))), lambda: run_jax(kind, **kw))


def assert_matches(kind, ours, theirs):
    assert isinstance(ours["recon"], YuvFrame)
    for plane, o, t in zip("y cb cr".split(), ours["recon"], theirs["recon"]):
        assert o.dtype == torch.uint8 and tuple(o.shape) == t.shape, plane
        np.testing.assert_array_equal(o.numpy(), t, err_msg=plane)
    for k in INT_KEYS[kind]:
        got = ours[k].numpy()
        assert got.dtype == theirs[k].dtype and got.shape == theirs[k].shape, k
        np.testing.assert_array_equal(got, theirs[k], err_msg=k)
    for k in PSNR_KEYS[kind]:
        assert ours[k].dtype == torch.float32
        assert abs(float(ours[k]) - float(theirs[k])) <= PSNR_TOL_DB, k
    assert set(ours) == set(theirs)


CONFIGS = {
    "defaults": dict(search_range=8, qp=27),
    "fused_dma": dict(search_range=8, qp=27, inter_impl="fused_dma"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["P", "B"])
def test_yuv_frame_matches_jax(kind, config):
    kw = CONFIGS[config]
    assert_matches(kind, run_port(kind, **kw), jax_result(kind, **kw))


def test_b_frame_fused_matches_jax():
    # "fused" runs the same bi kernel as "fused_dma" in hevcasm_tpu.
    kw = dict(search_range=8, qp=27, inter_impl="fused")
    assert_matches("B", run_port("B", **kw), jax_result("B", **kw))


def test_the_panned_clip_needs_fractions():
    theirs = jax_result("B", **CONFIGS["defaults"])
    assert ((theirs["mvs0"] % 4) != 0).any() or ((theirs["mvs1"] % 4) != 0).any()
    assert (theirs["mvs0"] != theirs["mvs1"]).any()
    assert (theirs["mvs1"] < 0).all(), "chroma MC should see negative MVs"


@pytest.mark.parametrize("kind,kw", [
    # hevcasm_tpu's yuv P frame runs the staged luma path under "mega".
    ("P", dict(search_range=8, qp=27, inter_impl="mega")),
    # luma on the fused kernel, chroma (4x4 TUs) on the plain pipeline.
    ("P", dict(search_range=8, qp=30, inter_impl="fused_dma", residual_impl="pallas")),
    ("B", dict(search_range=8, qp=30, inter_impl="fused_dma", residual_impl="pallas")),
    # The B frame ignores pu_decision and tu_sizes, as hevcasm_tpu does.
    ("B", dict(search_range=8, qp=37, pu_decision=True, tu_sizes=(8, 16))),
    ("B", dict(search_range=8, qp=22, me_strategy="pyramid", refine_impl="ref",
               residual_impl="ref")),
])
def test_accepted_configurations_match_jax(kind, kw):
    assert_matches(kind, run_port(kind, **kw), run_jax(kind, **kw))


@pytest.mark.parametrize("entry", ["luma", "P", "B"])
def test_literal_defaults_match_jax(entry):
    """EncodeConfig() as it stands (R = 32, stages, mxu refine and
    residual) runs every entry point of the slice."""
    if entry == "luma":
        ref0, cur, _ = clip()
        ours = encode_inter_frame(cur[0], ref0[0], device="cpu")
        theirs = jax_encode(jnp.asarray(cur[0]), jnp.asarray(ref0[0]), JaxConfig())
        for k in ("recon", "mvs", "sad", "nnz"):
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
        assert abs(float(ours["psnr_db"]) - float(theirs["psnr_db"])) <= PSNR_TOL_DB
    else:
        assert_matches(entry, run_port(entry), jax_result(entry))


@pytest.mark.parametrize("kind,kw", [
    # B16 on the P frame's luma (B3 serves the B frame under "fused").
    ("P", dict(search_range=8, qp=27, inter_impl="fused")),
    ("P", dict(search_range=8, qp=27, inter_impl="fused_batched", fused_group=4)),
    # B11 on the P frame's luma; the B frame refines with the sweep.
    ("P", dict(search_range=8, qp=27, fused_refine=True)),
    # B4 on the 64x64 luma CTUs; chroma's 4x4 TUs take the plain pipeline.
    ("P", dict(search_range=8, qp=27, residual_impl="pallas")),
    ("B", dict(search_range=8, qp=27, residual_impl="pallas")),
    ("B", dict(search_range=8, qp=27, inter_impl="stages", residual_impl="pallas",
               fused_refine=True)),
    # The grid search of both references in one call: the port's
    # multi-plane route (B7's plain version here).
    ("B", dict(search_range=8, qp=27, search_impl="grid")),
    ("B", dict(search_range=8, qp=27, search_impl="grid", inter_impl="fused_dma")),
])
def test_ported_kernel_configurations_match_jax(kind, kw):
    assert_matches(kind, run_port(kind, **kw), jax_result(kind, **kw))


def test_yuv_numpy_input_needs_a_card_or_an_explicit_cpu():
    ref0, cur, ref1 = clip()
    cfg = EncodeConfig(search_range=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode_inter_frame_yuv(cur, ref0, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode_b_frame_yuv(cur, ref0, ref1, cfg)
    tensors = YuvFrame(*(torch.as_tensor(p) for p in cur))
    out = encode_inter_frame_yuv(tensors, ref0, cfg)      # cur's planes decide
    assert all(p.device.type == "cpu" for p in out["recon"])
    assert_matches("P", out, jax_result("P", search_range=8))


@pytest.mark.parametrize("kind,kw", [
    # An even grid width (256): hevcasm_tpu's luma slab search asserts one.
    ("P", dict(search_range=32, search_impl="slab", w=256)),
    ("B", dict(search_range=32, search_impl="slab", w=256)),
    ("B", dict(search_range=32, search_impl="mv")),
    ("P", dict(search_range=8, pu_decision=True)),
    ("P", dict(search_range=8, tu_sizes=(8, 16))),
])
def test_rejected_configurations_raise_like_jax(kind, kw):
    with pytest.raises(ValueError) as theirs:
        run_jax(kind, **kw)
    with pytest.raises(ValueError) as ours:
        run_port(kind, **kw)
    key = "fixed CTU/TU geometry" if "pu_decision" in kw or "tu_sizes" in kw \
        else "search_impl"
    assert key in str(theirs.value) and key in str(ours.value)


@pytest.mark.parametrize("kind,kw", [
    # The luma search under the SAD metric (B9's plain version) and the
    # pyramid search; the B frame searches both references exhaustively in
    # one SAD grid call whatever me_strategy says.
    ("P", dict(search_range=8, qp=27, me_metric="sad")),
    ("P", dict(search_range=16, qp=27, me_strategy="pyramid")),
    ("P", dict(search_range=16, qp=27, me_metric="sad", me_strategy="pyramid",
               inter_impl="fused_dma")),
    ("B", dict(search_range=8, qp=27, me_metric="sad")),
    ("B", dict(search_range=8, qp=27, me_metric="sad", inter_impl="fused_dma")),
])
def test_search_configurations_match_jax(kind, kw):
    assert_matches(kind, run_port(kind, **kw), jax_result(kind, **kw))


@pytest.mark.parametrize("impl", ["stages", "fused_dma"])
def test_traced_quantizer_parameters_name_rate_control(impl):
    """The B frame's luma with the rate controller's tensor quantizer
    parameters (qp 30) against hevcasm_tpu's _b_frame_luma with traced ones:
    recon, MVs and bits equal (hevcasm_tpu's staged tier, which its tests
    show equal to its fused one; the port's fused tier runs B3's plain
    version here)."""
    from hevcasm_tpu.encode import ctu as jctu, motion as jmotion
    from hevcasm_tpu.encode.rate import quant_params_traced as jax_qparams
    from hevcasm_tpu.encode.video import _b_frame_luma as jax_b_luma
    from hevcasm_tpu_torch.encode import ctu as tctu, motion as tmotion
    from hevcasm_tpu_torch.encode.rate import quant_params_traced

    ref0, cur, ref1 = (f[0] for f in clip())
    grid = (H // 64, W // 64)
    want = jax_b_luma(jctu.tile_frame(jnp.asarray(cur), 64), jnp.asarray(ref0),
                      jnp.asarray(ref1), jmotion.ctu_positions(*grid, 64), grid,
                      JaxConfig(search_range=8), qparams=jax_qparams(jnp.int32(30), 3))
    got = _b_frame_luma(tctu.tile_frame(torch.as_tensor(cur), 64).contiguous(),
                        torch.as_tensor(ref0), torch.as_tensor(ref1),
                        tmotion.ctu_positions(*grid, 64), grid,
                        EncodeConfig(search_range=8, inter_impl=impl),
                        qparams=quant_params_traced(30, 3))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].dtype == torch.int32 and int(got[3]) == int(want[3])


@pytest.mark.parametrize("qp", [0, 29, 30, 35, 43, 44, 51])
def test_chroma_qp_table(qp):
    assert chroma_qp(qp) == jax_chroma_qp(qp)
