"""Intra frames: hevcasm_tpu_torch's intra matrices, mode decision, intra
neighbours and references, encode_intra_frame, the closed-loop wavefront
frame and the 4:2:0 I frame against hevcasm_tpu's on the CPU, on the same
seeded numpy inputs (frames of 128x192 and smaller).  Every integer output
must be equal; PSNR may differ by 1e-3 dB (the two sum the float means in
different orders).  Each JAX result is computed once per module.
test_torch_cuda.py runs the card paths."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode import loop as jloop
from hevcasm_tpu.encode.intra_wavefront import encode_intra_frame_wavefront as jax_wavefront
from hevcasm_tpu.encode.video import YuvFrame as JaxYuv
from hevcasm_tpu.encode.video import encode_intra_frame_yuv as jax_intra_yuv
from hevcasm_tpu.kernels import intra_matrix as jmatrix

import torch_testing  # noqa: F401
from hevcasm_tpu_torch.encode import EncodeConfig, YuvFrame, encode_intra_frame
from hevcasm_tpu_torch.encode import loop
from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront
from hevcasm_tpu_torch.encode.video import encode_intra_frame_yuv
from hevcasm_tpu_torch.kernels import intra_matrix

SEED = 0x48455643
PSNR_TOL_DB = 1e-3


def picture(h, w, seed=SEED, noise=3.0):
    """Smoothed noise with a little noise on top: edges in many directions,
    so the mode decision picks many modes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    return np.clip(np.rint(base + rng.normal(0, noise, base.shape)), 0, 255).astype(np.uint8)


def as_numpy(out):
    return {k: (tuple(np.asarray(p) for p in v) if k == "recon" and isinstance(v, tuple)
                else np.asarray(v)) for k, v in out.items()}


def assert_outputs_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k, want in theirs.items():
        got = ours[k]
        if k.startswith("psnr"):
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= PSNR_TOL_DB, k
        elif isinstance(want, tuple):
            for g, t in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), t, err_msg=k)
        else:
            got = got.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=k)


# ---- the intra matrices and the n = 32 decision ------------------------------

def test_mode_matrices_equal_jax():
    for ours, theirs in zip(intra_matrix.mode_matrices(32), jmatrix.mode_matrices(32)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_mode_matrices_t_equal_jax_with_whole_weights():
    wt, bias_t, shift_lane, scale_lane, shifts = intra_matrix.mode_matrices_t(32)
    hi, lo, *rest = jmatrix.mode_matrices_t(32)
    np.testing.assert_array_equal(wt, hi.astype(np.int64) * 256 + lo)
    for ours, theirs in zip((bias_t, shift_lane, scale_lane, shifts), rest):
        np.testing.assert_array_equal(ours, theirs)
    # The bounds that make the float64 products exact.
    assert np.abs(wt).max() <= 1824 and np.abs(wt).sum(0).max() <= 4096
    assert np.abs(bias_t).max() <= 526336


def references(content, m=24, seed=1):
    """(blocks (m, 32, 32), plain refs, filtered refs) as numpy uint8."""
    rng = np.random.default_rng(seed)
    if content == "random":
        def draw(*shape):
            return rng.integers(0, 256, shape, dtype=np.uint8)
    elif content == "extremes":
        def draw(*shape):
            return (rng.integers(0, 2, shape) * 255).astype(np.uint8)
    else:  # constant: every mode predicts the block exactly, all scores tie
        vals = rng.integers(0, 256, m, dtype=np.uint8)

        def draw(*shape):
            return np.broadcast_to(vals.reshape((m,) + (1,) * (len(shape) - 1)),
                                   shape).copy()
    blocks = draw(m, 32, 32)
    plain = (draw(m, 64), draw(m, 64), draw(m))
    filt = (draw(m, 64), draw(m, 64), draw(m))
    return blocks, plain, filt


CONTENTS = ["random", "extremes", "constant"]


@pytest.mark.parametrize("content", CONTENTS)
def test_pred_intra_all_modes_mm_equals_jax(content):
    _, plain, filt = references(content)
    want = np.asarray(jmatrix.pred_intra_all_modes_mm(*map(jnp.asarray, plain + filt), 32))
    got = intra_matrix.pred_intra_all_modes_mm(*map(torch.as_tensor, plain + filt), 32)
    assert got.dtype == torch.uint8 and got.shape == (24, 35, 32, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("content", CONTENTS)
def test_intra_mode_decision_t_equals_jax(content):
    blocks, plain, filt = references(content)
    want = jmatrix.intra_mode_decision_t(jnp.asarray(blocks), *map(jnp.asarray, plain + filt),
                                         32)
    got = intra_matrix.intra_mode_decision_t(torch.as_tensor(blocks),
                                             *map(torch.as_tensor, plain + filt), 32)
    for g, w, dtype in zip(got, want, (torch.uint8, torch.int32, torch.int32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if content == "constant":
        # Every mode predicts the block exactly and all 35 scores tie (the
        # rounding terms alone): the first minimum is planar.
        assert (got[2] == got[2][:, :1]).all() and not got[1].any()


def test_matrix_forms_reject_other_sizes():
    _, plain, filt = references("random")
    with pytest.raises(ValueError, match="32x32"):
        intra_matrix.mode_matrices(16)
    with pytest.raises(ValueError, match="32x32"):
        intra_matrix.pred_intra_all_modes_mm(*map(torch.as_tensor, plain + filt), 16)


# ---- neighbours and reference preparation ------------------------------------

@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_intra_neighbours_and_references_equal_jax(n, strong):
    frame = picture(128, 192, noise=8.0)
    want_nb = jloop._intra_neighbours(jnp.asarray(frame), n)
    got_nb = loop._intra_neighbours(torch.as_tensor(frame), n)
    for g, w in zip(got_nb, want_nb):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jloop._prepare_intra_refs(*want_nb, n, JaxConfig(strong_intra_smoothing=strong))
    got = loop._prepare_intra_refs(*got_nb, n, EncodeConfig(strong_intra_smoothing=strong))
    for g_set, w_set in zip(got, want):
        for g, w in zip(g_set, w_set):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the frames ---------------------------------------------------------------

@functools.cache
def jax_intra(kind, h, w, kw):
    cur = picture(h, w)
    cfg = JaxConfig(**dict(kw))
    fn = jloop.encode_intra_frame if kind == "open" else jax_wavefront
    return as_numpy(fn(jnp.asarray(cur), cfg))


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("tu", [4, 8])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_encode_intra_frame_equals_jax(n, tu, qp):
    kw = (("intra_block", n), ("qp", qp), ("tu", tu))
    ours = encode_intra_frame(picture(128, 192), EncodeConfig(**dict(kw)), device="cpu")
    assert_outputs_equal(ours, jax_intra("open", 128, 192, kw))


@pytest.mark.parametrize("h,w,kw", [
    (128, 192, (("intra_block", 32),)),
    (128, 192, (("intra_block", 16), ("qp", 27))),
    (128, 192, (("intra_block", 32), ("strong_intra_smoothing", False), ("tu", 4))),
    (192, 64, (("intra_block", 32),)),             # taller than wide
    (128, 32, (("intra_block", 32),)),             # one block column: empty waves
    (96, 64, (("intra_block", 8), ("tu", 4))),
])
def test_wavefront_frame_equals_jax(h, w, kw):
    ours = encode_intra_frame_wavefront(picture(h, w), EncodeConfig(**dict(kw)), device="cpu")
    assert "modes" not in ours
    assert_outputs_equal(ours, jax_intra("wavefront", h, w, kw))


def test_wavefront_frame_is_closed_loop():
    # Predicting from reconstructions differs from predicting from the
    # source: the two frames must not be equal at a coarse qp.
    cfg = EncodeConfig(qp=40)
    cur = picture(128, 192)
    closed = encode_intra_frame_wavefront(cur, cfg, device="cpu")
    open_ = encode_intra_frame(cur, cfg, device="cpu")
    assert not torch.equal(closed["recon"], open_["recon"])


def yuv_picture(h=128, w=192):
    return (picture(h, w), picture(h // 2, w // 2, seed=SEED + 1),
            picture(h // 2, w // 2, seed=SEED + 2))


@pytest.mark.parametrize("kw", [(), (("qp", 37), ("strong_intra_smoothing", False)),
                                (("ctu", 32), ("intra_block", 16))])
def test_encode_intra_frame_yuv_equals_jax(kw):
    planes = yuv_picture()
    want = as_numpy(jax_intra_yuv(JaxYuv(*map(jnp.asarray, planes)), JaxConfig(**dict(kw))))
    ours = encode_intra_frame_yuv(YuvFrame(*planes), EncodeConfig(**dict(kw)), device="cpu")
    assert isinstance(ours["recon"], YuvFrame)
    assert_outputs_equal(ours, want)


@pytest.mark.parametrize("entry", ["open", "wavefront", "yuv"])
def test_intra_entry_points_need_a_card_or_an_explicit_cpu(entry):
    frame = (yuv_picture(64, 64) if entry == "yuv" else picture(64, 64))
    fn = {"open": encode_intra_frame, "wavefront": encode_intra_frame_wavefront,
          "yuv": encode_intra_frame_yuv}[entry]
    if torch.cuda.is_available():
        out = fn(frame)
        assert out["nnz"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(frame)
    assert fn(frame, device="cpu")["nnz"].device.type == "cpu"
