"""The GOP entry points: hevcasm_tpu_torch's encode_gop (open loop and with
the wavefront I frame), encode_gop_yuv (IPPP and IBPBP),
encode_gop_closed_loop, encode_gop_closed_loop_yuv and
encode_gop_closed_loop_yuv_b against hevcasm_tpu's on the CPU, under
inter_impl "stages" and "fused_dma" (the port runs the kernels' plain
versions here, hevcasm_tpu its Pallas kernels in interpret mode), on a
seeded 128x192 4:2:0 clip at R = 8: T = 3, and T = 5 for IBPBP.  recon,
nnz (a Python int) and every other integer must be equal; PSNR may differ
by 1e-3 dB.  Each JAX result is computed once per module.
test_torch_cuda.py runs the GOPs on a card."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode import loop as jloop
from hevcasm_tpu.encode import video as jvideo

from hevcasm_tpu_torch.encode import EncodeConfig, YuvFrame, encode_gop
from hevcasm_tpu_torch.encode import video

SEED = 0x48455643
PSNR_TOL_DB = 1e-3
H, W, R = 128, 192, 8


def _plane(rng, t, h, w):
    """Smoothed noise panned (2, 3) pixels a frame, +-3 of noise a frame."""
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    out = np.stack([base[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(t)])
    return np.clip(np.rint(out + rng.integers(-3, 4, out.shape)), 0, 255).astype(np.uint8)


@functools.cache
def clip(t):
    rng = np.random.default_rng(SEED)
    return (_plane(rng, t, H, W), _plane(rng, t, H // 2, W // 2),
            _plane(rng, t, H // 2, W // 2))


def frames_for(entry):
    return clip(5 if entry.endswith("_b") else 3)


ENTRIES = ["gop", "gop_wavefront", "gop_yuv", "gop_yuv_b", "closed_loop", "closed_loop_yuv",
           "closed_loop_yuv_b"]


def run_jax(entry, impl):
    cfg = JaxConfig(search_range=R, inter_impl=impl,
                    intra_mode="wavefront" if entry == "gop_wavefront" else "open_loop")
    planes = frames_for(entry)
    yuv = jvideo.YuvFrame(*map(jnp.asarray, planes))
    out = {"gop": lambda: jloop.encode_gop(yuv.y, cfg),
           "gop_wavefront": lambda: jloop.encode_gop(yuv.y, cfg),
           "gop_yuv": lambda: jvideo.encode_gop_yuv(yuv, cfg),
           "gop_yuv_b": lambda: jvideo.encode_gop_yuv(yuv, cfg, b_frames=True),
           "closed_loop": lambda: jvideo.encode_gop_closed_loop(yuv.y, cfg, yuv.y.shape[0]),
           "closed_loop_yuv": lambda: jvideo.encode_gop_closed_loop_yuv(yuv, cfg),
           "closed_loop_yuv_b": lambda: jvideo.encode_gop_closed_loop_yuv_b(yuv, cfg)}[entry]()
    return jax.tree_util.tree_map(np.asarray, out)


@functools.cache
def jax_result(entry, impl):
    return run_jax(entry, impl)


def run_port(entry, impl, device="cpu", **kw):
    cfg = EncodeConfig(search_range=R, inter_impl=impl,
                       intra_mode="wavefront" if entry == "gop_wavefront" else "open_loop")
    yuv = YuvFrame(*frames_for(entry))
    return {"gop": lambda: encode_gop(yuv.y, cfg, device=device, **kw),
            "gop_wavefront": lambda: encode_gop(yuv.y, cfg, device=device, **kw),
            "gop_yuv": lambda: video.encode_gop_yuv(yuv, cfg, device=device, **kw),
            "gop_yuv_b": lambda: video.encode_gop_yuv(yuv, cfg, b_frames=True, device=device,
                                                      **kw),
            "closed_loop": lambda: video.encode_gop_closed_loop(yuv.y, cfg, yuv.y.shape[0],
                                                                device=device, **kw),
            "closed_loop_yuv": lambda: video.encode_gop_closed_loop_yuv(yuv, cfg, device=device,
                                                                        **kw),
            "closed_loop_yuv_b": lambda: video.encode_gop_closed_loop_yuv_b(
                yuv, cfg, device=device, **kw)}[entry]()


@pytest.mark.parametrize("impl", ["stages", "fused_dma"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_gop_equals_jax(entry, impl):
    ours, theirs = run_port(entry, impl), jax_result(entry, impl)
    assert set(ours) == set(theirs)
    t = frames_for(entry)[0].shape[0]
    for k, want in theirs.items():
        got = ours[k]
        if k.startswith("psnr"):
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, k
            assert float((got - torch.tensor(want)).abs().max()) <= PSNR_TOL_DB, k
        elif k == "nnz":
            assert type(got) is int and got == int(want)
        elif isinstance(got, YuvFrame):
            assert got.y.shape[0] == t
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        else:
            assert got.shape[0] == t
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


def test_closed_loop_gops_chain_the_per_frame_entry_points():
    # The closed-loop yuv GOP with B frames, composed by hand in encode
    # order I, P2, B1, P4, B3 from the per-frame entry points.
    cfg = EncodeConfig(search_range=R, inter_impl="fused_dma")
    yuv = YuvFrame(*map(torch.as_tensor, frames_for("closed_loop_yuv_b")))
    got = video.encode_gop_closed_loop_yuv_b(yuv, cfg)
    at = [YuvFrame(*(p[t] for p in yuv)) for t in range(5)]
    from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront

    i_y = encode_intra_frame_wavefront(at[0].y, cfg)["recon"]
    prev = YuvFrame(i_y, video._chroma_intra_plane(at[0].cb, cfg)[0],
                    video._chroma_intra_plane(at[0].cr, cfg)[0])
    want = [prev]
    for t in (1, 3):
        p = video.encode_inter_frame_yuv(at[t + 1], prev, cfg)["recon"]
        b = video.encode_b_frame_yuv(at[t], prev, p, cfg)["recon"]
        want += [b, p]
        prev = p
    for plane, got_plane in zip(zip(*want), got["recon"]):
        assert torch.equal(got_plane, torch.stack(plane))


@pytest.mark.parametrize("t", [1, 2, 4])
def test_closed_loop_yuv_b_needs_an_odd_frame_count_of_at_least_3(t):
    # hevcasm_tpu stops on a bare assert here; the port raises ValueError.
    yuv = YuvFrame(*(p[:t] if t <= 3 else np.concatenate([p, p[:t - 3]]) for p in clip(3)))
    with pytest.raises(ValueError, match="odd frame count"):
        video.encode_gop_closed_loop_yuv_b(yuv, EncodeConfig(search_range=R), device="cpu")


@pytest.mark.parametrize("entry", ["gop", "gop_yuv", "closed_loop", "closed_loop_yuv",
                                   "closed_loop_yuv_b"])
def test_gop_entry_points_need_a_card_or_an_explicit_cpu(entry):
    if torch.cuda.is_available():
        out = run_port(entry, "stages", device=None)
        assert out["recon"][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_port(entry, "stages", device=None)
    # Tensors stay on their own device whatever ``device`` says.
    cfg = EncodeConfig(search_range=R)
    y = torch.as_tensor(clip(3)[0])
    assert encode_gop(y, cfg, device="cuda")["recon"].device.type == "cpu"


def test_gop_rejects_planes_of_the_wrong_shape():
    y, cb, cr = clip(3)
    with pytest.raises(ValueError, match="T, H/2, W/2"):
        video.encode_gop_yuv(YuvFrame(y, cb[:, :32], cr), EncodeConfig(search_range=R),
                             device="cpu")
    with pytest.raises(ValueError, match="T, H, W"):
        encode_gop(y[0], EncodeConfig(search_range=R), device="cpu")
