"""Rate control: hevcasm_tpu_torch.encode.rate against hevcasm_tpu.encode.rate
on the CPU, on seeded numpy clips (128x128 and 128x192, R = 8).

The quantizer parameters and bit counts must be equal; every GOP's recon,
bits and qp trajectory must be equal to hevcasm_tpu's staged traced GOP
(which tests/test_rate.py shows equal to its fused ones, so no Pallas
interpret run is needed), and PSNR within 1e-3 dB (the two sum the float
means in different orders).  Each JAX result is computed once per module.
The device-q C entries are held against their host-int entries and plain
versions on a card in test_torch_cuda.py."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode import rate as jrate

import torch_testing  # noqa: F401
from hevcasm_tpu_torch.encode import rate
from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame
from hevcasm_tpu_torch.kernels import bi_fused, inter_fused
from hevcasm_tpu_torch.ops.quantize import (QUANT_RANGES, flag_quant_params, raise_on_flag,
                                            range_flag)

SEED = 0x48455643
PSNR_TOL_DB = 1e-3
R = 8


def _clip(rng, t, h, w, noise=0):
    """tests/test_rate.py's clip: smoothed noise panned (2, 3) a frame, with
    independent noise of +-``noise`` a frame."""
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    out = np.stack([base[2 * i: 2 * i + h, 3 * i: 3 * i + w] for i in range(t)])
    if noise:
        n = rng.integers(-noise, noise + 1, out.shape)
        out = np.clip(out.astype(np.int16) + n, 0, 255).astype(np.uint8)
    return out


@functools.cache
def clip(t, h, w, noise=0):
    return _clip(np.random.default_rng(SEED), t, h, w, noise)


def as_numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


@functools.cache
def jax_gop(t, h, w, noise, target, qp0, b_frames, qp_min=10, qp_max=49):
    cfg = JaxConfig(search_range=R, refine_impl="ref")
    return as_numpy(jrate.encode_gop_rate_controlled(
        jnp.asarray(clip(t, h, w, noise)), target, qp0, cfg, qp_min, qp_max, b_frames))


def port_gop(t, h, w, noise, target, qp0, b_frames, **kw):
    out = rate.encode_gop_rate_controlled(clip(t, h, w, noise), target, qp0,
                                          EncodeConfig(search_range=R, **kw),
                                          b_frames=b_frames, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def assert_gop_equal(got, want):
    assert set(got) == set(want)
    for key in ("recon", "bits", "qp"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["psnr_db"], want["psnr_db"], rtol=0, atol=PSNR_TOL_DB)


STAGED_AND_FUSED = [dict(refine_impl="ref"), dict(refine_impl="mxu"),
                    dict(fused_refine=True), dict(inter_impl="fused"),
                    dict(inter_impl="fused_batched"), dict(inter_impl="fused_dma")]


@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("qp", [4, 22, 32, 45, 51])
def test_quant_params_traced_match_jax(qp, intra):
    for tu in (4, 8, 16, 32):
        cfg = EncodeConfig(qp=qp, tu=tu)
        got = rate.quant_params_traced(torch.tensor(qp, dtype=torch.int32), cfg.tu_log2, intra)
        want = jrate.quant_params_traced(jnp.int32(qp), cfg.tu_log2, intra)
        assert all(g.dtype == torch.int32 and g.shape == () for g in got)
        assert [int(g) for g in got] == [int(w) for w in want]
        # ... and the fixed-qp path's parameters.
        assert [int(g) for g in got] == [*cfg.quant_params(intra), *cfg.dequant_params()]


def test_quant_params_traced_take_a_vector_of_qps():
    qps = torch.tensor([4, 22, 32, 45, 51], dtype=torch.int32)
    got = rate.quant_params_traced(qps, 3)
    want = jrate.quant_params_traced(jnp.asarray(qps.numpy()), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), (5,)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bits_estimate_matches_jax(seed):
    levels = np.random.default_rng(seed).integers(-32768, 32768, (4, 8, 8)).astype(np.int16)
    levels[0] = 0
    got = rate.bits_estimate(torch.as_tensor(levels))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(jrate.bits_estimate(jnp.asarray(levels)))


def test_bits_estimate_counts():
    levels = torch.tensor([0, 1, -1, 2, 3, -4, 100], dtype=torch.int16)
    assert int(rate.bits_estimate(levels)) == 3 + 3 + 5 + 5 + 7 + 15


@pytest.mark.parametrize("kw", [dict(refine_impl="ref"), dict(inter_impl="fused_dma")])
def test_traced_frame_equals_fixed_qp_frame(kw):
    frames = clip(2, 128, 128)
    cfg = EncodeConfig(search_range=R, qp=30, **kw)
    traced = rate.encode_inter_frame_traced_qp(frames[1], frames[0], 30, cfg, device="cpu")
    fixed = encode_inter_frame(frames[1], frames[0], cfg, device="cpu")
    want = jrate.encode_inter_frame_traced_qp(jnp.asarray(frames[1]), jnp.asarray(frames[0]),
                                              jnp.int32(30), JaxConfig(search_range=R, qp=30))
    np.testing.assert_array_equal(traced["recon"].numpy(), fixed["recon"].numpy())
    np.testing.assert_array_equal(traced["recon"].numpy(), np.asarray(want["recon"]))
    assert traced["bits"].dtype == torch.int32 and int(traced["bits"]) == int(want["bits"])
    assert int(traced["qp"]) == 30
    assert abs(float(traced["psnr_db"]) - float(want["psnr_db"])) <= PSNR_TOL_DB


@pytest.mark.parametrize("kw", STAGED_AND_FUSED, ids=lambda kw: "-".join(map(str, kw.values())))
def test_ippp_gop_matches_jax(kw):
    want = jax_gop(5, 128, 128, 10, 6000.0, 32, False)
    assert_gop_equal(port_gop(5, 128, 128, 10, 6000.0, 32, False, **kw), want)
    assert len(set(want["qp"].tolist())) > 1


@pytest.mark.parametrize("kw", [dict(), dict(inter_impl="fused"), dict(inter_impl="fused_dma")],
                         ids=["stages", "fused", "fused_dma"])
def test_ibpbp_gop_matches_jax(kw):
    want = jax_gop(5, 128, 192, 0, 20000.0, 32, True)
    got = port_gop(5, 128, 192, 0, 20000.0, 32, True, **kw)
    assert_gop_equal(got, want)
    assert got["recon"].shape == (4, 128, 192) and got["bits"].shape == (2,)


def test_ibpbp_first_pair_equals_its_frames():
    """The GOP's first pair is the per-frame traced composition at qp0."""
    frames = clip(5, 128, 192)
    cfg = EncodeConfig(search_range=R, inter_impl="fused_dma")
    out = rate.encode_gop_rate_controlled(frames, 20000.0, 32, cfg, b_frames=True,
                                          device="cpu")
    p2 = rate.encode_inter_frame_traced_qp(frames[2], frames[0], 32, cfg, device="cpu")
    b1 = rate.encode_b_frame_traced_qp(frames[1], frames[0], p2["recon"], 32, cfg,
                                       device="cpu")
    torch.testing.assert_close(out["recon"][1], p2["recon"], rtol=0, atol=0)
    torch.testing.assert_close(out["recon"][0], b1["recon"], rtol=0, atol=0)
    assert int(out["bits"][0]) == int(p2["bits"]) + int(b1["bits"])


def test_rate_control_steers_bits_as_jax_does():
    frames = clip(8, 128, 128, 12)
    cfg = EncodeConfig(search_range=R)
    bits = [int(rate.encode_inter_frame_traced_qp(frames[1], frames[0], qp, cfg,
                                                  device="cpu")["bits"]) for qp in (38, 22)]
    target = int(np.sqrt(max(bits[0], 1) * max(bits[1], 1)))
    got = port_gop(8, 128, 128, 12, target, 40, False)
    assert_gop_equal(got, jax_gop(8, 128, 128, 12, target, 40, False))
    settled = got["bits"][3:].astype(float)
    assert np.all(settled > target / 2.5) and np.all(settled < target * 2.5)
    assert got["qp"][0] == 40 and got["qp"][-1] != 40


def test_target_and_qp0_may_be_tensors():
    want = port_gop(5, 128, 128, 10, 6000.0, 32, False)
    got = rate.encode_gop_rate_controlled(
        torch.as_tensor(clip(5, 128, 128, 10)), torch.tensor(6000.0, dtype=torch.float64),
        torch.tensor(32), EncodeConfig(search_range=R))
    assert_gop_equal({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("kw,b_frames", [
    (dict(), False), (dict(inter_impl="fused"), False), (dict(inter_impl="fused_dma"), False),
    (dict(inter_impl="fused_dma"), True), (dict(), True)])
def test_out_of_range_qp_raises(kw, b_frames):
    """qp 60 gives the quantizer shift 21 + 10 - 3 = 28 > 27: the range flag
    is read after the GOP and raises, as checkify does in hevcasm_tpu."""
    with pytest.raises(ValueError, match="shift outside"):
        rate.encode_gop_rate_controlled(clip(3, 128, 128, 10), 6000.0, 60,
                                        EncodeConfig(search_range=R, **kw), qp_min=55,
                                        qp_max=70, b_frames=b_frames, device="cpu")


@pytest.mark.parametrize("entry", ["P", "B"])
def test_single_frame_reads_its_flag_when_checked(entry):
    frames = clip(3, 128, 128, 10)
    cfg = EncodeConfig(search_range=R, inter_impl="fused_dma")

    def run(checked):
        if entry == "P":
            return rate.encode_inter_frame_traced_qp(frames[1], frames[0], 60, cfg,
                                                     checked=checked, device="cpu")
        return rate.encode_b_frame_traced_qp(frames[1], frames[0], frames[2], 60, cfg,
                                             checked=checked, device="cpu")

    assert run(False)["recon"].shape == (128, 128)
    with pytest.raises(ValueError, match="outside"):
        run(True)


@pytest.mark.parametrize("fn", [rate.encode_inter_frame_traced_qp,
                                rate.encode_b_frame_traced_qp])
def test_traced_qp_rdo_config_raises(fn):
    frames = clip(3, 128, 128)
    cfg = EncodeConfig(search_range=R, qp=32, tu_sizes=(4, 8))
    with pytest.raises(ValueError, match="pu_decision/tu_sizes"):
        fn(*frames[:2 if fn is rate.encode_inter_frame_traced_qp else 3], 32, cfg,
           device="cpu")


def test_even_frame_count_with_b_frames_raises():
    """hevcasm_tpu stops on a bare assert here (rate.py:247)."""
    with pytest.raises(ValueError, match="odd frame count"):
        rate.encode_gop_rate_controlled(clip(4, 128, 128), 6000.0, 32,
                                        EncodeConfig(search_range=R), b_frames=True,
                                        device="cpu")


def test_range_flag_sets_one_bit_per_parameter():
    flag = range_flag("cpu")
    flag_quant_params(flag, scale=torch.tensor(1), shift=torch.tensor(27),
                      offset=torch.tensor(0), dshift=torch.tensor(31))
    assert int(flag) == 0
    raise_on_flag(flag)
    for name, (bit, lo, hi) in QUANT_RANGES.items():
        for bad in (lo - 1, hi + 1):
            flag = range_flag("cpu")
            flag_quant_params(flag, **{name: torch.tensor(bad, dtype=torch.int32)})
            assert int(flag) == bit
            with pytest.raises(ValueError, match=f"{name} outside \\[{lo}, {hi}\\]"):
                raise_on_flag(flag)
        with pytest.raises(ValueError, match="outside"):    # a number: at once
            flag_quant_params(range_flag("cpu"), **{name: hi + 1})


@pytest.mark.parametrize("wrapper", ["inter_ctu_fused_dma", "inter_ctu_fused",
                                     "bi_ctu_fused_dma"])
def test_fused_plain_versions_take_tensor_parameters(wrapper):
    """K2, B16 and B3 on CPU tensors (their plain versions) with the five
    parameters as 0-d tensors equal the same with ints, and flag a shift
    past the range."""
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.integers(0, 256, (3, 64, 64), dtype=np.uint8))
    plane = torch.as_tensor(rng.integers(0, 256, (2 * 80, 200), dtype=np.uint8))
    off0 = torch.tensor([[0, 0], [5, 60], [9, 129]], dtype=torch.int32)
    off1 = off0 + torch.tensor([80, 0], dtype=torch.int32)
    if wrapper == "inter_ctu_fused_dma":
        fn = functools.partial(inter_fused.inter_ctu_fused_dma, src, plane, off0)
    elif wrapper == "inter_ctu_fused":
        win = torch.stack([plane[y:y + 71, x:x + 71] for y, x in off0.tolist()])
        fn = functools.partial(inter_fused.inter_ctu_fused, src, win)
    else:
        fn = functools.partial(bi_fused.bi_ctu_fused_dma, src, plane, off0, off1)
    cfg = EncodeConfig(qp=37)
    ints = (*cfg.quant_params(False), *cfg.dequant_params())
    flag = range_flag("cpu")
    got = fn(*rate.quant_params_traced(37, 3), range_flag=flag)
    for g, w in zip(got, fn(*ints)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int(flag) == 0
    fn(*rate.quant_params_traced(60, 3), range_flag=flag)
    assert int(flag) == QUANT_RANGES["shift"][0]
    with pytest.raises(ValueError, match="outside"):     # no flag: read at once
        fn(*rate.quant_params_traced(60, 3))


@pytest.mark.parametrize("b_frames", [False, True])
def test_one_frame_gop_codes_nothing_as_jax_does(b_frames):
    want = jax_gop(1, 128, 128, 0, 6000.0, 32, b_frames)
    got = port_gop(1, 128, 128, 0, 6000.0, 32, b_frames)
    assert_gop_equal(got, want)
    assert got["recon"].shape == (0, 128, 128)
