"""The slice end to end: hevcasm_tpu_torch's encode_inter_frame against
hevcasm_tpu's encode_inter_frame(..., inter_impl="fused_dma") on the CPU, on
the same numpy frames.  recon, mvs, sad and nnz must be equal; psnr_db may
differ by 1e-3 dB, since the two sum the float mean in different orders
and precisions.  test_torch_cuda.py runs the kernel path on a card."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.encode.loop import encode_inter_frame as jax_encode

from hevcasm_tpu_torch.encode.loop import EncodeConfig, encode_inter_frame

REPO = Path(__file__).resolve().parents[1]
KEYS = ("recon", "mvs", "sad", "nnz")
PSNR_TOL_DB = 1e-3



def frames(h, w, content, seed=0):
    """(cur, ref) uint8.  "random": bench.py's content, a (2, 3) pixel shift
    of noise.  "pan": a smooth picture panned by (2.25, 3.25) pixels, so the
    quarter-pel refinement has work to do."""
    rng = np.random.default_rng(seed)
    if content == "random":
        base = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8)
        return base[2:2 + h, 3:3 + w].copy(), base[:h, :w].copy()
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def picture(dy, dx):
        yy, xx = y + dy, x + dx
        v = 128 + 70 * np.sin(xx / 11 + yy / 17) + 40 * np.cos(xx / 23 - yy / 9)
        return np.clip(np.rint(v + rng.normal(0, 1.5, v.shape)), 0, 255).astype(np.uint8)

    return picture(2.25, 3.25), picture(0, 0)


_JAX_CACHE = {}


def jax_result(h, w, r, content):
    key = (h, w, r, content)
    if key not in _JAX_CACHE:
        cur, ref = frames(h, w, content)
        out = jax_encode(jnp.asarray(cur), jnp.asarray(ref),
                         JaxConfig(search_range=r, qp=32, inter_impl="fused_dma"))
        _JAX_CACHE[key] = {k: np.asarray(v) for k, v in out.items()}
    return _JAX_CACHE[key]


def port_config(r, impl, **kw):
    if impl == "stages":
        kw.update(refine_impl="ref", residual_impl="ref")
    return EncodeConfig(search_range=r, qp=32, inter_impl=impl, **kw)


def assert_matches(ours, theirs):
    for k in KEYS:
        got = ours[k].cpu().numpy()
        assert got.dtype == theirs[k].dtype and got.shape == theirs[k].shape, k
        np.testing.assert_array_equal(got, theirs[k], err_msg=k)
    assert ours["psnr_db"].dtype == torch.float32
    assert abs(float(ours["psnr_db"]) - float(theirs["psnr_db"])) <= PSNR_TOL_DB


@pytest.mark.parametrize("h,w,r", [(128, 256, 32), (128, 192, 8)])
@pytest.mark.parametrize("content", ["random", "pan"])
@pytest.mark.parametrize("impl", ["fused_dma", "stages"])
def test_encode_inter_frame_matches_jax(h, w, r, content, impl):
    cur, ref = frames(h, w, content)
    ours = encode_inter_frame(torch.as_tensor(cur), torch.as_tensor(ref),
                              port_config(r, impl))
    assert_matches(ours, jax_result(h, w, r, content))


_JAX_IMPL_CACHE = {}


@pytest.mark.parametrize("kw", [
    dict(inter_impl="fused"), dict(inter_impl="fused_batched", fused_group=4),
    dict(fused_refine=True), dict(residual_impl="pallas"),
    dict(fused_refine=True, residual_impl="pallas", refine_impl="ref"),
])
def test_fused_configurations_match_jax(kw):
    # B16, B11 and B4 (their plain versions here; hevcasm_tpu's Pallas
    # kernels in interpret mode) at 128x192, R = 8, panned content.
    cur, ref = frames(128, 192, "pan")
    key = tuple(sorted(kw.items()))
    if key not in _JAX_IMPL_CACHE:
        out = jax_encode(jnp.asarray(cur), jnp.asarray(ref),
                         JaxConfig(search_range=8, qp=32, **kw))
        _JAX_IMPL_CACHE[key] = {k: np.asarray(v) for k, v in out.items()}
    ours = encode_inter_frame(cur, ref, EncodeConfig(search_range=8, qp=32, **kw),
                              device="cpu")
    assert_matches(ours, _JAX_IMPL_CACHE[key])


def test_numpy_input_needs_a_card_or_an_explicit_cpu():
    cur, ref = frames(64, 128, "random")
    cfg = port_config(8, "fused_dma")
    if torch.cuda.is_available():
        assert encode_inter_frame(cur, ref, cfg)["recon"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode_inter_frame(cur, ref, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode_inter_frame(cur, ref, cfg, device="cuda")
    out = encode_inter_frame(cur, ref, cfg, device="cpu")
    assert out["recon"].device.type == "cpu"
    # A tensor stays on its own device whatever ``device`` says.
    out_t = encode_inter_frame(torch.as_tensor(cur), ref, cfg, device="cuda")
    assert out_t["recon"].device.type == "cpu" and torch.equal(out_t["recon"], out["recon"])


def test_pan_content_exercises_the_fractions():
    theirs = jax_result(128, 256, 32, "pan")
    frac = theirs["mvs"] % 4
    assert (frac != 0).any(), "the pan should need quarter-pel fractions"


def test_explicit_slab_serves_an_odd_grid_width():
    # The JAX kernel asserts an even grid width; the port's K1 takes any.
    cur, ref = frames(128, 192, "random")
    ours = encode_inter_frame(cur, ref, port_config(32, "fused_dma", search_impl="slab"),
                              device="cpu")
    theirs = jax_encode(jnp.asarray(cur), jnp.asarray(ref),
                        JaxConfig(search_range=32, qp=32, inter_impl="fused_dma",
                                  search_impl="grid"))
    assert_matches(ours, {k: np.asarray(v) for k, v in theirs.items()})


@pytest.mark.parametrize("device,kwargs,want", [
    ("cpu", dict(), "grid"),
    ("cuda", dict(), "slab"),
    ("cuda", dict(search_range=8), "slab"),
    ("cuda", dict(search_range=33), "grid"),
    ("cuda", dict(ctu=32), "grid"),
    ("cuda", dict(search_impl="grid"), "grid"),
    ("cpu", dict(search_impl="slab"), "slab"),
])
def test_auto_search_follows_the_device(device, kwargs, want):
    # Resolving needs no card: only the device's type is read.
    from hevcasm_tpu_torch.encode.loop import _search_impl_resolved

    assert _search_impl_resolved(EncodeConfig(**kwargs), torch.device(device)) == want


def test_numpy_inputs_and_output_types():
    cur, ref = frames(64, 128, "random")
    out = encode_inter_frame(cur, ref, port_config(8, "fused_dma"), device="cpu")
    assert out["recon"].device.type == "cpu" and out["recon"].dtype == torch.uint8
    assert tuple(out["mvs"].shape) == (2, 2) and tuple(out["nnz"].shape) == ()
    with pytest.raises(ValueError, match="one shape"):
        encode_inter_frame(cur, ref[:, :64], port_config(8, "fused_dma"), device="cpu")


_JAX_SEARCH_CACHE = {}


@pytest.mark.parametrize("kwargs", [
    dict(me_metric="sad"),
    dict(me_strategy="pyramid"),
    dict(search_impl="mv", inter_impl="fused_dma"),
    dict(search_impl="dma", inter_impl="fused_dma"),
    dict(inter_impl="mega"),
    dict(pu_decision=True, me_metric="sad", inter_impl="fused_dma"),
    dict(tu_sizes=(8, 16), me_strategy="pyramid"),
    dict(me_metric="sad", refine_impl="mxu", residual_impl="mxu"),
    dict(tu_sizes=(8, 16), me_metric="sad"),
    dict(inter_impl="mega", search_range=8),
    dict(me_strategy="pyramid", me_metric="sad", inter_impl="fused_dma"),
    dict(tu_sizes=(4, 8), search_impl="dma"),
])
def test_search_configurations_match_jax(kwargs):
    # Every search configuration at 128x192 (an odd grid width), R = 32
    # unless given, panned content: the SAD metric (B9's plain version),
    # the pyramid search, search_impl "mv"/"dma" (B17's) and inter_impl
    # "mega" (B19's), against hevcasm_tpu with its Pallas kernels in
    # interpret mode.  Every key hevcasm_tpu returns must be equal.
    cur, ref = frames(128, 192, "pan")
    kw = {"search_range": 32, "qp": 32, **kwargs}
    key = tuple(sorted(kw.items()))
    if key not in _JAX_SEARCH_CACHE:
        out = jax_encode(jnp.asarray(cur), jnp.asarray(ref), JaxConfig(**kw))
        _JAX_SEARCH_CACHE[key] = {k: np.asarray(v) for k, v in out.items()}
    theirs = _JAX_SEARCH_CACHE[key]
    ours = encode_inter_frame(cur, ref, EncodeConfig(**kw), device="cpu")
    assert set(ours) == set(theirs)
    for k in theirs:
        if k == "psnr_db":
            assert abs(float(ours[k]) - float(theirs[k])) <= PSNR_TOL_DB
        else:
            np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)


@pytest.mark.parametrize("r", [4, 12])
def test_mega_outside_its_search_ranges_raises_value_error(r):
    # hevcasm_tpu's encode_ctu_mega stops on a bare assert at these ranges.
    cur, ref = frames(64, 128, "random")
    with pytest.raises(ValueError, match="8, 16, 24, 32"):
        encode_inter_frame(cur, ref, EncodeConfig(search_range=r, inter_impl="mega"),
                           device="cpu")


def test_port_imports_no_jax():
    # A subprocess: this test process has jax loaded by tests/conftest.py.
    # Every module of the package is imported (__main__ would run the CLI).
    code = ("import importlib, pkgutil, sys, hevcasm_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(hevcasm_tpu_torch.__path__, "
            "'hevcasm_tpu_torch.') if not m.name.endswith('__main__')]\n"
            "for name in names:\n    importlib.import_module(name)\n"
            "assert {'hevcasm_tpu_torch.io', 'hevcasm_tpu_torch.encode.intra_wavefront', "
            "'hevcasm_tpu_torch.kernels.intra_matrix'} <= set(names), names\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hevcasm_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
