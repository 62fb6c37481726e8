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


def test_pan_content_exercises_the_fractions():
    theirs = jax_result(128, 256, 32, "pan")
    frac = theirs["mvs"] % 4
    assert (frac != 0).any(), "the pan should need quarter-pel fractions"


def test_explicit_slab_serves_an_odd_grid_width():
    # The JAX kernel asserts an even grid width; the port's K1 takes any.
    cur, ref = frames(128, 192, "random")
    ours = encode_inter_frame(cur, ref, port_config(32, "fused_dma", search_impl="slab"))
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
    out = encode_inter_frame(cur, ref, port_config(8, "fused_dma"))
    assert out["recon"].device.type == "cpu" and out["recon"].dtype == torch.uint8
    assert tuple(out["mvs"].shape) == (2, 2) and tuple(out["nnz"].shape) == ()
    with pytest.raises(ValueError, match="one shape"):
        encode_inter_frame(cur, ref[:, :64], port_config(8, "fused_dma"))


@pytest.mark.parametrize("kwargs,item", [
    (dict(me_metric="sad"), "ROADMAP A.2"),
    (dict(me_strategy="pyramid"), "ROADMAP A.3"),
    (dict(search_impl="mv", inter_impl="fused_dma"), "ROADMAP B17"),
    (dict(search_impl="dma", inter_impl="fused_dma"), "ROADMAP B17"),
    (dict(inter_impl="mega"), "ROADMAP B19"),
    (dict(inter_impl="fused"), "ROADMAP B16"),
    (dict(inter_impl="fused_batched"), "ROADMAP B16"),
    (dict(pu_decision=True, inter_impl="fused_dma"), "ROADMAP A.10"),
    (dict(tu_sizes=(8, 16), inter_impl="fused_dma"), "ROADMAP A.10"),
    (dict(fused_refine=True, residual_impl="ref"), "ROADMAP B11"),
    (dict(refine_impl="mxu", residual_impl="ref"), "ROADMAP A.2"),
    (dict(refine_impl="ref", residual_impl="mxu"), "ROADMAP A.5"),
    (dict(refine_impl="ref", residual_impl="pallas"), "ROADMAP B4"),
])
def test_unported_configurations_name_their_roadmap_item(kwargs, item):
    cur, ref = frames(64, 64, "random")
    with pytest.raises(NotImplementedError, match=item):
        encode_inter_frame(cur, ref, EncodeConfig(**kwargs))


def test_port_imports_no_jax():
    # A subprocess: this test process has jax loaded by tests/conftest.py.
    code = ("import sys, hevcasm_tpu_torch, hevcasm_tpu_torch.encode.loop, "
            "hevcasm_tpu_torch.kernels.build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hevcasm_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
