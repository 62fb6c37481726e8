"""hevcasm_tpu_torch.native and .cref against hevcasm_tpu's bindings, and
the ops' public names pad_for, quantize_checked and check_params_traced
against hevcasm_tpu's, on the CPU.  The port's native library is built
into build/hevcasm_tpu_torch/native/ (never into native/); cref needs the
upstream reference tree and skips without it, as hevcasm_tpu's tests do."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from hevcasm_tpu import cref as jax_cref
from hevcasm_tpu import native as jax_native
from hevcasm_tpu.ops import pred_inter as jax_pred_inter
import torch_testing  # noqa: F401
from hevcasm_tpu_torch import cref, native
from hevcasm_tpu_torch.ops import pred_inter

# The ops packages export a function named quantize beside the module.
jax_quantize = importlib.import_module("hevcasm_tpu.ops.quantize")
quantize = importlib.import_module("hevcasm_tpu_torch.ops.quantize")

@pytest.fixture(scope="module")
def oracles():
    """Both native libraries built (each package builds its own)."""
    try:
        jax_native.lib()
        native.lib()
    except (jax_native.NativeUnavailable, native.NativeUnavailable) as e:
        pytest.skip(f"no C++ toolchain to build the oracle: {e}")


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _i16(rng, *shape, lo=-4096, hi=4096):
    return rng.integers(lo, hi, shape).astype(np.int16)


def _cases(rng):
    """(name, port call, jax call) over one set of inputs a function."""
    a, b = _u8(rng, 16, 24), _u8(rng, 16, 24)
    src, win = _u8(rng, 8, 8), _u8(rng, 8 + 6, 8 + 6)
    sq0, sq1 = _u8(rng, 8, 8), _u8(rng, 8, 8)
    coef, res = _i16(rng, 8, 8), _i16(rng, 8, 8, lo=-300, hi=300)
    pred, pred4 = _u8(rng, 8, 8), _u8(rng, 4, 4)
    w0, w1 = _u8(rng, 16 + 7, 8 + 7), _u8(rng, 16 + 7, 8 + 7)
    c0 = _u8(rng, 8 + 3, 8 + 3)
    left, above = _u8(rng, 16), _u8(rng, 16)
    return [
        ("sad", (a, b)), ("sad_grid", (src, win, 7, 7)), ("ssd", (a, b)),
        ("ssd_grid", (src, win, 7, 7)), ("satd", (sq0, sq1)),
        ("quantize", (coef, 26214, 22, 85 << 7)), ("quantize_inverse", (coef, 40 << 5, 2)),
        ("reconstruct", (pred, res)), ("forward_transform", (res,)),
        ("forward_transform", (res[:4, :4], 1)),
        ("inverse_transform_add", (coef // 8, pred)),
        ("inverse_transform_add", (coef[:4, :4] // 8, pred4, 1)),
        ("pred_uni", (w0, 8, 16, 1, 3)), ("pred_uni", (c0, 8, 8, 5, 2, 4)),
        ("pred_bi", (w0, w1, 8, 16, 2, 1, 3, 0)), ("pred_intra_dc", (left, above, 8)),
        ("pred_intra_dc", (left, above, 8, True)),
    ]


def test_native_functions_match_jax_bindings(oracles):
    rng = np.random.default_rng(0x4E41)
    names = set()
    for name, args in _cases(rng):
        names.add(name)
        got, want = getattr(native, name)(*args), getattr(jax_native, name)(*args)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[0], want[0], err_msg=name)
            assert got[1] == want[1], name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert type(got) is type(want), name
    public = {n for n in jax_native.__dict__ if not n.startswith("_") and callable(
        getattr(jax_native, n)) and getattr(getattr(jax_native, n), "__module__", "") ==
        jax_native.__name__}
    assert public - {"build", "lib", "NativeUnavailable"} == names


def test_native_takes_cpu_tensors_and_builds_outside_native_dir(oracles):
    rng = np.random.default_rng(1)
    a, b = _u8(rng, 8, 8), _u8(rng, 8, 8)
    assert native.sad(torch.as_tensor(a), torch.as_tensor(b)) == jax_native.sad(a, b)
    path = native.build()
    assert path.parent.parent.name == "native" and "build" in path.parts
    assert path.parent.parent.parent.name == "hevcasm_tpu_torch"


def test_native_refuses_device_tensors():
    meta = torch.empty((4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="host memory"):
        native.sad(meta, meta)


def test_cref_available_matches_jax():
    assert cref.available() == jax_cref.available()


@pytest.mark.skipif(not cref.available(), reason="reference tree not mounted")
def test_cref_functions_match_jax_bindings():
    rng = np.random.default_rng(2)
    a, b = _u8(rng, 16, 16), _u8(rng, 16, 16)
    refs = _u8(rng, 4, 16, 16)
    coef, res = _i16(rng, 8, 8), _i16(rng, 8, 8, lo=-300, hi=300)
    pred, w0, w1 = _u8(rng, 8, 8), _u8(rng, 8 + 7, 8 + 7), _u8(rng, 8 + 7, 8 + 7)
    left, above = _u8(rng, 16), _u8(rng, 16)
    for name, args in [("sad", (a, b)), ("sad_multiref", (a, refs)), ("ssd", (a, b)),
                       ("ssd_linear", (a, b)), ("satd", (a[:8, :8], b[:8, :8])),
                       ("quantize", (coef, 26214, 22, 85 << 7)),
                       ("quantize_inverse", (coef, 40 << 5, 2)),
                       ("reconstruct", (pred, res)), ("forward_transform", (res,)),
                       ("inverse_transform_add", (coef // 8, pred)),
                       ("pred_uni", (w0, 8, 8, 1, 2)),
                       ("pred_bi", (w0, w1, 8, 8, 1, 2, 3, 0)),
                       ("pred_intra_dc", (left, above, 8))]:
        got, want = getattr(cref, name)(*args), getattr(jax_cref, name)(*args)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[0], want[0], err_msg=name)
            assert got[1] == want[1]
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_cref_reads_only_hevcasm_reference(monkeypatch):
    """With HEVCASM_REFERENCE unset no tree is looked for, beside the
    checkout or anywhere else."""
    monkeypatch.delenv("HEVCASM_REFERENCE", raising=False)
    assert not cref.available()
    with pytest.raises(cref.CrefUnavailable, match="HEVCASM_REFERENCE is unset"):
        cref.build()


def test_cref_unavailable_without_the_tree(monkeypatch, tmp_path):
    monkeypatch.setenv("HEVCASM_REFERENCE", str(tmp_path / "absent"))
    assert not cref.available()
    with pytest.raises(cref.CrefUnavailable, match="not found"):
        cref.build()


@pytest.mark.parametrize("taps", [8, 4])
def test_pad_for_matches_jax(taps):
    assert pred_inter.pad_for(taps) == jax_pred_inter.pad_for(taps)
    assert "pad_for" in pred_inter.__all__


QUANT_PARAMS = [(26214, 22, 85 << 7), (1, 16, 0), (0x7FFF, 27, 0x7FFF), (26214, 28, 85 << 7),
                (0, 22, 0), (26214, 15, 0x8000)]


@pytest.mark.parametrize("params", QUANT_PARAMS)
def test_quantize_checked_matches_jax(params):
    """Parameters on the device (traced in JAX) give a deferred error;
    numbers (concrete in JAX) are refused at once."""
    rng = np.random.default_rng(sum(params))
    src = rng.integers(-3000, 3000, (3, 8, 8)).astype(np.int16)
    jerr, (jdst, jcbf) = jax.jit(jax_quantize.quantize_checked)(
        jnp.asarray(src), *(jnp.int32(v) for v in params))
    err, (dst, cbf) = quantize.quantize_checked(torch.as_tensor(src),
                                                *(torch.tensor(v) for v in params))
    assert (err.get() is None) == (jerr.get() is None)
    if jerr.get() is None:
        np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
        np.testing.assert_array_equal(cbf.numpy(), np.asarray(jcbf))
        err.throw()
        dst_n, _ = quantize.quantize_checked(torch.as_tensor(src), *params)[1]
        np.testing.assert_array_equal(dst_n.numpy(), np.asarray(jdst))
    else:
        with pytest.raises(ValueError, match="outside"):
            err.throw()
        with pytest.raises(checkify.JaxRuntimeError):
            jerr.throw()
        with pytest.raises(ValueError, match="outside"):
            jax_quantize.quantize_checked(jnp.asarray(src), *params)
        with pytest.raises(ValueError, match="outside"):
            quantize.quantize_checked(torch.as_tensor(src), *params)


@pytest.mark.parametrize("params", QUANT_PARAMS)
def test_check_params_traced_matches_jax(params):
    jerr, _ = jax.jit(checkify.checkify(lambda *p: jax_quantize.check_params_traced(*p)))(
        *(jnp.int32(v) for v in params))
    err = quantize.check_params_traced(*(torch.tensor(v) for v in params))
    assert (err.get() is None) == (jerr.get() is None)
    flag = quantize.range_flag("cpu")
    assert quantize.check_params_traced(*(torch.tensor(v) for v in params), flag=flag).flag \
        is flag
    assert (int(flag) == 0) == (jerr.get() is None)
