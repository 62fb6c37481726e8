"""ctypes binding for the native C++ oracle library (``native/hevcref.cpp``),
the port's own copy of ``hevcasm_tpu.native``.

The native library is the implementation-independent golden model.  It is
built with g++ on first use into the port's build directory
(``build/hevcasm_tpu_torch/native/<hash>/``, named by the hash of the
source and the flags, written beside its final name and renamed); the
source's own directory is never written.  Every entry point takes numpy
arrays or CPU tensors and scalars and returns numpy arrays and Python
numbers: host-only oracles for tests and the self-test.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["NativeUnavailable", "build", "lib", "sad", "sad_grid", "ssd", "ssd_grid",
           "satd", "quantize", "quantize_inverse", "reconstruct", "forward_transform",
           "inverse_transform_add", "pred_uni", "pred_bi", "pred_intra_dc"]

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "hevcref.cpp"
_BUILD = _ROOT / "build" / "hevcasm_tpu_torch" / "native"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> Path:
    """Compile native/hevcref.cpp (if not built yet, or with ``force``);
    returns the library's path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / digest / "libhevcref.so"
    if so.exists() and not force:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeUnavailable(f"g++ build failed: {detail.decode()[:500]}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.hevcref_sad.restype = ctypes.c_int32
        _lib.hevcref_ssd.restype = ctypes.c_int64
        _lib.hevcref_satd.restype = ctypes.c_int32
        _lib.hevcref_quantize.restype = ctypes.c_int32
    return _lib


def _host(a, dtype) -> np.ndarray:
    """A C-contiguous numpy array of ``dtype`` for a numpy array or a CPU
    tensor (a tensor elsewhere raises ValueError: the oracles read host
    memory)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the native oracles take host memory, not {a.device}")
        a = a.numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a):
    a = _host(a, np.uint8)
    return a, _ptr(a, ctypes.c_uint8)


def _i16(a):
    a = _host(a, np.int16)
    return a, _ptr(a, ctypes.c_int16)


def sad(src, ref):
    src, ps = _u8(src)
    ref, pr = _u8(ref)
    h, w = src.shape
    return int(lib().hevcref_sad(ps, src.shape[1], pr, ref.shape[1], w, h))


def sad_grid(src, win, num_dy, num_dx):
    src, ps = _u8(src)
    win, pw = _u8(win)
    h, w = src.shape
    out = np.zeros((num_dy, num_dx), np.int32)
    lib().hevcref_sad_grid(ps, pw, w, h, num_dy, num_dx, _ptr(out, ctypes.c_int32))
    return out


def ssd(a, b):
    a, pa = _u8(a)
    b, pb = _u8(b)
    h, w = a.shape
    return int(lib().hevcref_ssd(pa, a.shape[1], pb, b.shape[1], w, h))


def ssd_grid(src, win, num_dy, num_dx):
    src, ps = _u8(src)
    win, pw = _u8(win)
    h, w = src.shape
    out = np.zeros((num_dy, num_dx), np.int32)
    lib().hevcref_ssd_grid(ps, pw, w, h, num_dy, num_dx, _ptr(out, ctypes.c_int32))
    return out


def satd(a, b):
    a, pa = _u8(a)
    b, pb = _u8(b)
    n = a.shape[0]
    return int(lib().hevcref_satd(pa, a.shape[1], pb, b.shape[1], n))


def quantize(src, scale, shift, offset):
    src, ps = _i16(src)
    dst = np.zeros_like(src)
    cbf = lib().hevcref_quantize(_ptr(dst, ctypes.c_int16), ps, scale, shift, offset,
                                 src.size)
    return dst, bool(cbf)


def quantize_inverse(src, scale, shift):
    src, ps = _i16(src)
    dst = np.zeros_like(src)
    lib().hevcref_quantize_inverse(_ptr(dst, ctypes.c_int16), ps, scale, shift, src.size)
    return dst


def reconstruct(pred, res):
    pred, pp = _u8(pred)
    res, pr = _i16(res)
    n = pred.shape[0]
    rec = np.zeros_like(pred)
    lib().hevcref_reconstruct(_ptr(rec, ctypes.c_uint8), n, pp, n, pr, n)
    return rec


def forward_transform(res, tr_type=0):
    res, pr = _i16(res)
    n = res.shape[0]
    out = np.zeros_like(res)
    lib().hevcref_forward_transform(_ptr(out, ctypes.c_int16), pr, n, tr_type)
    return out


def inverse_transform_add(coeffs, pred, tr_type=0):
    coeffs, pc = _i16(coeffs)
    pred, pp = _u8(pred)
    n = pred.shape[0]
    rec = np.zeros_like(pred)
    lib().hevcref_inverse_transform_add(_ptr(rec, ctypes.c_uint8), pc, pp, n, tr_type)
    return rec


def pred_uni(win, w, h, xfrac, yfrac, taps=8):
    win, pw = _u8(win)
    dst = np.zeros((h, w), np.uint8)
    lib().hevcref_pred_uni(_ptr(dst, ctypes.c_uint8), pw, w, h, xfrac, yfrac, taps)
    return dst


def pred_bi(win0, win1, w, h, fx0, fy0, fx1, fy1, taps=8):
    win0, p0 = _u8(win0)
    win1, p1 = _u8(win1)
    dst = np.zeros((h, w), np.uint8)
    lib().hevcref_pred_bi(_ptr(dst, ctypes.c_uint8), p0, p1, w, h, fx0, fy0, fx1, fy1, taps)
    return dst


def pred_intra_dc(left, above, n, filter_edge=False):
    left, pl = _u8(left)
    above, pa = _u8(above)
    dst = np.zeros((n, n), np.uint8)
    lib().hevcref_pred_intra_dc(_ptr(dst, ctypes.c_uint8), pl, pa, n, int(filter_edge))
    return dst
