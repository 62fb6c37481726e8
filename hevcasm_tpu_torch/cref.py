"""ctypes binding for the genuine kupix/hevcasm C reference, compiled
unmodified from the upstream tree: the port's own copy of
``hevcasm_tpu.cref``.

The upstream tree is read in place from the directory that
HEVCASM_REFERENCE names, and from nowhere else.  Its modules are compiled
with gcc and linked with ``native/cref_shim.c`` (flat C entry points that
call each family through hevcasm_populate_*(table, HEVCASM_C_REF)) and
aborting stubs for the x86 assembly symbols that the populate functions
name but never call under that mask, as the Makefile's ``cref`` target
does, into the port's build directory (``build/hevcasm_tpu_torch/cref/
<hash>/``, named by the hash of the sources and flags, renamed into place
when complete).  Nothing is written into the tree or into ``native/``.

Host-only (numpy arrays or CPU tensors in, numpy out); unavailable when
HEVCASM_REFERENCE is unset or names no tree, and the tests skip then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .native import _host

__all__ = ["CrefUnavailable", "available", "build", "lib", "sad", "sad_multiref", "ssd",
           "ssd_linear", "satd", "quantize", "quantize_inverse", "reconstruct",
           "forward_transform", "inverse_transform_add", "pred_uni", "pred_bi",
           "pred_intra_dc"]

_ROOT = Path(__file__).resolve().parent.parent
_SHIM = _ROOT / "native" / "cref_shim.c"
_BUILD = _ROOT / "build" / "hevcasm_tpu_torch" / "cref"
_MODULES = ("sad", "ssd", "diff", "hadamard", "quantize", "residual_decode", "pred_inter",
            "pred_intra")
_STUB = re.compile(r"(hevcasm|f265|vp9)_[a-z0-9_]+")

_lib = None


class CrefUnavailable(RuntimeError):
    pass


def _reference() -> Path | None:
    env = os.environ.get("HEVCASM_REFERENCE")
    return Path(env) if env else None


def available() -> bool:
    ref = _reference()
    return ref is not None and (ref / "src" / "lib" / "sad.c").exists()


def _cflags(ref_lib: Path) -> list[str]:
    return ["-O2", "-fPIC", "-I", str(ref_lib), "-I", str(ref_lib / "libvpx" / "config" / "gcc"),
            "-I", str(ref_lib / "libvpx")]


def build() -> Path:
    """Compile the reference's modules and the shim (if not built yet);
    returns the library's path.  Raises CrefUnavailable without the tree
    or a C toolchain."""
    ref = _reference()
    if ref is None:
        raise CrefUnavailable("HEVCASM_REFERENCE is unset: set it to the upstream tree")
    ref_lib = ref / "src" / "lib"
    if not (ref_lib / "sad.c").exists():
        raise CrefUnavailable(f"reference tree not found at {ref}")
    sources = [ref_lib / f"{m}.c" for m in _MODULES]
    flags = _cflags(ref_lib)
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in [_SHIM, *sources])
                            + " ".join(flags).encode()).hexdigest()[:16]
    so = _BUILD / digest / "libhevcasm_cref.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=so.parent))
    try:
        objs = []
        for src in sources:
            obj = work / f"cref_{src.stem}.o"
            subprocess.run(["gcc", *flags, "-c", "-o", str(obj), str(src)], check=True,
                           capture_output=True)
            objs.append(str(obj))
        undefined = subprocess.run(["nm", "-u", *objs], check=True, capture_output=True,
                                   text=True).stdout
        stubs = work / "cref_stubs.c"
        stubs.write_text("#include <stdlib.h>\n" + "".join(
            f"void {name}(void) {{ abort(); }}\n"
            for name in sorted({m.group(0) for m in _STUB.finditer(undefined)})))
        tmp = work / "lib.so"
        subprocess.run(["gcc", *flags, "-shared", "-o", str(tmp), str(_SHIM), str(stubs),
                        *objs], check=True, capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        if isinstance(detail, str):
            detail = detail.encode()
        raise CrefUnavailable(f"cref build failed: {detail.decode()[:500]}") from e
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_PD = ctypes.c_ssize_t  # ptrdiff_t
_I = ctypes.c_int

_SIGNATURES = {
    "cref_sad": (_I, [_U8P, _PD, _U8P, _PD, _I, _I]),
    "cref_sad_multiref": (None, [_U8P, _PD, _U8P, _U8P, _U8P, _U8P, _PD, _I32P, _I, _I]),
    "cref_ssd": (_I, [_U8P, _PD, _U8P, _PD, _I]),
    "cref_ssd_linear": (_I, [_U8P, _U8P, _I]),
    "cref_satd": (_I, [_U8P, _PD, _U8P, _PD, _I]),
    "cref_quantize": (_I, [_I16P, _I16P, _I, _I, _I, _I]),
    "cref_quantize_inverse": (None, [_I16P, _I16P, _I, _I, _I]),
    "cref_reconstruct": (None, [_U8P, _PD, _U8P, _PD, _I16P, _I]),
    "cref_transform": (None, [_I16P, _I16P, _PD, _I, _I]),
    "cref_inverse_transform_add": (None, [_U8P, _PD, _U8P, _PD, _I16P, _I, _I]),
    "cref_pred_uni": (None, [_U8P, _PD, _U8P, _PD, _I, _I, _I, _I, _I]),
    "cref_pred_bi": (None, [_U8P, _PD, _U8P, _U8P, _PD, _I, _I, _I, _I, _I, _I, _I]),
    "cref_pred_intra_dc": (None, [_U8P, _U8P, _I, _I]),
}


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            f = getattr(_lib, name)
            f.restype = res
            f.argtypes = args
    return _lib


def _pu8(a):
    return a.ctypes.data_as(_U8P)


def _pi16(a):
    return a.ctypes.data_as(_I16P)


def _u8(a):
    a = _host(a, np.uint8)
    return a, _pu8(a)


def _i16(a):
    a = _host(a, np.int16)
    return a, _pi16(a)


def sad(src, ref):
    src, ps = _u8(src)
    ref, pr = _u8(ref)
    h, w = src.shape
    return int(lib().cref_sad(ps, src.shape[1], pr, ref.shape[1], w, h))


def sad_multiref(src, refs):
    """refs: (4, h, w).  Returns the 4 SADs."""
    src, ps = _u8(src)
    refs = _host(refs, np.uint8)
    h, w = src.shape
    out = np.zeros(4, np.int32)
    lib().cref_sad_multiref(ps, w, _pu8(refs[0]), _pu8(refs[1]), _pu8(refs[2]),
                            _pu8(refs[3]), w, out.ctypes.data_as(_I32P), w, h)
    return out


def ssd(a, b):
    a, pa = _u8(a)
    b, pb = _u8(b)
    n = a.shape[0]
    return int(lib().cref_ssd(pa, a.shape[1], pb, b.shape[1], n.bit_length() - 1))


def ssd_linear(a, b):
    a, pa = _u8(a)
    b, pb = _u8(b)
    return int(lib().cref_ssd_linear(pa, pb, a.size))


def satd(a, b):
    a, pa = _u8(a)
    b, pb = _u8(b)
    n = a.shape[0]
    return int(lib().cref_satd(pa, a.shape[1], pb, b.shape[1], n.bit_length() - 1))


def quantize(src, scale, shift, offset):
    src, ps = _i16(src)
    dst = np.zeros_like(src)
    cbf = lib().cref_quantize(_pi16(dst), ps, scale, shift, offset, src.size)
    return dst, bool(cbf)


def quantize_inverse(src, scale, shift):
    src, ps = _i16(src)
    dst = np.zeros_like(src)
    lib().cref_quantize_inverse(_pi16(dst), ps, scale, shift, src.size)
    return dst


def reconstruct(pred, res):
    pred, pp = _u8(pred)
    res, pr = _i16(res)
    n = pred.shape[0]
    rec = np.zeros_like(pred)
    lib().cref_reconstruct(_pu8(rec), n, pp, n, pr, n.bit_length() - 1)
    return rec


def forward_transform(res, tr_type=0):
    res, pr = _i16(res)
    n = res.shape[0]
    out = np.zeros_like(res)
    lib().cref_transform(_pi16(out), pr, n, tr_type, n.bit_length() - 1)
    return out


def inverse_transform_add(coeffs, pred, tr_type=0):
    coeffs, pc = _i16(coeffs)
    pred, pp = _u8(pred)
    n = pred.shape[0]
    rec = np.zeros_like(pred)
    lib().cref_inverse_transform_add(_pu8(rec), n, pp, n, pc, tr_type, n.bit_length() - 1)
    return rec


def pred_uni(win, w, h, xfrac, yfrac, taps=8):
    """win: extended window (h+taps-1, w+taps-1) with the block origin at
    (pad, pad), pad = taps//2 - 1, the convention of ops.pred_inter."""
    win, _ = _u8(win)
    pad = taps // 2 - 1
    dst = np.zeros((h, w), np.uint8)
    lib().cref_pred_uni(_pu8(dst), w, _pu8(win[pad:, pad:]), win.shape[1], w, h, xfrac,
                        yfrac, taps)
    return dst


def pred_bi(win0, win1, w, h, fx0, fy0, fx1, fy1, taps=8):
    win0, _ = _u8(win0)
    win1, _ = _u8(win1)
    pad = taps // 2 - 1
    dst = np.zeros((h, w), np.uint8)
    lib().cref_pred_bi(_pu8(dst), w, _pu8(win0[pad:, pad:]), _pu8(win1[pad:, pad:]),
                       win0.shape[1], w, h, fx0, fy0, fx1, fy1, taps)
    return dst


def pred_intra_dc(left, above, n, filter_edge=False):
    """left/above: (2n,) neighbour runs, laid into the neighbour buffer the
    reference reads (buf[63 - dy] = left[dy], buf[64 + dx] = above[dx])."""
    left = _host(left, np.uint8)
    above = _host(above, np.uint8)
    buf = np.zeros(192, np.uint8)
    buf[63 - np.arange(2 * n)] = left[:2 * n]
    buf[64:64 + 2 * n] = above[:2 * n]
    dst = np.zeros((n, n), np.uint8)
    lib().cref_pred_intra_dc(_pu8(dst), _pu8(buf), n.bit_length() - 1, int(filter_edge))
    return dst
