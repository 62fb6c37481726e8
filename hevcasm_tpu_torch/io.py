"""Frame I/O: raw planar 4:2:0 YUV and Y4M readers and writer, the
counterpart of ``hevcasm_tpu.io`` (numpy and ctypes only).

Positioned reads go through the native library built from
``native/yuv_io.cpp`` with g++ on first use, into the port's build
directory (``build/hevcasm_tpu_torch/yuvio/<hash>/``, under
kernels.build.BUILD_ROOT beside the CUDA kernels' builds); the source's
own directory is never written.  Without a
C++ toolchain the reads run in numpy and give the same frames.
``last_path`` says which of the two ran last ("native" or "numpy").
Frames come back as YuvArrays numpy triples, ready for
encode.video.YuvFrame.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

__all__ = ["YuvArrays", "read_y4m", "iter_frames", "write_y4m", "last_path"]

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "yuv_io.cpp"
_BUILD = _ROOT / "build" / "hevcasm_tpu_torch" / "yuvio"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
#: Which path served the last read_y4m or iter_frames call: "native" (the
#: g++-built library) or "numpy"; None before the first.
last_path: str | None = None


class YuvArrays(NamedTuple):
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


def _build() -> Path:
    """Compile native/yuv_io.cpp (if not built yet) into a directory named
    by the hash of the source and flags; returns the library's path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD / digest / "libyuvio.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        # Built beside its final name and renamed, so that a process never
        # loads a library another process is still writing.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def _native():
    """The loaded native library, or None without a C++ toolchain."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            _lib = False
            return None
        lib.yuv_y4m_parse.restype = ctypes.c_int64
        lib.yuv_y4m_parse.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.yuv_read_frame.restype = ctypes.c_int64
        lib.yuv_read_frame.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib or None


def _frame_bytes(w: int, h: int) -> int:
    return w * h * 3 // 2


def read_y4m(path: str | Path) -> tuple[int, int, int, int, int]:
    """Parse a Y4M header; returns (width, height, fps_num, fps_den, hdr_len)."""
    global last_path
    path = str(path)
    lib = _native()
    if lib is not None:
        last_path = "native"
        w, h, fn, fd = (ctypes.c_int() for _ in range(4))
        hdr = lib.yuv_y4m_parse(path.encode(), ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(fn), ctypes.byref(fd))
        if hdr < 0:
            raise ValueError(f"not a Y4M file: {path}")
        return w.value, h.value, fn.value, fd.value, int(hdr)
    last_path = "numpy"
    with open(path, "rb") as f:
        line = f.readline().decode("ascii", "replace")
        hdr = f.tell()
    if not line.startswith("YUV4MPEG2"):
        raise ValueError(f"not a Y4M file: {path}")
    w = h = 0
    fn, fd = 25, 1
    for tok in line.split()[1:]:
        if tok[0] == "W":
            w = int(tok[1:])
        elif tok[0] == "H":
            h = int(tok[1:])
        elif tok[0] == "F":
            fn, fd = (int(v) for v in tok[1:].split(":"))
    return w, h, fn, fd, hdr


def iter_frames(path: str | Path, width: int | None = None,
                height: int | None = None) -> Iterator[YuvArrays]:
    """Yield 4:2:0 frames from a .y4m (geometry from its header) or a raw
    .yuv file (geometry required: ValueError without it)."""
    global last_path
    path = Path(path)
    if path.suffix == ".y4m":
        w, h, _, _, off = read_y4m(path)
        marker = 6  # "FRAME\n"
    else:
        if not (width and height):
            raise ValueError("a raw .yuv file needs its width and height")
        w, h, off, marker = width, height, 0, 0
    lib = _native()
    last_path = "native" if lib is not None else "numpy"
    size = path.stat().st_size
    step = marker + _frame_bytes(w, h)
    while off + step <= size:
        y = np.empty((h, w), np.uint8)
        cb = np.empty((h // 2, w // 2), np.uint8)
        cr = np.empty((h // 2, w // 2), np.uint8)
        if lib is not None:
            n = lib.yuv_read_frame(str(path).encode(), off, w, h, marker,
                                   y.ctypes.data, cb.ctypes.data, cr.ctypes.data)
            if n < 0:
                return
        else:
            with open(path, "rb") as f:
                f.seek(off + marker)
                y[:] = np.fromfile(f, np.uint8, w * h).reshape(h, w)
                cb[:] = np.fromfile(f, np.uint8, w * h // 4).reshape(h // 2, w // 2)
                cr[:] = np.fromfile(f, np.uint8, w * h // 4).reshape(h // 2, w // 2)
            n = step
        yield YuvArrays(y, cb, cr)
        off += int(n)


def write_y4m(path: str | Path, frames, width: int, height: int, fps=(25, 1)) -> None:
    """Write frames (an iterable of YuvArrays of numpy planes) as a Y4M file."""
    header = f"YUV4MPEG2 W{width} H{height} F{fps[0]}:{fps[1]} Ip A1:1 C420jpeg\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for fr in frames:
            f.write(b"FRAME\n")
            for plane in fr:
                f.write(np.ascontiguousarray(plane, np.uint8).tobytes())
