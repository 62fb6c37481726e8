"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface, on first use, into ``build/hevcasm_tpu_torch/<hash>/`` beside
the package (the hash covers the sources, the ``csrc/*.cuh`` headers they
share and the flags, so an edited kernel is rebuilt and an unchanged one is
not).  The library is loaded with ``ctypes``; each C entry takes device
pointers, ints and a CUDA stream (B10's, B5's, B6's, chroma_p_fused's,
chroma_b_fused's, chroma_pu_fused's and intra_wave_fused's, whose calls are host-bound, take
them packed in one block), launches one
kernel on that stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "build", "load", "check", "on_card", "raw_stream"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "hevcasm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argument types (pointers and the stream as void*,
# sizes and parameters as int, strides that may pass 2^31 as long long).
# Every entry returns a cudaError_t as int.
_ENTRIES = {
    # src, plane, out, n, gc, plane_h, plane_w, radius, device, stream
    "hevc_ssd_grid_plane": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # src, planes, out, n, k, gc, plane_stride, row_stride, radius, device, stream
    "hevc_ssd_grid_plane_multi": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P],
    # src, pred, rec, nnz, n, tu, tr_type, qscale, qshift, qoffset, dscale,
    # dshift, device, stream
    "hevc_residual_ctu": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # src, windows, tile_stride, row_stride, pred, frac, cost, n, b, device, stream
    "hevc_refine_fused": [_P, _P, _L, _I, _P, _P, _P, _I, _I, _I, _P],
    # src, windows, win_stride, row_stride, win_h, win_w, out, n, b, num_dy,
    # num_dx, device, stream
    "hevc_ssd_grid": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P],
    # the same arguments as hevc_ssd_grid
    "hevc_sad_grid": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P],
    # src, plane, offsets, shift, mv, best, n, plane_h, plane_w, radius, device, stream
    "hevc_search_mv": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # src, plane, positions, rec, mv, frac, best, nnz, n, plane_h, plane_w,
    # radius, qscale, qshift, qoffset, dscale, dshift, device, stream
    "hevc_mega": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P],
    # src, plane, offsets, rec, frac, cost, nnz, bits, n, plane_h, plane_w,
    # qscale, qshift, qoffset, dscale, dshift, device, stream
    "hevc_inter_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    # src, plane, offsets, rec, frac, cost, nnz, bits, n, plane_h, plane_w,
    # qvec (int32[5] on the card), range_flag, device, stream
    "hevc_inter_fused_q": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    # src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, n,
    # plane_h, plane_w, qscale, qshift, qoffset, dscale, dshift, device, stream
    "hevc_bi_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P],
    # src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, n,
    # plane_h, plane_w, qvec, range_flag, device, stream
    "hevc_bi_fused_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    # src, windows, tile_stride, row_stride, cost, n, b, device, stream
    "hevc_costmap": [_P, _P, _I, _I, _P, _I, _I, _I, _P],
    # src, plane, offsets, cost, win_out, n, b, plane_h, plane_w, device, stream
    "hevc_costmap_dma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # src, windows, ctu_stride, row_stride, grids, n, base, radius, device, stream
    "hevc_base_grids": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _P],
    # src, windows, ctu_stride, row_stride, pu_table, num_pu, table_len, keys,
    # out, n, base, radius, device, stream
    "hevc_base_decide": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P],
    # one block of 14 int64 (csrc/sad.cu SadArgs): src, src_stride, src_row,
    # refs, ref_stride, ref_k_stride, ref_row, out, n, k, h, w, device, stream
    "hevc_sad": [ctypes.c_char_p],
    "hevc_sad_multiref": [ctypes.c_char_p],
    # one block of 25 int64 (csrc/mc_tc.cuh McArgs): win[2], win_stride[2],
    # win_row[2], frac[4], frac_stride[4], val[4], out, n, h, w, taps,
    # device, stream
    "hevc_pred_uni": [ctypes.c_char_p],
    "hevc_pred_bi": [ctypes.c_char_p],
    # one block of 17 int64 (csrc/chroma_fused.cu ChromaArgs): cur[2], ref[2],
    # rec[2], mv, nnz, h, w, qscale, qshift, qoffset, dscale, dshift,
    # device, stream
    "hevc_chroma_p_fused": [ctypes.c_char_p],
    # one block of 20 int64 (ChromaBiArgs): cur[2], ref0[2], ref1[2], rec[2],
    # mv0, mv1, nnz, h, w, qscale, qshift, qoffset, dscale, dshift, device,
    # stream
    "hevc_chroma_b_fused": [ctypes.c_char_p],
    # one block of 18 int64 (ChromaPuArgs): cur[2], ref[2], rec[2], mv
    # field, nnz, h, w, k, qscale, qshift, qoffset, dscale, dshift, device,
    # stream
    "hevc_chroma_pu_fused": [ctypes.c_char_p],
    # one block of 20 int64 (csrc/intra_wave.cu IntraWaveArgs): canvas, src,
    # order, refs, lav, aav, cav, nnz, modes, start, stop, num, strong,
    # qscale, qshift, qoffset, dscale, dshift, device, stream
    "hevc_intra_wave": [ctypes.c_char_p],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of every failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources if no library for their hash exists yet; returns
    the library's path.  The objects go to a scratch directory and the
    library to a temporary name that is renamed into place, so a process
    never loads a partial file."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
    lib = out_dir / "libhevcasm_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as scratch:
        objs = [str(Path(scratch) / f"{src.stem}.o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources, objs)])
        tmp = str(Path(scratch) / lib.name)
        _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def raw_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream, read without
    making a torch.cuda.Stream object (the cheapest call PyTorch has for
    it: a launch path that runs per call uses it)."""
    return torch._C._cuda_getCurrentRawStream(index)


def on_card(what: str, *tensors) -> "torch.device":
    """The one CUDA device the tensors a wrapper launches on lie on; raise
    ValueError if they lie elsewhere or on several."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}; "
                         "need one CUDA device")
    return dev


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, bad
    configuration, or an earlier asynchronous fault)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
