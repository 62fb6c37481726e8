"""What the port's CPU tests share.  Every tests/test_torch_*.py imports this
module, except tests/test_torch_cuda.py, which runs only on the card.  It
imports no jax, so a test run with --noconftest can import it too.

- One torch thread.  Importing the module sets it.
- The warp emulator: the device headers with their inline PTX replaced by
  tests/warp_emu.h's emulated products, a kernel's CTA body cut from its .cu
  file, the g++ build of an emulated program, and the one runner of such a
  program, with its time limit and its pinning to one core.
- Small helpers that several test files share: ``same``, ``jax_once`` and
  the panned picture ``smooth_plane``."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hevcasm_tpu_torch.kernels import build

# The xdist workers are the tests' parallelism.  Six workers, each with a
# full intra-op pool, contend for the host's cores: a plain op that takes
# 0.1 s alone takes 10 s among them.  This is set at import and not in a
# fixture, so module fixtures and module-level set-up run on one thread too.
torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
# The line of a kernel's .cu file above which its CTA body ends.
KERNEL_MARK = "// ---- the kernel and its C entry"
# Seconds one emulated program may run: ~25 times the slowest run under
# pytest -n 6 (2.3 s, a 256 x 256 chroma plane of test_torch_chroma_fused).
# A lane that skips a collective deadlocks the warp's barrier, and this is
# what such a case costs before it fails.
EMULATOR_TIMEOUT_S = 60


# ---- the warp emulator ---------------------------------------------------------------

def _emulated(tmp: Path, header: str, start: str, end: str, emulated: str) -> None:
    """``header`` of csrc written to tmp with its block from ``start`` up to
    ``end`` replaced by ``emulated``, over tests/warp_emu.h."""
    text = (Path(build.CSRC) / header).read_text()
    i, j = text.index(start), text.index(end)
    (tmp / header).write_text('#include "warp_emu.h"\n' + text[:i] + emulated + "\n" + text[j:])


def emulated_residual_core(tmp: Path) -> None:
    """residual_core.cuh with its mma.sync wrappers (the RESTC_MMA block)
    replaced by emu_mma."""
    _emulated(tmp, "residual_core.cuh", "#define RESTC_MMA(", "#undef RESTC_MMA", "\n".join(
        f"template <int W> __device__ __forceinline__ void {name}(int (&d)[4], "
        f"const uint32_t (&a)[W / 8], const uint32_t (&b)[W / 16]) "
        f"{{ emu_mma<W, {a}, {b}>(d, a, b); }}"
        for name, a, b in (("mma_s8u8", "true", "false"), ("mma_s8s8", "true", "true"),
                           ("mma_u8s8", "false", "true"))))


def emulated_mc_tc(tmp: Path) -> None:
    """mc_tc.cuh with its inline PTX (the MCTC_PTX block: the products and
    cp.async) replaced by emu_mma and plain copies."""
    emulated = "\n".join(
        f"inline void {name}(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) "
        f"{{ const uint32_t b[2] = {{b0, b1}}; emu_mma<32, true, {bs}>(d, a, b); }}"
        for name, bs in (("mma_s8u8", "false"), ("mma_s8s8", "true")))
    emulated += ("\ninline void cp_async16(uint8_t* dst, const uint8_t* src) { "
                 "for (int k = 0; k < 16; ++k) dst[k] = src[k]; }"
                 "\ninline void cp_async_wait_all() {}\n")
    _emulated(tmp, "mc_tc.cuh", "#define MCTC_PTX", "#undef MCTC_PTX", emulated)


def kernel_body(tmp: Path, source: str, name: str) -> None:
    """csrc/``source`` above its KERNEL_MARK (the CTA body, without the
    kernel and its C entry), written to tmp/``name``."""
    body = (Path(build.CSRC) / source).read_text()
    (tmp / name).write_text(body[:body.index(KERNEL_MARK)])


def build_emulator(tmp: Path, main: str, name: str) -> Path:
    """``main`` built by g++ as tmp/``name`` over the headers written to tmp
    and tests/warp_emu.h, with a stub cuda_runtime.h.  Skips without a C++20
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to build the device code for the CPU")
    (tmp / "cuda_runtime.h").write_text("#pragma once\n")
    (tmp / "main.cpp").write_text(main)
    exe = tmp / name
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-I", str(tmp), "-I", str(TESTS),
                    "-o", str(exe), str(tmp / "main.cpp")],
                   check=True, capture_output=True, text=True)
    return exe


def run_emulator(exe: Path, stdin: str, case: str) -> str:
    """The standard output of the emulated program ``exe`` on ``stdin``.

    The program runs on one core, which a small Python trampoline sets
    before it execs ``exe`` (a preexec_fn would fork this multithreaded
    process): the 32 lanes meet at a barrier at every collective, and lanes
    that share a core hand over to each other without waiting for busy
    cores.  A run that reaches EMULATOR_TIMEOUT_S fails, naming ``case``."""
    cpus = sorted(os.sched_getaffinity(0))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    cpu = cpus[int(worker.removeprefix("gw") or 0) % len(cpus)]
    pinned = (f"import os; os.sched_setaffinity(0, {{{cpu}}}); "
              f"os.execv({str(exe)!r}, [{str(exe)!r}])")
    try:
        return subprocess.run([sys.executable, "-I", "-S", "-c", pinned], input=stdin,
                              capture_output=True, text=True, check=True,
                              timeout=EMULATOR_TIMEOUT_S).stdout
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: the emulated warp ran past {EMULATOR_TIMEOUT_S} s "
                    "(a lane that skips a collective deadlocks the barrier)")


# ---- small helpers --------------------------------------------------------------------

def same(ours, theirs, what=""):
    """Equal values, shapes and dtypes."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, \
        (what, ours.dtype, ours.shape, theirs.dtype, theirs.shape)
    np.testing.assert_array_equal(ours, theirs, err_msg=what)


_JAX = {}


def jax_once(key, fn):
    """fn()'s answer, computed once a test process: the JAX package's answers
    are slow on the CPU, and several cases compare with one.  ``key`` names
    the answer within fn's module.  A tuple or list is kept as a tuple, a
    dict as it is, anything else as a numpy array."""
    key = (fn.__module__, key)
    if key not in _JAX:
        out = fn()
        if isinstance(out, (tuple, list)):
            out = tuple(out)
        elif not isinstance(out, dict):
            out = np.asarray(out)
        _JAX[key] = out
    return _JAX[key]


def smooth_plane(h, w, dy, dx, rng, fy=17, fx=11):
    """(h, w) uint8: a smooth picture moved by (dy, dx) pixels, with noise of
    sigma 1.5 drawn from ``rng``."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = y + dy, x + dx
    v = 128 + 70 * np.sin(xx / fx + yy / fy) + 40 * np.cos(xx / 23 - yy / 9)
    return np.clip(np.rint(v + rng.normal(0, 1.5, v.shape)), 0, 255).astype(np.uint8)
