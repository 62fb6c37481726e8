"""The random-access cell ra1080_ibpbp33 of hevcbench at a tiny size on the
CPU: the harness's own run (hevcbench.run.run_cell) of the port's closed-loop
IBPBP GOP (entries/gop_yuv_b.py) against the plain reference
(reference/gop_yuv_b.py), correct at GOPs of 3 and 5 frames and not correct
for the bfloat16 control or a broken program; the reference
imports nothing of the port and no JAX; the B GOP's span readers on a trace
made by hand; and B3's roofline arithmetic at 1080p.  A few seconds on one
worker."""

import json
import subprocess
import sys

import pytest
import torch

import torch_testing  # noqa: F401
from hevcbench import roofline, run, spans_gop_b
from hevcbench.profiling import Trace
from hevcbench.program import Program
from hevcbench.record import Record
from hevcbench.reference.encoder import Reference
from hevcbench.roofline import b3
from hevcbench.tests import cases
from hevcbench.tests.test_hevcbench_control import Broken
from hevcasm_tpu_torch.utils.trace import SPANS

CELL = "ra1080_ibpbp33"
SEED = 2**31 + 29


def _overrides(gop: int) -> dict:
    """The CPU tests' tiny size (hevcbench/tests/cases.py) with a pool of one
    GOP and no warm-up: the window's one step is the GOP checked."""
    return run.merge(cases.tiny(CELL), {"mix": {"gop": gop, "warmup_steps": 0,
                                                "content": {"frames": gop}}})


def _run(gop: int, api=None) -> dict:
    result, _ = run.run_cell(CELL, SEED, 1e-6, False, device="cpu", tiers="REF", api=api,
                             overrides=_overrides(gop))
    return result


@pytest.mark.parametrize("gop", [3, 5])
def test_the_port_matches_the_reference(gop):
    result = _run(gop)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == gop
    assert result["checks"]["recon_px"]["value"] == 0
    assert result["checks"]["psnr_db"]["value"] <= result["checks"]["psnr_db"]["limit"]


def test_the_control_is_not_correct():
    encode = cases.tiny_config(CELL)["encode"]
    result = _run(3, Reference(encode, torch.bfloat16, ["gop_yuv_b"]))
    assert not result["correct"]
    assert result["checks"]["recon_px"]["value"] > 0


def test_a_broken_program_is_not_correct():
    """One sample of each plane of each frame after the I frame altered."""
    program = Program(cases.tiny_config(CELL)["encode"], "REF", ["gop_yuv_b"])
    result = _run(3, Broken(program, "altered"))
    assert not result["correct"] and result["failed"] == 2
    assert result["checks"]["recon_px"]["value"] == 2 * 3


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    probe = ("import sys; before = set(sys.modules); import hevcbench.reference.gop_yuv_b; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in set(sys.modules) - before})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=run.ROOT).stdout
    loaded = json.loads(out)
    assert "hevcbench" in loaded and "torch" in loaded
    assert not set(loaded) & {"hevcasm_tpu_torch", "hevcasm_tpu", "jax", "jaxlib", "flax"}


def _b_gop() -> Trace:
    """A GOP of 3 frames: the I frame 30 us, the P frame, the B frame 30 us
    with its chroma 15 us; launches in the I frame, the P frame, the B
    frame's luma (1) and chroma (2), and one after the GOP."""
    host = [("hevcasm.gop_closed_yuv_b", 0.0, 100.0), ("hevcasm.intra", 1.0, 30.0),
            ("hevcasm.inter_yuv", 40.0, 20.0), ("hevcasm.inter_b_yuv", 65.0, 30.0),
            ("hevcasm.bi_luma", 66.0, 10.0), ("hevcasm.bi_chroma", 77.0, 15.0),
            ("hevcasm.psnr", 93.0, 1.0), ("cudaLaunchKernel", 5.0, 1.0),
            ("cudaLaunchKernel", 50.0, 1.0), ("cudaLaunchKernel", 70.0, 1.0),
            ("cuLaunchKernel", 80.0, 1.0), ("cudaLaunchKernelExC", 85.0, 1.0),
            ("cudaLaunchKernel", 105.0, 1.0)]
    return Trace(0.0, 110.0, [("k", 0.0, 1.0)], host, frames=3)


def _read(name, trace):
    return run.reader(name).read(Record({}, 0.0, 1.0, 0, trace.frames, [], trace))


def test_b_gop_readers_on_a_trace_made_by_hand(capsys):
    trace = _b_gop()
    assert _read("b_host_ms", trace) == pytest.approx(0.030)
    assert _read("bi_chroma_host_ms", trace) == pytest.approx(0.015)
    assert _read("intra_host_ms.ra", trace) == pytest.approx(0.030)
    assert _read("b_launches", trace) == 3
    err = capsys.readouterr().err
    assert "5.0 inside hevcasm.gop_closed_yuv_b, 6.0 in the traced sub-window" in err
    assert "entry spans coded" not in err
    trace.frames = 4
    _read("b_host_ms", trace)
    assert "1 entry spans coded 3 frames; the trace coded 4" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["b_host_ms", "b_launches", "bi_chroma_host_ms",
                                  "intra_host_ms.ra"])
def test_b_gop_readers_read_nothing_without_the_b_gop_span(name):
    """A program without the B GOP's spans (an IPPP GOP's, or none) and a
    run without a trace leave them nothing."""
    trace = _b_gop()
    trace.host = [h if h[0] != spans_gop_b.GOP_B else ("hevcasm.gop_closed_yuv", *h[1:])
                  for h in trace.host]
    assert _read(name, trace) is None
    trace.host = [h for h in trace.host if not h[0].startswith("hevcasm.")]
    assert _read(name, trace) is None
    assert run.reader(name).read(Record({}, 0.0, 1.0, 0, 0)) is None


def test_every_span_the_b_gop_readers_look_for_is_recorded_by_the_program():
    assert set(spans_gop_b.READ) <= set(SPANS)


def test_b3_roofline_at_1080p():
    g = {"width": 1920, "coded_height": 1088, "ctu": 64, "search_range": 32}
    ops, nbytes = b3.cost(g)
    # Two of K2's refinements, the mean and the 8x8 residual, a CTU.
    refine = 2 * (4 * 71 * 64 * 8 + 16 * 4096 * 8 + 4096 * 8) + 2 * 16 * 4096
    assert ops == 510 * (2 * refine + 2 * 4096 + 2 * 4 * 4096 * 8)
    # The CTUs, two padded planes, two offset arrays; recon, two fractions,
    # nnz and bits a TU.
    assert nbytes == 510 * 4096 + 2 * 1159 * 1991 + 510 * 16 + 510 * (4096 + 8 + 512)
    # Bound by the bytes: 0.0027 ms, chip_smoke's bound column for B3.
    assert roofline.bound_s(ops, nbytes) == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0027, abs=5e-5)
