"""The RD cell ldp1080_rdo of hevcbench at a tiny size on the CPU: the
harness's own run (hevcbench.run.run_cell) of the port's 4:2:0 RD P frame
(entries/inter_yuv_rd.py: the six PU layouts down to 8x8, TUs 4-32, chroma
at each PU's MV) against the plain reference (reference/inter_yuv_rd.py),
correct on two seeds and not correct for the bfloat16 control or a broken
program; the reference imports nothing of the port and no JAX, and states
the port's lambda; the PU and TU decisions' span readers on a trace made by
hand; and the rooflines of B14, B13 and chroma_pu_fused at 1080p.  A few
seconds on one worker."""

import json
import subprocess
import sys

import pytest
import torch

import torch_testing  # noqa: F401
from hevcbench import roofline, run
from hevcbench.profiling import Trace
from hevcbench.program import Program
from hevcbench.record import Record
from hevcbench.reference import inter_yuv_rd
from hevcbench.reference.encoder import Reference
from hevcbench.roofline import b13, b14, chroma_pu
from hevcbench.tests import cases
from hevcbench.tests.test_hevcbench_control import Broken
from hevcasm_tpu_torch.encode import partition
from hevcasm_tpu_torch.kernels import chroma_fused
from hevcasm_tpu_torch.utils.trace import SPANS

CELL = "ldp1080_rdo"
G1080 = {"width": 1920, "coded_height": 1088, "ctu": 64, "search_range": 32}


def _run(seed, api=None) -> dict:
    result, _ = cases.tiny_run(CELL, seed, 1e-6, api=api)
    return result


@pytest.mark.parametrize("seed", [2**31 + 27, 5])
def test_the_port_matches_the_reference(seed):
    result = _run(seed)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["recon_px"]["value"] == 0
    assert result["checks"]["mv"]["value"] == 0 and result["checks"]["nnz"]["value"] == 0
    assert result["checks"]["psnr_db"]["value"] <= result["checks"]["psnr_db"]["limit"]


def test_the_tiny_size_is_the_configurations():
    config = cases.tiny_config(CELL)
    assert (config["width"], config["coded_height"]) == (192, 128)
    enc = config["encode"]
    assert enc["pu_decision"] and tuple(enc["pu_layouts"]) == tuple(partition.PU_LAYOUTS)
    assert tuple(enc["tu_sizes"]) == (4, 8, 16, 32) and enc["search_range"] == 8


def test_the_control_is_not_correct():
    result = _run(5, Reference(cases.tiny_config(CELL)["encode"], torch.bfloat16,
                               ["inter_yuv_rd"]))
    assert not result["correct"]
    assert result["checks"]["recon_px"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_program_is_not_correct(fault):
    """"altered": one row of one CTU's MV field off by one; "half": the bottom
    half of each plane left as the reference frame."""
    program = Program(cases.tiny_config(CELL)["encode"], "REF", ["inter_yuv_rd"])
    result = _run(5, Broken(program, fault))
    assert not result["correct"] and result["failed"] > 0
    key = "mv" if fault == "altered" else "recon_px"
    assert result["checks"][key]["value"] > 0


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    probe = ("import sys; before = set(sys.modules); import hevcbench.reference.inter_yuv_rd; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in set(sys.modules) - before})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=run.ROOT).stdout
    loaded = json.loads(out)
    assert "hevcbench" in loaded and "torch" in loaded
    assert not set(loaded) & {"hevcasm_tpu_torch", "hevcasm_tpu", "jax", "jaxlib", "flax"}


def test_the_references_rules_are_the_ports():
    """The stated lambda at every QP, and the six layouts' PU shapes."""
    assert [inter_yuv_rd._lambda(qp) for qp in range(52)] == \
        [partition.mv_lambda(qp) for qp in range(52)]
    for name, rects in partition.PU_LAYOUTS.items():
        h, w = inter_yuv_rd.PU_SIZE[name]
        assert {(rh, rw) for _, _, rh, rw in rects} == {(h, w)}
        assert len(rects) * h * w == 64 * 64
        assert [(y, x) for y, x, _, _ in rects] == [(y, x) for y in range(0, 64, h)
                                                    for x in range(0, 64, w)]
    assert inter_yuv_rd.SIX == tuple(partition.PU_LAYOUTS)


def _rd_frames() -> Trace:
    """Two RD P frames, 40 us each: the PU decision 20 us (its grids, layout
    and refinement inside), the TU decision 10 us; launches in the PU
    decision (2, one in its grids), the TU decision (1), the chroma (1) and
    one after the frames."""
    host = []
    for t0 in (0.0, 50.0):
        host += [("hevcasm.inter_yuv", t0, 40.0), ("hevcasm.luma", t0 + 1, 32.0),
                 ("hevcasm.pu_decision", t0 + 2, 20.0), ("hevcasm.pu_grids", t0 + 3, 5.0),
                 ("hevcasm.pu_layout", t0 + 9, 5.0), ("hevcasm.pu_refine", t0 + 15, 6.0),
                 ("hevcasm.tu_select", t0 + 23, 10.0), ("hevcasm.chroma", t0 + 34, 3.0),
                 ("cudaLaunchKernel", t0 + 4, 1.0), ("cuLaunchKernel", t0 + 16, 1.0),
                 ("cudaLaunchKernel", t0 + 25, 1.0), ("cudaLaunchKernel", t0 + 35, 1.0)]
    host.append(("cudaLaunchKernel", 95.0, 1.0))
    return Trace(0.0, 100.0, [("k", 0.0, 1.0)], host, frames=2)


def _read(name, trace):
    return run.reader(name).read(Record({}, 0.0, 1.0, 0, trace.frames, [], trace))


def test_rd_readers_on_a_trace_made_by_hand(capsys):
    trace = _rd_frames()
    assert _read("pu_host_ms", trace) == pytest.approx(0.020)
    assert _read("tu_host_ms", trace) == pytest.approx(0.010)
    assert _read("pu_launches", trace) == 2
    assert _read("tu_launches", trace) == 1
    assert _read("chroma_host_ms.rdo", trace) == pytest.approx(0.003)
    assert _read("luma_host_ms.rdo", trace) == pytest.approx(0.032)
    assert _read("chroma_launches.rdo", trace) == 1
    err = capsys.readouterr().err
    assert "2.0 inside hevcasm.pu_decision, 4.0 inside hevcasm.inter_yuv, 4.5 in the traced" \
        in err
    assert "entry spans coded" not in err


@pytest.mark.parametrize("name", ["pu_host_ms", "pu_launches", "tu_host_ms", "tu_launches"])
def test_rd_readers_read_nothing_without_the_decisions_spans(name):
    """A program without the RD spans (the fixed frame's, or none) and a
    run without a trace leave them nothing."""
    trace = _rd_frames()
    trace.host = [h for h in trace.host if not h[0].startswith(("hevcasm.pu_", "hevcasm.tu_"))]
    assert _read(name, trace) is None
    trace.host = [h for h in trace.host if not h[0].startswith("hevcasm.")]
    assert _read(name, trace) is None
    assert run.reader(name).read(Record({}, 0.0, 1.0, 0, 0)) is None


def test_every_span_the_rd_readers_look_for_is_recorded_by_the_program():
    for name in ("pu_host_ms", "pu_launches"):
        assert run.reader(name).PU_DECISION in SPANS
    for name in ("tu_host_ms", "tu_launches"):
        assert run.reader(name).TU_SELECT in SPANS


def test_b14_roofline_at_1080p():
    ops, nbytes = b14.cost(G1080)
    # 510 CTUs x 64 sub-blocks x 65^2 displacements x 64 terms.
    assert ops == 2 * 510 * 64 * 65 * 65 * 64
    # The CTUs, the plane cut to R of padding, and the int32 grids: 552 MB.
    assert nbytes == 510 * 4096 + 1152 * 1984 + 510 * 64 * 65 * 65 * 4
    assert roofline.bound_s(ops, nbytes) == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.1660, abs=5e-5)


def test_b13_roofline_at_1080p():
    ops, nbytes = b13.cost(G1080)
    tiles = 510 * 64
    assert ops == tiles * (2 * (4 * 15 * 8 * 8 + 16 * 64 * 8) + 2 * 16 * 64)
    # The tiles, the padded plane, the offsets; the costs and the windows.
    assert nbytes == tiles * 64 + 1159 * 1991 + tiles * 8 + tiles * (64 + 225)
    # Bound by the bytes: 0.0042 ms, chip_smoke's bound column for B13 at 8x8.
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0042, abs=5e-5)


def test_chroma_pu_roofline_at_1080p(monkeypatch):
    ops, nbytes = chroma_pu.cost(G1080)
    # Four 960 x 544 planes read, two written; the MV field of 510 x 64 MVs.
    assert nbytes == 6 * 960 * 544 + 510 * 64 * 8 + 8
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0010, abs=5e-5)
    # The counter is the program's, and 0 where the program has no kernel.
    assert chroma_pu.LAUNCHES.launches == chroma_fused.chroma_pu_fused.launches
    monkeypatch.delattr(chroma_fused, "chroma_pu_fused")
    assert chroma_pu.LAUNCHES.launches == 0
