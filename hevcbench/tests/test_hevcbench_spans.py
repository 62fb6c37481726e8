"""The span metrics, the readers of the program's "hevcasm." spans: a traced
tiny CPU run of each cell reports its host-time metrics above 0 and leaves
out the launch metrics (the CPU leaves no launch record); on a trace made
by hand each reads what its docstring says; on a trace with no span (a
program that records none) each returns None."""

import json

import pytest

from hevcbench import run, spans
from hevcbench.profiling import Trace
from hevcbench.record import Record
from hevcbench.tests.cases import CELLS, tiny_run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
HOST = ("chroma_host_ms", "luma_host_ms", "intra_host_ms")
LAUNCHES = ("chroma_launches", "intra_launches")
SHARE = "idle_in_program_share"
NEW = HOST + LAUNCHES + (SHARE,)


def _read(name, trace):
    return run.reader(name).read(Record({}, 0.0, 1.0, 0, trace.frames, [], trace))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reports_the_span_metrics(cell, capsys):
    result, lines = tiny_run(cell, 2**31 + 23, 0.5, True)
    err = capsys.readouterr().err
    assert result["correct"], lines
    # A metric is read by its stem's reader: idle_in_program_share.live too.
    want = {m["name"].split(".")[0]: m["name"] for m in run.cell_metrics(BENCH, cell, True)
            if m["name"].split(".")[0] in NEW}
    got = {k.split(".")[0]: v for k, v in result["metrics"].items()}
    assert SHARE in want and 0.0 <= got[SHARE]["value"] <= 1.0
    assert want.keys() & set(HOST)
    for name in want.keys() & set(HOST):
        assert got[name]["value"] > 0, name
    assert not set(LAUNCHES) & set(got)
    assert "entry spans coded" not in err
    assert "device records named hevcasm.*: 0" in err


def test_every_span_a_reader_looks_for_is_recorded_by_the_program():
    from hevcasm_tpu_torch.utils.trace import SPANS

    assert set(spans.READ) <= set(SPANS)
    assert all(name.startswith(spans.PREFIX) for name in SPANS)


def _p_frames() -> Trace:
    """Two P frames: luma 10 us each, chroma 20 and 10 us, a launch inside
    the first frame's luma, two inside its chroma, one inside the second's
    chroma and one after both frames."""
    host = [("hevcasm.inter_yuv", 0.0, 40.0), ("hevcasm.luma", 1.0, 10.0),
            ("hevcasm.chroma", 12.0, 20.0), ("hevcasm.inter_yuv", 50.0, 40.0),
            ("hevcasm.luma", 51.0, 10.0), ("hevcasm.chroma", 62.0, 10.0),
            ("cudaLaunchKernel", 5.0, 1.0), ("cudaLaunchKernel", 13.0, 1.0),
            ("cuLaunchKernel", 20.0, 1.0), ("cudaLaunchKernelExC", 63.0, 1.0),
            ("cudaLaunchKernel", 95.0, 1.0), ("aten::add", 13.0, 2.0)]
    device = [("k", 0.0, 2.0), ("k", 14.0, 2.0), ("k", 45.0, 10.0), ("k", 92.0, 2.0)]
    return Trace(0.0, 100.0, device, host, frames=2)


def test_p_frame_readers_on_a_trace_made_by_hand(capsys):
    trace = _p_frames()
    assert _read("chroma_host_ms", trace) == pytest.approx(0.015)
    assert _read("luma_host_ms", trace) == pytest.approx(0.010)
    assert _read("chroma_launches", trace) == 1.5
    assert "2.0 inside hevcasm.inter_yuv" in capsys.readouterr().err
    # Idle gaps (2, 14) in luma, (16, 45) in chroma, (55, 92) in luma and
    # (94, 100) outside every span.
    assert _read(SHARE, trace) == pytest.approx(78 / 84)
    err = capsys.readouterr().err
    assert "hevcasm.luma 4.9e-05" in err and "outside 6e-06" in err
    assert "entry spans coded" not in err


def test_gop_readers_on_a_trace_made_by_hand(capsys):
    host = [("hevcasm.gop_closed_yuv", 0.0, 100.0), ("hevcasm.intra", 1.0, 30.0),
            ("hevcasm.inter_yuv", 40.0, 20.0), ("hevcasm.inter_yuv", 70.0, 20.0),
            ("cudaLaunchKernel", 5.0, 1.0), ("cudaLaunchKernel", 10.0, 1.0),
            ("cudaLaunchKernel", 50.0, 1.0)]
    trace = Trace(0.0, 100.0, [("k", 0.0, 1.0)], host, frames=3)
    assert _read("intra_host_ms", trace) == pytest.approx(0.030)
    assert _read("intra_launches", trace) == 2
    assert "entry spans coded" not in capsys.readouterr().err
    trace.frames = 4
    _read("intra_host_ms", trace)
    assert "1 entry spans coded 3 frames; the trace coded 4" in capsys.readouterr().err


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_from_a_program_without_spans(name):
    trace = _p_frames()
    trace.host = [h for h in trace.host if not h[0].startswith(spans.PREFIX)]
    assert _read(name, trace) is None
    assert run.reader(name).read(Record({}, 0.0, 1.0, 0, 0)) is None
