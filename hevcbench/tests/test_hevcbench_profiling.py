"""The trace's breakdown: idle time by the innermost host record running as
each gap began, found however many records began and ended inside it."""

from hevcbench.profiling import Trace, host_ops_at


def test_a_long_record_is_found_behind_many_short_ones():
    host = [("hevcasm.intra_wave", 0.0, 10_000.0)]
    host += [("aten::add", 1.0 + 2.0 * i, 1.0) for i in range(1000)]
    assert host_ops_at(host, [1.5, 2.5, 5_000.0, 10_000.0, 10_001.0]) == [
        "aten::add", "hevcasm.intra_wave", "hevcasm.intra_wave", "hevcasm.intra_wave", "python"]


def test_the_innermost_of_nested_records_and_none_before_the_first():
    host = [("b", 2.0, 4.0), ("a", 0.0, 10.0), ("c", 3.0, 1.0), ("d", 12.0, 1.0)]
    assert host_ops_at(host, [-1.0, 1.0, 3.5, 5.0, 7.0, 11.0, 12.5]) == [
        "python", "a", "c", "b", "a", "python", "d"]


def test_the_breakdown_names_the_gap_behind_many_short_records():
    host = [("hevcasm.gop_closed_yuv", 0.0, 20_000.0), ("hevcasm.intra_wave", 1.0, 15_000.0)]
    host += [("cudaLaunchKernel", 2.0 + 10.0 * i, 1.0) for i in range(1000)]
    device = [("k", 2.0 + 10.0 * i, 2.0) for i in range(1000)]
    trace = Trace(0.0, 20_000.0, device, host)
    idle = dict(trace.breakdown()["idle_gaps"])
    assert "python" not in idle
    assert idle["hevcasm.intra_wave"] > idle["hevcasm.gop_closed_yuv"] > 0
