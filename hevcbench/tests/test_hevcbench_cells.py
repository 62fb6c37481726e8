"""Every cell's driver end to end at a tiny size on the CPU, on the
program's plain (REF) tier, with tracing off and on: the cells of
BENCHMARK.json and the fixture's, whose configuration names an entry point."""

import json

import pytest

from hevcbench import run
from hevcbench.tests.cases import CELLS, FIXTURE_CELLS, dirs, tiny_run


@pytest.mark.parametrize("cell", CELLS + FIXTURE_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    result, lines = tiny_run(cell, 2**31 + 17, 1.5, trace)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["attempted"] > 0
    json.dumps(result)                                  # one JSON line
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    bench, _, _, _ = run.load_cell(cell, dirs(cell))
    want = {m["name"] for m in run.cell_metrics(bench, cell, trace)}
    if not trace:
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        # On the CPU the card's records are empty: no kernel share is read.
        assert not any(k.startswith("k1_roofline") for k in result["metrics"])
        assert {k for k in result["metrics"] if k.startswith("host_call_ms")} == \
            {k for k in want if k.startswith("host_call_ms")}
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_main_refuses_without_a_card(capsys):
    """A measuring run on a machine without a CUDA card fails and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "ldp1080_live", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""
    assert "CUDA" in err


def test_main_refuses_an_unknown_cell(capsys):
    assert run.main(["--workload", "no_such_cell", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
