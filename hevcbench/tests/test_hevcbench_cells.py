"""Every cell's driver end to end at a tiny size on the CPU, on the
program's plain (REF) tier, with tracing off and on."""

import json

import pytest

from hevcbench import run
from hevcbench.tests.cases import CELLS, TINY


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    result, lines = run.run_cell(cell, 2**31 + 17, 1.5, trace, device="cpu", tiers="REF",
                                 overrides=TINY)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["attempted"] > 0
    json.dumps(result)                                  # one JSON line
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    _, _, config, mix = run.load_cell(cell)
    want = {m["name"] for m in run.cell_metrics(json.load(open(run.ROOT / "BENCHMARK.json")),
                                                 cell, trace)}
    if not trace:
        assert set(result["metrics"]) == want
        assert result["metrics"]["ctus_per_s"]["value"] > 0
    else:
        # On the CPU the card's records are empty: no kernel share is read.
        assert "k1_roofline" not in result["metrics"]
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
