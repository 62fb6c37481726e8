"""BENCHMARK.json: names, units and lengths of the allowed characters, and
every file it names, or finds by a name, in place."""

import json
import re

import pytest

from hevcbench import run
from hevcbench.tests.cases import assert_entries_found

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _lines(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _lines(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _lines(c["source"]) and _lines(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _lines(m["layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(_lines(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32


def test_bounds_and_run_seconds():
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    _, c, config, mix = run.load_cell(cell)
    assert (run.BENCH / "drivers" / f"{mix['driver']}.py").exists()
    for m in run.cell_metrics(BENCH, cell, False) + run.cell_metrics(BENCH, cell, True):
        assert hasattr(run.reader(m["name"]), "read")
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert (run.ROOT / conf["file"]).exists()
    assert set(conf["reduced"]) == set(config["reduced"])
    assert set(config["reduced"]) <= set(config) | set(config["encode"])
    assert_entries_found(config, mix)


def test_every_per_layer_metric_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert cell in moved.get("workloads", [cell])
