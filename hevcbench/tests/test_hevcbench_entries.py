"""Entry points found by name: a configuration's "entries" bind both sides'
functions to the Program and the Reference, and the harness refuses, before
set-up, an entry with a side missing, an entry point that clashes, and an
encode field that neither the reference nor an entry's reference side
codes.  The fixture's cell (tests/fixture: a configuration naming pair_yuv,
driven by gop_closed through its mix's "entry") runs, and fails its
control and every fault, in the tests of cells and of the control."""

import pytest
import torch

from hevcbench import content, lookup, run
from hevcbench.program import Program
from hevcbench.reference.encoder import FIELDS, Reference
from hevcbench.tests.cases import (FIXTURE_CELLS, FIXTURE_DIRS, assert_entries_found, tiny,
                                   tiny_config)

CELL = FIXTURE_CELLS[0]
ENC = {"search_range": 8, "qp": 32}


def test_the_fixtures_files_are_found_by_name():
    _, cell, config, mix = run.load_cell(CELL, FIXTURE_DIRS)
    assert config["entries"] == ["pair_yuv"] and mix["entry"] == "pair_yuv"
    assert (lookup.BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    assert_entries_found(config, mix, FIXTURE_DIRS)
    with pytest.raises(KeyError):
        run.load_cell(CELL)                  # not a cell of BENCHMARK.json


def test_named_entries_are_bound_on_both_sides():
    enc = tiny_config(CELL)["encode"]
    program = Program(enc, "REF", ["pair_yuv"], FIXTURE_DIRS)
    reference = Reference(enc, entries=["pair_yuv"], dirs=FIXTURE_DIRS)
    assert program.pair_yuv.__self__ is program and reference.pair_yuv.__self__ is reference
    assert program.pair_yuv.__func__.__module__ != reference.pair_yuv.__func__.__module__


def test_a_configuration_without_entries_builds_the_plain_objects():
    enc = {k: v for k, v in tiny_config(CELL)["encode"].items() if k != "intra_mode"}
    assert set(vars(Program(enc, "REF"))) == {"cfg", "tiers", "_video", "_cfgs"}
    assert set(vars(Reference(enc))) == {"cfg", "ctu", "tu", "intra_block", "r", "qp", "strong",
                                         "dtype"}


def test_an_entrys_fields_add_to_the_references():
    assert "intra_mode" not in FIELDS
    with pytest.raises(ValueError, match="intra_mode"):
        Reference({**ENC, "intra_mode": "wavefront"})
    Reference({**ENC, "intra_mode": "wavefront"}, entries=["pair_yuv"], dirs=FIXTURE_DIRS)
    with pytest.raises(ValueError, match="intra_mode"):
        Reference({**ENC, "intra_mode": "open_loop"}, entries=["pair_yuv"], dirs=FIXTURE_DIRS)


def _no_setup(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("set-up began")

    monkeypatch.setattr(content, "make_pool", refuse)


def _run(overrides, where=FIXTURE_DIRS):
    return run.run_cell(CELL, 7, 0.5, False, device="cpu", tiers="REF",
                        overrides=run.merge(tiny(CELL), overrides), dirs=where)


def _side(root, side, name, source):
    (root / side).mkdir(exist_ok=True)
    (root / side / f"{name}.py").write_text(source)


@pytest.mark.parametrize("missing", lookup.SIDES)
def test_an_entry_with_a_side_missing_is_refused_before_setup(missing, tmp_path, monkeypatch):
    _no_setup(monkeypatch)
    present = next(s for s in lookup.SIDES if s != missing)
    _side(tmp_path, present, "lonely", "def lonely(obj, frames):\n    return {}\n")
    where = (tmp_path, *FIXTURE_DIRS)
    with pytest.raises(ValueError, match=f"'lonely' has no {missing} side"):
        _run({"config": {"entries": ["pair_yuv", "lonely"]}}, where)
    with pytest.raises(ValueError, match="no reference side" if missing == "reference" else
                       "no entries side"):
        Program(tiny_config(CELL)["encode"], "REF", ["lonely"], where)


def test_entries_whose_functions_differ_are_refused(tmp_path, monkeypatch):
    _no_setup(monkeypatch)
    _side(tmp_path, "entries", "odd", "def odd(obj, frames):\n    return {}\n")
    _side(tmp_path, "reference", "odd", "def even(obj, frames):\n    return {}\n")
    with pytest.raises(ValueError, match="defines"):
        _run({"config": {"entries": ["odd"]}}, (tmp_path, *FIXTURE_DIRS))


@pytest.mark.parametrize("clash", ["inter_yuv", "pair_yuv"])
def test_an_entry_point_that_clashes_is_refused_before_setup(clash, tmp_path, monkeypatch):
    """One that the objects already have, or that another named entry gives."""
    _no_setup(monkeypatch)
    for side in lookup.SIDES:
        _side(tmp_path, side, "twin", f"def {clash}(obj, frames):\n    return {{}}\n")
    with pytest.raises(ValueError, match=f"'{clash}' .* clashes"):
        _run({"config": {"entries": ["pair_yuv", "twin"]}}, (tmp_path, *FIXTURE_DIRS))


@pytest.mark.parametrize("field", [{"pu_layouts": ["2Nx2N"]}, {"me_metric": "sad"},
                                   {"intra_mode": "open_loop"}])
def test_a_field_no_fields_list_takes_is_refused_before_setup(field, monkeypatch):
    _no_setup(monkeypatch)
    with pytest.raises(ValueError, match=next(iter(field))):
        _run({"config": {"encode": field}})


def test_the_fixtures_control_is_refused_by_the_check_not_by_its_fields():
    """The control is built with the configuration's entries, so it codes
    the fixture's fields and puts bfloat16 products in pair_yuv's place."""
    enc = tiny_config(CELL)["encode"]
    control = Reference(enc, torch.bfloat16, ["pair_yuv"], FIXTURE_DIRS)
    assert control.dtype == torch.bfloat16 and callable(control.pair_yuv)
