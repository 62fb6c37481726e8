"""The cells at a tiny size, shared by the benchmark's CPU tests: every cell
of BENCHMARK.json, found there, so that a cell added later is tested with
no edit here."""

import json

from hevcbench import lookup, run

#: Every cell at a size the CPU codes in about a second: 256x128 frames
#: (coded from 120 rows), R = 8, a pool of 8 frames, GOPs of 4.  A cell's
#: configuration or mix file may add its own "tiny" object (tiny()).
TINY = {"config": {"width": 256, "height": 120, "coded_height": 128,
                   "encode": {"search_range": 8}},
        "mix": {"content": {"frames": 8}, "warmup_steps": 2, "trace_steps": 2,
                "check_pairs": 2, "gop": 4, "check_gops": 1}}

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(sorted(w["name"] for w in BENCH["workloads"]))

#: A test-only cell whose configuration names an entry point (pair_yuv),
#: in a directory of its own that the harness searches before its own.
FIXTURE = run.BENCH / "tests" / "fixture"
FIXTURE_DIRS = (FIXTURE, run.BENCH)
FIXTURE_CELLS = tuple(w["name"] for w in
                      json.loads((FIXTURE / "cells.json").read_text())["workloads"])


def dirs(cell: str) -> tuple:
    """Where the harness finds a cell's files: the fixture's directory first
    for its cells, the benchmark's own alone for the others."""
    return FIXTURE_DIRS if cell in FIXTURE_CELLS else lookup.DIRS


def tiny(cell: str) -> dict:
    """The overrides that run a cell at the tiny size: TINY, with the
    "tiny" objects of the cell's configuration and mix merged in."""
    _, _, config, mix = run.load_cell(cell, dirs(cell))
    return {"config": run.merge(TINY["config"], config.get("tiny")),
            "mix": run.merge(TINY["mix"], mix.get("tiny"))}


def tiny_config(cell: str) -> dict:
    """The cell's configuration at the tiny size."""
    _, _, config, _ = run.load_cell(cell, dirs(cell))
    return run.merge(config, tiny(cell)["config"])


def tiny_run(cell: str, seed: int, seconds: float, trace: bool = False, api=None):
    """One run of a cell at the tiny size on the CPU, on the program's plain
    (REF) tier."""
    return run.run_cell(cell, seed, seconds, trace, device="cpu", tiers="REF", api=api,
                        overrides=tiny(cell), dirs=dirs(cell))


def assert_entries_found(config: dict, mix: dict, where=lookup.DIRS) -> None:
    """Both sides of every entry point the configuration names, defining the
    same functions, and the entry the mix's driver calls on both sides."""
    from hevcbench.program import Program
    from hevcbench.reference.encoder import Reference

    named = []
    for name in config.get("entries", []):
        program, reference = (lookup.find(side, name, dirs=where) for side in lookup.SIDES)
        named += lookup.entry_names(program)
        assert sorted(lookup.entry_names(program)) == sorted(lookup.entry_names(reference))
    if "entry" in mix:
        for side in (Program, Reference):
            assert mix["entry"] in named or hasattr(side, mix["entry"]), (side, mix["entry"])
