"""The comparison that decides ``correct`` fails what it must: the control
(the reference computed with bfloat16 products in the program's place) and
a run whose timed path is broken underneath, once for each fault a cell
can have.  (The cells run on one card, so no fault of an exchange between
cards applies.)  The harness's look for a card is skipped: run_cell drives
the rest of a run on the CPU at a tiny size.

The control at each cell's own size runs on the card (marked cuda)."""

import pytest
import torch

from hevcbench import run
from hevcbench.program import Program
from hevcbench.reference.encoder import Reference
from hevcbench.tests.cases import CELLS, FIXTURE_CELLS, dirs, tiny_config, tiny_run

#: The cells of BENCHMARK.json and the fixture's, whose configuration names
#: an entry point of its own.
ALL_CELLS = CELLS + FIXTURE_CELLS


def _frames(args) -> list:
    """The (y, cb, cr) frames among an entry's inputs."""
    return [a for a in args if isinstance(a, (tuple, list)) and a
            and all(isinstance(p, torch.Tensor) for p in a)]


class Broken:
    """The program with one fault planted where its answers are produced,
    in any entry point's outputs, by key: the "recon" planes (a frame's, or
    each frame's of a GOP's stacks), "mvs"; an entry whose outputs are one
    frame coded from no reference (the I frame) is left as it is."""

    def __init__(self, program, fault: str):
        self.p, self.fault = program, fault

    def __getattr__(self, name):
        entry = getattr(self.p, name)

        def broken(*args, **kwargs):
            out = entry(*args, **kwargs)
            planes = list(out["recon"])
            if planes[0].dim() == 3:
                out["recon"] = tuple(self._gop(p) for p in planes)
                return out
            refs = _frames(args)[1:]
            return self._frame(out, planes, refs[-1]) if refs else out

        return broken

    def _frame(self, out, planes, refs):
        if self.fault == "unchanged":        # the step returns its state unchanged
            planes = [r.clone() for r in refs]
        elif self.fault == "half":           # the bottom half of the CTUs left out
            for p, r in zip(planes, refs):
                p[p.shape[0] // 2:] = r[r.shape[0] // 2:]
        elif self.fault == "altered":        # one answer altered where it is produced
            if "mvs" in out:
                out["mvs"] = out["mvs"].clone()
                out["mvs"][0, 1] += 1
            else:
                planes[0] = planes[0].clone()
                planes[0][0, 0] ^= 1
        out["recon"] = tuple(planes)
        return out

    def _gop(self, rec):
        rec = rec.clone()
        for t in range(1, rec.shape[0]):
            if self.fault == "unchanged":
                rec[t] = rec[t - 1]
            elif self.fault == "half":
                rec[t, rec.shape[1] // 2:] = rec[t - 1, rec.shape[1] // 2:]
            elif self.fault == "altered":
                rec[t, 0, 0] ^= 1
        return rec


def _reference(cell, dtype):
    config = tiny_config(cell)
    return Reference(config["encode"], dtype, config.get("entries", []), dirs(cell))


def _program(cell):
    config = tiny_config(cell)
    return Program(config["encode"], "REF", config.get("entries", []), dirs(cell))


def _tiny_run(cell, api, seed=5):
    result, lines = tiny_run(cell, seed, 0.5, api=api)
    return result


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_is_not_correct(cell):
    result = _tiny_run(cell, _reference(cell, torch.bfloat16))
    assert not result["correct"]
    assert result["checks"]["recon_px"]["value"] > 0


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_products_in_the_programs_place_are_correct(cell, dtype):
    """float32 products give the same integers as float64 on this content
    (their partial sums stay below 2^24), so the control takes the next
    precision down, bfloat16."""
    assert _tiny_run(cell, _reference(cell, dtype))["correct"]


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_program_is_not_correct(cell, fault):
    result = _tiny_run(cell, Broken(_program(cell), fault))
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    _, _, config, _ = run.load_cell(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        result, _ = run.run_cell(cell, seed, 2.0, False,
                                 api=Reference(config["encode"], torch.bfloat16,
                                               config.get("entries", [])))
        assert not result["correct"], (cell, seed)
