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
from hevcbench.tests.cases import CELLS, TINY


def _enc(cell, **extra):
    _, _, config, _ = run.load_cell(cell)
    return {**config["encode"], **extra}


class Broken:
    """The program with one fault planted where its answers are produced."""

    def __init__(self, program, fault: str):
        self.p, self.fault = program, fault

    def _frame(self, out, refs):
        planes = list(out["recon"])
        if self.fault == "unchanged":        # the step returns its state unchanged
            planes = [r.clone() for r in refs]
        elif self.fault == "half":           # the bottom half of the CTUs left out
            for p, r in zip(planes, refs):
                p[p.shape[0] // 2:] = r[r.shape[0] // 2:]
        elif self.fault == "altered":        # one answer altered where it is produced
            out["mvs"] = out["mvs"].clone()
            out["mvs"][0, 1] += 1
        out["recon"] = tuple(planes)
        return out

    def inter_yuv(self, cur, ref, qp=None):
        return self._frame(self.p.inter_yuv(cur, ref, qp), ref)

    def intra_seed_yuv(self, cur):
        return self.p.intra_seed_yuv(cur)

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

    def gop_yuv(self, frames):
        out = self.p.gop_yuv(frames)
        out["recon"] = tuple(self._gop(p) for p in out["recon"])
        return out


def _tiny_run(cell, api, seed=5):
    result, lines = run.run_cell(cell, seed, 0.5, False, device="cpu", tiers="REF", api=api,
                                 overrides=TINY)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result = _tiny_run(cell, Reference(_enc(cell, search_range=8), torch.bfloat16))
    assert not result["correct"]
    assert result["checks"]["recon_px"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_products_in_the_programs_place_are_correct(cell, dtype):
    """float32 products give the same integers as float64 on this content
    (their partial sums stay below 2^24), so the control takes the next
    precision down, bfloat16."""
    assert _tiny_run(cell, Reference(_enc(cell, search_range=8), dtype))["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_program_is_not_correct(cell, fault):
    api = Broken(Program(_enc(cell, search_range=8), "REF"), fault)
    result = _tiny_run(cell, api)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        result, _ = run.run_cell(cell, seed, 2.0, False,
                                 api=Reference(_enc(cell), torch.bfloat16))
        assert not result["correct"], (cell, seed)
