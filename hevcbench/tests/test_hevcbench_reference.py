"""The plain reference bit-equal to the program's plain (REF) tier at a tiny
size: every entry point the cells drive, on content with sub-pel motion."""

import numpy as np
import pytest
import torch

from hevcbench import content, run
from hevcbench.reference import ops
from hevcbench.reference.encoder import Reference
from hevcbench.program import Program

ENC = {"ctu": 64, "tu": 8, "intra_block": 32, "search_range": 8, "qp": 32,
       "inter_impl": "fused_dma", "strong_intra_smoothing": True}


@pytest.fixture(scope="module")
def pool():
    _, _, _, mix = run.load_cell("ldp1080_live")
    return content.make_pool(256, 120, 128, dict(mix["content"], frames=4), 11, "cpu")


def _eq(a, b):
    return torch.equal(torch.as_tensor(a).to(torch.int64), torch.as_tensor(b).to(torch.int64))


@pytest.mark.parametrize("qp", [22, 32, 37])
def test_inter_yuv(pool, qp):
    enc = dict(ENC, qp=qp)
    cur = tuple(p[2] for p in pool)
    ref = tuple(p[1] for p in pool)
    got = Program(enc, "REF").inter_yuv(cur, ref)
    want = Reference(enc).inter_yuv(cur, ref)
    assert all(_eq(g, w) for g, w in zip(got["recon"], want["recon"]))
    assert _eq(got["mvs"], want["mvs"]) and int(got["nnz"]) == want["nnz"]
    assert (got["mvs"] % 4 != 0).any()        # the content gives sub-pel MVs
    for k in ("psnr_y", "psnr_cb", "psnr_cr"):
        assert abs(float(got[k]) - want[k]) < 1e-4


def test_intra(pool):
    got = Program(ENC, "REF").intra_seed_yuv(tuple(p[0] for p in pool))
    want = Reference(ENC).intra_seed_yuv(tuple(p[0] for p in pool))
    assert all(_eq(g, w) for g, w in zip(got["recon"], want["recon"]))
    assert abs(float(got["psnr_y"]) - want["psnr_y"]) < 1e-4


def test_gop_yuv(pool):
    frames = tuple(p[:3] for p in pool)
    got = Program(ENC, "REF").gop_yuv(frames)
    want = Reference(ENC).gop_yuv(frames)
    assert all(_eq(g, w) for g, w in zip(got["recon"], want["recon"]))
    assert np.allclose(got["psnr_y"].tolist(), want["psnr_y"], atol=1e-4)


def test_a_frames_qp_replaces_the_configurations(pool):
    """The live driver's QP offsets: a frame entry's qp codes that frame at
    it, on both sides, and differs from the configuration's."""
    prog, ref = Program(ENC, "REF"), Reference(ENC)
    cur, prev = tuple(p[2] for p in pool), tuple(p[1] for p in pool)
    got, want = prog.inter_yuv(cur, prev, 35), ref.inter_yuv(cur, prev, 35)
    assert all(_eq(g, w) for g, w in zip(got["recon"], want["recon"]))
    assert int(got["nnz"]) == want["nnz"] != ref.inter_yuv(cur, prev)["nnz"]


@pytest.mark.parametrize("field", [{"me_metric": "sad"}, {"me_strategy": "pyramid"},
                                   {"pu_decision": True}, {"tu_sizes": [4, 8, 16, 32]},
                                   {"intra_block": 16}, {"intra_mode": "wavefront"},
                                   {"no_such_field": 1}])
def test_reference_refuses_what_it_does_not_code(field):
    with pytest.raises(ValueError):
        Reference(dict(ENC, **field))


@pytest.mark.parametrize("field", [{"me_metric": "ssd"}, {"tu_sizes": []},
                                   {"inter_impl": "stages"}, {"search_impl": "grid"}])
def test_reference_takes_what_it_codes(field):
    Reference(dict(ENC, **field))


def test_transform_matrix_is_the_standards():
    from hevcasm_tpu_torch.ops.transform import DCT32

    assert np.array_equal(ops.dct_matrix(32), DCT32)
    assert ops.dct_matrix(4).tolist() == [[64, 64, 64, 64], [83, 36, -36, -83],
                                          [64, -64, -64, 64], [36, -83, 83, -36]]
