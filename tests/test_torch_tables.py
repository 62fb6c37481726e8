"""hevcasm_tpu_torch's constant tables and EncodeConfig against hevcasm_tpu's:
the same tables, the same guards with the same messages, and the same
quantizer parameters."""

import dataclasses

import numpy as np
import pytest

import importlib

from hevcasm_tpu.encode import loop as jloop
from hevcasm_tpu.encode import partition as jpartition
from hevcasm_tpu.ops import pred_inter as jpred
from hevcasm_tpu.ops import transform as jtransform

import torch_testing  # noqa: F401
from hevcasm_tpu_torch.encode import loop as tloop
from hevcasm_tpu_torch.ops import pred_inter as tpred
from hevcasm_tpu_torch.ops import transform as ttransform

# The ops packages export functions named like these modules.
jintra = importlib.import_module("hevcasm_tpu.ops.pred_intra")
jsatd = importlib.import_module("hevcasm_tpu.ops.satd")
tintra = importlib.import_module("hevcasm_tpu_torch.ops.pred_intra")
tsatd = importlib.import_module("hevcasm_tpu_torch.ops.satd")


@pytest.mark.parametrize("name,theirs,ours", [
    ("KERNEL8", jpred.KERNEL8, tpred.KERNEL8),
    ("KERNEL4", jpred.KERNEL4, tpred.KERNEL4),
    ("DCT32", jtransform.DCT32, ttransform.DCT32),
    ("DST4", jtransform.DST4, ttransform.DST4),
    ("QUANT_SCALES", jloop.QUANT_SCALES, tloop.QUANT_SCALES),
    ("DEQUANT_SCALES", jloop.DEQUANT_SCALES, tloop.DEQUANT_SCALES),
    ("INVERSE_SHIFTS", jtransform.INVERSE_SHIFTS, ttransform.INVERSE_SHIFTS),
    ("PU_LAYOUTS", tuple(jpartition.PU_LAYOUTS), tloop.PU_LAYOUT_NAMES),
])
def test_tables_equal(name, theirs, ours):
    assert np.asarray(ours).dtype == np.asarray(theirs).dtype, name
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs), err_msg=name)


@pytest.mark.parametrize("name", ["ANGLES", "INV_ANGLES", "_FILTER_THRES"])
def test_intra_tables_equal(name):
    assert getattr(tintra, name) == getattr(jintra, name)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_hadamard_matrix_equal(n):
    ours, theirs = tsatd.hadamard_matrix(n), jsatd.hadamard_matrix(n)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dct_matrix_and_shifts_equal(n):
    np.testing.assert_array_equal(ttransform.dct_matrix(n), jtransform.dct_matrix(n))
    log2 = n.bit_length() - 1
    assert ttransform.forward_shifts(log2) == jtransform.forward_shifts(log2)


# Every guard of hevcasm_tpu's EncodeConfig.__post_init__.
_BAD_CONFIGS = [
    dict(me_metric="sadd"),
    dict(me_strategy="diamond"),
    dict(search_impl="slabs"),
    dict(refine_impl="fast"),
    dict(residual_impl="cuda"),
    dict(intra_mode="closed"),
    dict(inter_impl="fused_tma"),
    dict(search_impl="slab", search_range=8),
    dict(search_impl="mv", me_metric="sad"),
    dict(search_impl="dma", me_strategy="pyramid"),
    dict(search_impl="slab", ctu=32),
    dict(inter_impl="mega", me_metric="sad"),
    dict(inter_impl="mega", me_strategy="pyramid"),
    dict(inter_impl="mega", tu_sizes=(8, 16)),
    dict(inter_impl="mega", pu_decision=True),
    dict(inter_impl="fused", tu=4),
    dict(inter_impl="fused_batched", tu=16),
    dict(inter_impl="fused_dma", tu=32),
    dict(pu_layouts=("2Nx2N", "ninth")),
]


@pytest.mark.parametrize("kwargs", _BAD_CONFIGS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_config_guards_match(kwargs):
    with pytest.raises(ValueError) as theirs:
        jloop.EncodeConfig(**kwargs)
    with pytest.raises(ValueError) as ours:
        tloop.EncodeConfig(**kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(search_range=32, qp=32, inter_impl="fused_dma"),
    dict(search_range=8, qp=22, inter_impl="stages", refine_impl="ref",
         residual_impl="ref", tu=4, pu_layouts=("2Nx2N", "eighth")),
    dict(tu_sizes=(8, 16), pu_decision=True, intra_mode="wavefront"),
])
def test_config_from_fields_round_trips(kwargs):
    theirs = jloop.EncodeConfig(**kwargs)
    ours = tloop.config_from_fields(dataclasses.asdict(theirs))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]


def test_config_from_fields_runs_the_guards():
    fields = dataclasses.asdict(jloop.EncodeConfig())
    with pytest.raises(ValueError, match="inter_impl"):
        tloop.config_from_fields({**fields, "inter_impl": "fused_tma"})
    with pytest.raises(ValueError, match="unknown EncodeConfig fields"):
        tloop.config_from_fields({**fields, "gop": 8})
    # Lists, as a JSON round trip gives them, become tuples.
    ours = tloop.config_from_fields({**fields, "tu_sizes": [8, 16]})
    assert ours.tu_sizes == (8, 16)


@pytest.mark.parametrize("tu", [4, 8, 16, 32])
def test_quant_params_equal(tu):
    for qp in range(52):
        theirs = jloop.EncodeConfig(qp=qp, tu=tu)
        ours = tloop.EncodeConfig(qp=qp, tu=tu)
        for intra in (False, True):
            assert ours.quant_params(intra) == theirs.quant_params(intra), (qp, intra)
        assert ours.dequant_params() == theirs.dequant_params(), qp
