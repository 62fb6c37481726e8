"""Kernel B4 of hevcasm_tpu_torch (residual_pipeline_ctu: the TU residual
pipeline of 64x64 CTUs): its plain version against the JAX kernel in
interpret mode on the CPU, following tests/test_residual_pallas.py: TU
sizes 4, 8, 16 and 32, the DST-VII at 4, several qps.  rec and the per-TU
nnz must be equal.  The kernel itself is held against its plain version in
test_torch_cuda.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import EncodeConfig as JaxConfig
from hevcasm_tpu.kernels.residual_pallas import residual_pipeline_ctu as jax_residual_ctu

from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import residual_ctu
from hevcasm_tpu_torch.ops.residual import residual_pipeline


def blocks(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 64, 64), dtype=np.uint8),
            rng.integers(0, 256, (n, 64, 64), dtype=np.uint8))


def qargs(qp, tu, intra=False):
    cfg = dataclasses.replace(EncodeConfig(qp=qp), tu=tu)
    theirs = dataclasses.replace(JaxConfig(qp=qp), tu=tu)
    assert cfg.quant_params(intra) == theirs.quant_params(intra)
    assert cfg.dequant_params() == theirs.dequant_params()
    return (*cfg.quant_params(intra), *cfg.dequant_params())


@pytest.mark.parametrize("tu,tr_type,qp", [(4, 0, 32), (4, 1, 27), (8, 0, 32), (8, 0, 4),
                                           (8, 0, 45), (16, 0, 22), (32, 0, 37), (32, 0, 0)])
def test_plain_b4_matches_jax_kernel(tu, tr_type, qp):
    src, pred = blocks(3, tu + qp)
    q = qargs(qp, tu, intra=bool(tr_type))
    want = jax_residual_ctu(jnp.asarray(src), jnp.asarray(pred), *q, tu=tu, tr_type=tr_type)
    got = residual_ctu.residual_pipeline_ctu(src, pred, *q, tu=tu, tr_type=tr_type)
    for name, g, w in zip(("rec", "nnz_tu"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_plain_b4_equals_the_composed_pipeline():
    src, pred = blocks(2, 9)
    q = qargs(32, 16)
    rec, nnz_tu = residual_ctu.residual_pipeline_ctu_ref(src, pred, *q, tu=16)
    rec_s, nnz_s, cbf = residual_pipeline(src, pred, *q, tu=16)
    assert torch.equal(rec, rec_s) and int(nnz_tu.sum()) == int(nnz_s)
    assert torch.equal((nnz_tu > 0).reshape(-1), cbf)


def test_b4_wrapper_checks_counts_and_registry():
    src, pred = blocks(2, 1)
    q = qargs(32, 8)
    before = residual_ctu.residual_pipeline_ctu.launches
    residual_ctu.residual_pipeline_ctu(src, pred, *q)
    assert residual_ctu.residual_pipeline_ctu.launches == before   # CPU: the plain version
    with pytest.raises(ValueError, match="DST"):
        residual_ctu.residual_pipeline_ctu(src, pred, *q, tu=8, tr_type=1)
    with pytest.raises(ValueError, match="tu="):
        residual_ctu.residual_pipeline_ctu(src, pred, *q, tu=64)
    with pytest.raises(ValueError, match="src and pred"):
        residual_ctu.residual_pipeline_ctu(src[:, :32, :32], pred[:, :32, :32], *q)
    with pytest.raises(ValueError, match="shift"):
        residual_ctu.residual_pipeline_ctu(src, pred, q[0], 30, *q[2:])
    assert registry.get("residual_pipeline_ctu", Tier.REF) is \
        residual_ctu.residual_pipeline_ctu_ref
    assert registry.tiers_of("residual_pipeline_ctu") == Tier.REF | Tier.KERNEL


@pytest.mark.parametrize("b,tu", [(64, 8), (32, 4)])
def test_kernel_tier_of_residual_pipeline_keeps_its_contract(b, tu):
    # The KERNEL tier of the registry's residual_pipeline runs B4 on
    # (n, 64, 64) CUDA stacks and the plain pipeline on CPU tensors of any
    # block size, with the plain version's (rec, nnz, cbf).
    rng = np.random.default_rng(b)
    src = torch.as_tensor(rng.integers(0, 256, (3, b, b), dtype=np.uint8))
    pred = torch.as_tensor(rng.integers(0, 256, (3, b, b), dtype=np.uint8))
    q = qargs(30, tu)
    got = residual_ctu.residual_pipeline_kernel(src, pred, *q, tu=tu)
    want = residual_pipeline(src, pred, *q, tu=tu)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
