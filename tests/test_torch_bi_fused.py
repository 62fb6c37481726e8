"""Kernel B3 of hevcasm_tpu_torch (bi_ctu_fused_dma: both references'
quarter-pel refinements, the (p0 + p1 + 64) >> 7 combine and the 8x8
residual pipeline): its plain version against the JAX kernel in interpret
mode on the CPU, all five outputs, on two padded planes stacked by rows,
with refine windows at offset 0 and at the maximum in both planes.  The
kernel itself is held against its plain version in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels.interp_pallas import bi_ctu_fused_dma as jax_bi

from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import bi_fused
from hevcasm_tpu_torch.ops.pred_inter import pred_bi, refine_qpel
from hevcasm_tpu_torch.ops.residual import residual_pipeline

NAMES = ("rec", "frac0", "frac1", "nnz", "bits")


def case(seed, r, qp, h=128, w=192, content="shift"):
    """Six CTUs, two references padded as the loop pads them and stacked by
    rows, and refine offsets pos + mv + R (+ Hp for the lower plane) for
    random MVs: in each plane the first CTU sits at offset 0 and the last at
    the maximum.  ``content`` "constant" gives two flat planes, on which
    every fraction ties."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    cur = base[5:5 + h, 7:7 + w]
    refs = [base[:h, :w], base[9:9 + h, 2:2 + w]]
    if content == "constant":
        refs = [np.full((h, w), 97, np.uint8), np.full((h, w), 40, np.uint8)]
    planes = [np.asarray(jctu.pad_frame(jnp.asarray(p), r + 3, r + 4, r + 3, r + 4))
              for p in refs]
    hp, wp = planes[0].shape
    flat = np.concatenate(planes)
    src = np.array(jctu.tile_frame(jnp.asarray(cur), 64))
    gr, gc = h // 64, w // 64
    pos = np.asarray(jmotion.ctu_positions(gr, gc, 64))
    offsets = []
    for lower in (0, hp):
        mvs = rng.integers(-r, r + 1, (gr * gc, 2)).astype(np.int32)
        mvs[0], mvs[-1] = (-r, -r), (r, r)
        offsets.append((pos + mvs + r + [lower, 0]).astype(np.int32))
    assert offsets[0].min() == 0 and (offsets[0][-1] + 71 == (hp, wp)).all()
    assert tuple(offsets[1][0]) == (hp, 0) and (offsets[1][-1] + 71 == (2 * hp, wp)).all()
    cfg = EncodeConfig(qp=qp, inter_impl="fused_dma")
    qargs = (*cfg.quant_params(False), *cfg.dequant_params())
    return src, flat, offsets[0], offsets[1], qargs


@pytest.mark.parametrize("seed,r,qp,content", [
    (13, 8, 22, "shift"), (21, 32, 30, "shift"), (5, 8, 37, "shift"),
    (8, 8, 30, "constant")])
def test_plain_b3_matches_jax_kernel(seed, r, qp, content):
    src, flat, off0, off1, qargs = case(seed, r, qp, content=content)
    want = jax_bi(jnp.asarray(src), jnp.asarray(flat), jnp.asarray(off0),
                  jnp.asarray(off1), *qargs, group=6)
    got = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if content == "constant":
        assert int(got[1].abs().max()) == int(got[2].abs().max()) == 0


def test_plain_b3_equals_refine_plus_pred_bi_plus_residual():
    """The plain version is the staged composition: each window refined on
    its own, ops.pred_inter.pred_bi at the two winners, then
    ops.residual.residual_pipeline."""
    src, flat, off0, off1, qargs = case(3, 8, 32)
    rec, frac0, frac1, nnz, bits = bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    wins = [tmotion.extract_windows(flat, off, 71) for off in (off0, off1)]
    f0, f1 = (refine_qpel(src, win)[1] for win in wins)
    assert torch.equal(frac0, f0) and torch.equal(frac1, f1)
    pred = pred_bi(*wins, f0 % 4, f0 // 4, f1 % 4, f1 // 4)
    rec_s, nnz_s, cbf = residual_pipeline(src, pred, *qargs)
    assert torch.equal(rec, rec_s) and int(nnz.sum()) == int(nnz_s)
    assert torch.equal((nnz > 0).reshape(-1), cbf)
    assert bool(((bits > 0) == (nnz > 0)).all()) and bool((bits >= 3 * nnz).all())


def test_b3_wrapper_checks_and_registry():
    src, flat, off0, off1, qargs = case(1, 8, 32)
    scale, shift, offset, dscale, dshift = qargs
    before = bi_fused.bi_ctu_fused_dma.launches
    bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, *qargs)
    assert bi_fused.bi_ctu_fused_dma.launches == before     # a CPU tensor: plain
    with pytest.raises(ValueError, match="shift"):
        bi_fused.bi_ctu_fused_dma(src, flat, off0, off1, scale, 30, offset, dscale, dshift)
    with pytest.raises(ValueError, match="offsets1"):
        bi_fused.bi_ctu_fused_dma(src, flat, off0, off1[:-1], *qargs)
    with pytest.raises(ValueError, match="src_ctus"):
        bi_fused.bi_ctu_fused_dma(src[:, :32], flat, off0, off1, *qargs)
    assert registry.tiers_of("bi_ctu_fused_dma") == Tier.REF | Tier.KERNEL
    assert registry.get("bi_ctu_fused_dma", Tier.REF) is bi_fused.bi_ctu_fused_dma_ref


def test_cli_info_lists_b3(capsys):
    from hevcasm_tpu_torch.cli import main

    assert main(["info"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "bi_ctu_fused_dma" in ln]
    assert len(line) == 1 and "REF*" in line[0] and "KERNEL" in line[0]
