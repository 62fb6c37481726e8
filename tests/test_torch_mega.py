"""Kernel B19's plain version (kernels.mega.encode_ctu_mega_ref) against
hevcasm_tpu's Pallas encode_ctu_mega in interpret mode on the CPU: the
search, refinement and residual of every CTU in one call, at R = 8 on odd
and even CTU-grid widths and at R = 16 with MVs at the edges of the range.
Every output must be equal.  The kernel itself is held against its plain
version in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.kernels.mega_pallas import encode_ctu_mega as jax_mega

from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import mega

QARGS = (*EncodeConfig(qp=32).quant_params(False), *EncodeConfig(qp=32).dequant_params())


def frames(case):
    """(cur, ref, r) of each case: a smooth picture panned by (2.25, 3.25)
    pixels with noise at R = 8 (128 x 192: an odd grid width; 128 x 256:
    even), and, as hevcasm_tpu's test_mega_extreme_motion, noise shifted by
    2R = 32 in both axes at R = 16, so the MVs reach the edges of the
    range."""
    if case == "corner":
        r, h, w = 16, 128, 128
        base = np.random.default_rng(3).integers(0, 256, (h + 2 * r, w + 2 * r), dtype=np.uint8)
        return base[2 * r:, 2 * r:].copy(), base[:h, :w].copy(), r
    h, w = {"odd": (128, 192), "even": (128, 256)}[case]
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def picture(dy, dx):
        v = 128 + 70 * np.sin((x + dx) / 11 + (y + dy) / 17) + 40 * np.cos((x + dx) / 23
                                                                          - (y + dy) / 9)
        return np.clip(np.rint(v + rng.normal(0, 1.5, v.shape)), 0, 255).astype(np.uint8)

    return picture(2.25, 3.25), picture(0, 0), 8


_JAX_CACHE = {}


def jax_result(case):
    if case not in _JAX_CACHE:
        cur, ref, r = frames(case)
        h, w = cur.shape
        plane = jctu.pad_frame(jnp.asarray(ref), r + 8, r + 8, r + 8, r + 8)
        pos = jmotion.ctu_positions(h // 64, w // 64, 64)
        out = jax_mega(jctu.tile_frame(jnp.asarray(cur), 64), plane, pos, r, *QARGS)
        _JAX_CACHE[case] = [np.asarray(o) for o in out]
    return _JAX_CACHE[case]


def port_inputs(case):
    cur, ref, r = frames(case)
    h, w = cur.shape
    src = tctu.tile_frame(torch.as_tensor(cur), 64).contiguous()
    padded = tctu.pad_frame(torch.as_tensor(ref), r + 3, r + 4, r + 3, r + 4)
    return src, padded, tmotion.ctu_positions(h // 64, w // 64, 64), r


@pytest.mark.parametrize("case", ["odd", "even", "corner"])
def test_plain_b19_matches_jax_kernel(case):
    src, padded, pos, r = port_inputs(case)
    got = mega.encode_ctu_mega_ref(src, padded, pos, r, *QARGS)
    want = jax_result(case)
    names = ("rec", "mv", "frac", "best", "nnz")
    for name, g, w in zip(names, got, want):
        assert g.dtype == (torch.uint8 if name == "rec" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "corner":                     # the search reaches the edge of its range
        assert (np.abs(got[1].numpy()) == r).any()


def test_b19_wrapper_runs_the_plain_version_on_cpu_and_is_registered():
    src, padded, pos, r = port_inputs("odd")
    before = mega.encode_ctu_mega.launches
    got = mega.encode_ctu_mega(src, padded, pos, r, *QARGS)
    assert mega.encode_ctu_mega.launches == before       # a CPU tensor launches nothing
    for g, w in zip(got, mega.encode_ctu_mega_ref(src, padded, pos, r, *QARGS)):
        assert torch.equal(g, w)
    assert registry.get("encode_ctu_mega", Tier.REF) is mega.encode_ctu_mega_ref
    assert registry.tiers_of("encode_ctu_mega") == Tier.REF | Tier.KERNEL


@pytest.mark.parametrize("r", [4, 12, 40])
def test_b19_takes_the_tpu_kernels_search_ranges_only(r):
    # hevcasm_tpu stops on a bare assert; the port raises ValueError.
    src = torch.zeros((2, 64, 64), dtype=torch.uint8)
    padded = torch.zeros((64 + 2 * r + 7, 128 + 2 * r + 7), dtype=torch.uint8)
    pos = tmotion.ctu_positions(1, 2, 64)
    for fn in (mega.encode_ctu_mega, mega.encode_ctu_mega_ref):
        with pytest.raises(ValueError, match="8, 16, 24, 32"):
            fn(src, padded, pos, r, *QARGS)


def test_cli_info_lists_the_search_kernels(capsys):
    from hevcasm_tpu_torch.cli import main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    for op in ("sad_grid", "search_mv", "search_mv_dma", "encode_ctu_mega"):
        assert any(line.split()[:1] == [op] and "REF*" in line and "KERNEL" in line
                   for line in out.splitlines()), op
    for op in ("sad", "sad_multiref"):
        assert any(line.split() == [op, "REF*"] for line in out.splitlines()), op
