"""Kernels B14, B15 and B18 on the CPU: hevcasm_tpu_torch's plain
base_grids_ctu_ref, base_layout_decide_ref and base_layout_decide_fc_ref
against hevcasm_tpu's base_grids_ctu, base_layout_decide and
base_layout_decide_fc (Pallas, run in interpret mode on the CPU), on the
same numpy CTUs and 128 x 128 windows.  Every output is integer
and must be equal.  test_torch_cuda.py holds the CUDA kernels against these
plain versions on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.kernels import search_pallas as jsearch

from torch_testing import jax_once, same
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import partition as tpart
from hevcasm_tpu_torch.kernels import base_grids

DEFAULT_LAYOUTS = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")
# The lists of tests/test_partition.py's fine/coarse check, at base 16.
PARTITION_LISTS = (
    tuple(range(16)),
    tuple(range(8)), tuple(range(8, 16)),
    tuple(t for t in range(16) if t % 4 < 2),
    tuple(t for t in range(16) if t % 4 >= 2),
) + tuple((t,) for t in range(16))


def ctus(n, seed, constant=None):
    """(src (n, 64, 64), windows (n, 128, 128)) uint8: smooth windows with
    each source cut from its window at a planted displacement, plus noise;
    or constant windows, where every candidate ties."""
    rng = np.random.default_rng(seed)
    if constant is not None:
        win = np.full((n, 128, 128), constant, np.uint8)
        return rng.integers(0, 256, (n, 64, 64), dtype=np.uint8), win
    base = rng.integers(0, 256, (n, 130, 130)).astype(np.float32)
    win = ((base[:, :-2, :-2] + base[:, 1:-1, 1:-1] + base[:, 2:, 2:]) / 3).astype(np.uint8)
    src = np.empty((n, 64, 64), np.uint8)
    for i in range(n):
        dy, dx = rng.integers(0, 65, 2)
        src[i] = win[i, dy:dy + 64, dx:dx + 64]
        src[i, 32:, :32] = win[i, 20:52, 40:72]             # a second motion
    noise = rng.integers(-3, 4, src.shape)
    return np.clip(src + noise, 0, 255).astype(np.uint8), win


def with_constant(src, win, seed=5):
    """The CTUs followed by two on constant windows, so one call of the
    interpreted TPU kernel serves both cases."""
    c_src, c_win = ctus(2, seed, constant=97)
    return np.concatenate([src, c_src]), np.concatenate([win, c_win])


def grids_case(base):
    """Two CTUs (seed = base) and, at base 32, two constant ones."""
    src, win = ctus(2, seed=base)
    return with_constant(src, win) if base == 32 else (src, win)


def jax_grids(base):
    src, win = grids_case(base)
    return jax_once(("grids", base), lambda: jsearch.base_grids_ctu(
        jnp.asarray(src), jnp.asarray(win), base))


@pytest.mark.parametrize("base", [8, 16, 32])
def test_base_grids_match_jax(base):
    src, win = grids_case(base)
    got = base_grids.base_grids_ctu_ref(src, win, base)
    k = 64 // base
    assert tuple(got.shape) == (src.shape[0], k, k, 65, 65)
    same(got, jax_grids(base))


def test_base_grids_sum_to_the_ctu_grid():
    from hevcasm_tpu_torch.ops.ssd import ssd_grid

    src, win = ctus(2, seed=3)
    whole = ssd_grid(torch.as_tensor(src), torch.as_tensor(win), 65, 65)
    for base in (8, 16, 32):
        g = base_grids.base_grids_ctu_ref(src, win, base)
        same(g.sum(dim=(1, 2), dtype=torch.int32), whole)


def default_lists(base):
    return tpart._pu_lists(DEFAULT_LAYOUTS, base)


def decide_case(base, lists):
    """Three CTUs and the PU lists; the default lists at base 16 also get
    two constant CTUs."""
    pu_lists = default_lists(base) if lists == "default" else PARTITION_LISTS
    if base == 32 and lists == "default":
        # Base 32 cannot tile the quarter layout: its layouts stop at NxN.
        pu_lists = tpart._pu_lists(DEFAULT_LAYOUTS[:4], 32)
    src, win = ctus(3, seed=10 + base)
    if (base, lists) == (16, "default"):
        src, win = with_constant(src, win)
    return src, win, pu_lists


def jax_decide(base, lists):
    src, win, pu_lists = decide_case(base, lists)
    return jax_once(("decide", base, lists), lambda: jsearch.base_layout_decide(
        jnp.asarray(src), jnp.asarray(win), base, pu_lists))


@pytest.mark.parametrize("base,lists", [
    (16, "default"), (32, "default"), (16, "partition"),
])
def test_layout_decide_matches_jax(base, lists):
    src, win, pu_lists = decide_case(base, lists)
    want = jax_decide(base, lists)
    got = base_grids.base_layout_decide_ref(src, win, base, pu_lists)
    same(got, want)
    assert len(np.unique(want[:3, :, :2].reshape(-1, 2), axis=0)) > 1


def test_layout_decide_is_the_first_minimum_of_the_summed_grids():
    src, win = ctus(2, seed=21)
    pu_lists = default_lists(8)[:5] + ((0, 9, 18, 27), (63,))
    g = base_grids.base_grids_ctu_ref(src, win, 8).reshape(2, 64, 65 * 65).numpy()
    got = base_grids.base_layout_decide_ref(src, win, 8, pu_lists).numpy()
    for p, subs in enumerate(pu_lists):
        pu = g[:, list(subs)].sum(axis=1)
        idx = pu.argmin(axis=-1)                  # numpy: the first minimum
        want = np.stack([idx // 65 - 32, idx % 65 - 32, pu.min(axis=-1)], -1)
        np.testing.assert_array_equal(got[:, p], want)


def test_constant_window_ties_every_candidate():
    # The last two CTUs of the base-16 default case and of the base-32 grids
    # case lie on constant windows.
    src, win, pu_lists = decide_case(16, "default")
    got = base_grids.base_layout_decide_ref(src[-2:], win[-2:], 16, pu_lists)
    same(got, jax_decide(16, "default")[-2:])
    assert (got[:, :, :2] == -32).all()              # the first candidate wins
    src, win = grids_case(32)
    same(base_grids.base_grids_ctu_ref(src[-2:], win[-2:], 32), jax_grids(32)[-2:])


def test_wrappers_run_the_plain_version_on_the_cpu():
    src, win = ctus(1, seed=6)
    before = (base_grids.base_grids_ctu.launches, base_grids.base_layout_decide.launches)
    same(base_grids.base_grids_ctu(src, win, 32), base_grids.base_grids_ctu_ref(src, win, 32))
    lists = default_lists(16)
    same(base_grids.base_layout_decide(src, win, 16, lists),
         base_grids.base_layout_decide_ref(src, win, 16, lists))
    assert (base_grids.base_grids_ctu.launches,
            base_grids.base_layout_decide.launches) == before
    assert registry.get("base_grids_ctu", Tier.REF) is base_grids.base_grids_ctu_ref
    assert registry.get("base_layout_decide", Tier.REF) is base_grids.base_layout_decide_ref


def test_other_radii_follow_the_window_size():
    # The JAX kernels take R = 32 only; the port reads R from the windows.
    src, win = grids_case(16)
    small = win[:, 24:24 + 80, 24:24 + 80].copy()        # R = 8
    g = base_grids.base_grids_ctu_ref(src, small, 16)
    assert tuple(g.shape) == (2, 4, 4, 17, 17)
    same(g, jax_grids(16)[:, :, :, 24:41, 24:41])


@pytest.mark.parametrize("args", [
    dict(base=64), dict(base=16, lists=((),)), dict(base=16, lists=((1, 1),)),
    dict(base=16, lists=((16,),)), dict(base=16, lists=()), dict(base=16, size=127),
    dict(base=16, size=200),
])
def test_operands_the_kernels_do_not_take_raise(args):
    src, win = ctus(1, seed=0)
    size = args.get("size", 128)
    win = np.zeros((1, size, size), np.uint8)
    with pytest.raises(ValueError):
        if "lists" in args:
            base_grids.base_layout_decide_ref(src, win, args["base"], args["lists"])
        else:
            base_grids.base_grids_ctu_ref(src, win, args["base"])


def test_fc_decide_matches_jax_fine_coarse_kernel():
    # As tests/test_partition.py holds the TPU's fine/coarse kernel to
    # base_layout_decide at base 16, at n = 3.
    src, win = ctus(3, 18)
    want = np.asarray(jsearch.base_layout_decide_fc(jnp.asarray(src), jnp.asarray(win),
                                                    PARTITION_LISTS))
    before = base_grids.base_layout_decide_fc.launches
    got = base_grids.base_layout_decide_fc(src, win, PARTITION_LISTS)
    assert base_grids.base_layout_decide_fc.launches == before   # CPU: no launch
    same(got, want)
    same(base_grids.base_layout_decide_fc_ref(src, win, PARTITION_LISTS), want)
    same(base_grids.base_layout_decide_ref(src, win, 16, PARTITION_LISTS), want)


@pytest.mark.parametrize("src_shape,win_shape", [((2, 32, 32), (2, 128, 128)),
                                                 ((2, 64, 64), (2, 80, 80))])
def test_fc_decide_takes_the_tpu_kernels_geometry_only(src_shape, win_shape):
    # hevcasm_tpu stops on an assert; the port raises ValueError.
    src = np.zeros(src_shape, np.uint8)
    win = np.zeros(win_shape, np.uint8)
    for fn in (base_grids.base_layout_decide_fc, base_grids.base_layout_decide_fc_ref):
        with pytest.raises(ValueError, match="128"):
            fn(src, win, PARTITION_LISTS)
