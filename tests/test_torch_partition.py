"""hevcasm_tpu_torch.encode.partition against hevcasm_tpu.encode.partition on
the CPU, function by function, on the same numpy frames (128 x 192, a grid
of 2 x 3 CTUs) at R = 8 and R = 32.  hevcasm_tpu's Pallas kernels run in
interpret mode.  Every output is integer and must be equal.
test_torch_rdo.py runs encode_inter_frame's RDO paths end to end."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hevcasm_tpu.encode import ctu as jctu
from hevcasm_tpu.encode import motion as jmotion
from hevcasm_tpu.encode import partition as jpart
from hevcasm_tpu.encode.loop import EncodeConfig as JaxConfig
from hevcasm_tpu.kernels.xla_opt import ssd_grid as jssd_grid

from hevcasm_tpu_torch.encode import ctu as tctu
from hevcasm_tpu_torch.encode import loop as tloop
from hevcasm_tpu_torch.encode import motion as tmotion
from hevcasm_tpu_torch.encode import partition as tpart
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.ops.ssd import ssd_grid

DEFAULT = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")
SMALL = ("2Nx2N", "NxN", "eighth")
ALL = tuple(jpart.PU_LAYOUTS)


def same(ours, theirs, what=""):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, \
        (what, ours.dtype, ours.shape, theirs.dtype, theirs.shape)
    np.testing.assert_array_equal(ours, theirs, err_msg=what)


class Case:
    """One frame's operands in both packages: source CTUs, the padded
    reference, CTU positions and the CTU search windows."""

    def __init__(self, r, seed=0, h=128, w=192):
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (h + 80, w + 80)).astype(np.float32)
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
        base = base.astype(np.uint8)
        cur, ref = base[5:5 + h, 7:7 + w].copy(), base[:h, :w].copy()
        cur[h // 2:, : w // 2] = base[h // 2 - 3:h - 3, 2:2 + w // 2]   # a second motion
        self.r, self.grid = r, (h // 64, w // 64)
        self.j = self._operands(jnp.asarray(cur), jnp.asarray(ref), jctu, jmotion)
        self.t = self._operands(torch.as_tensor(cur), torch.as_tensor(ref), tctu, tmotion)

    def _operands(self, cur, ref, ctu_mod, motion):
        r = self.r
        src = ctu_mod.tile_frame(cur, 64)
        rp = ctu_mod.pad_frame(ref, r + 3, r + 4, r + 3, r + 4)
        pos = motion.ctu_positions(*self.grid, 64)
        win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)
        return src, rp, pos, win


_CASES = {}
_JAX = {}


def case(r):
    if r not in _CASES:
        _CASES[r] = Case(r)
    return _CASES[r]


def jax_once(key, fn):
    if key not in _JAX:
        out = fn()
        _JAX[key] = tuple(out) if isinstance(out, (tuple, list)) else out
    return _JAX[key]


def test_layout_tables_equal():
    assert tpart.PU_LAYOUTS == jpart.PU_LAYOUTS
    assert tloop.PU_LAYOUT_NAMES == tuple(jpart.PU_LAYOUTS)
    for layouts in (DEFAULT, SMALL, ALL, ("2Nx2N",), ("2NxN", "quarter")):
        assert tpart.base_for(layouts) == jpart.base_for(layouts)
        for base in {tpart.base_for(layouts), 8}:
            np.testing.assert_array_equal(tpart._tile_pu_table(layouts, base),
                                          jpart._tile_pu_table(layouts, base))


def test_mv_lambda_equal():
    assert [tpart.mv_lambda(qp) for qp in range(-6, 58)] == \
           [jpart.mv_lambda(qp) for qp in range(-6, 58)]


def test_empty_layouts_raise_value_error_in_both():
    with pytest.raises(ValueError):
        jpart.base_for(())
    with pytest.raises(ValueError, match="empty"):
        tpart.base_for(())


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("base", [8, 16, 32])
def test_base_grid_search_integral_and_rects(r, base):
    c = case(r)
    jg = jax_once(("grids", r, base),
                  lambda: np.array(jpart.base_grid_search(c.j[0], c.j[3], r, jssd_grid, base)))
    g = tpart.base_grid_search(c.t[0], c.t[3], r, ssd_grid, base)
    same(g, jg, "grids")
    gint = tpart.grid_integral(g)
    jgint = jpart.grid_integral(jnp.asarray(jg))
    same(gint, jgint, "integral")
    for name in ALL:
        for rect in tpart.PU_LAYOUTS[name]:
            if rect[2] % base == 0 and rect[3] % base == 0:
                same(tpart.rect_grid(gint, rect, base), jpart.rect_grid(jgint, rect, base),
                     f"{name} {rect}")
    same(tpart._argmin_grid(g, r)[0], jpart._argmin_grid(jnp.asarray(jg), r)[0], "argmin mv")
    same(tpart._argmin_grid(g, r)[1], jpart._argmin_grid(jnp.asarray(jg), r)[1], "argmin best")


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("layouts", [DEFAULT, ALL])
def test_layout_decision(r, layouts):
    c = case(r)
    base = tpart.base_for(layouts)
    jg = jax_once(("grids", r, base),
                  lambda: np.array(jpart.base_grid_search(c.j[0], c.j[3], r, jssd_grid, base)))
    jcosts, jmvs = jpart.layout_decision(jpart.grid_integral(jnp.asarray(jg)), layouts, r,
                                         jpart.mv_lambda(32), base)
    costs, mvs = tpart.layout_decision(tpart.grid_integral(torch.as_tensor(jg)), layouts, r,
                                       tpart.mv_lambda(32), base)
    same(costs, jcosts, "costs")
    for name in layouts:
        same(mvs[name], jmvs[name], name)


@pytest.mark.parametrize("r", [8, 32])
def test_multi_level_search(r):
    c = case(r)
    want = jax_once(("levels", r), lambda: {
        k: np.asarray(v) for k, v in jpart.multi_level_search(c.j[0], c.j[3], r,
                                                              jssd_grid).items()})
    got = tpart.multi_level_search(c.t[0], c.t[3], r, ssd_grid)
    assert sorted(got) == sorted(want)
    for k in want:
        same(got[k], want[k], k)


def jax_select(r, layouts):
    c = case(r)
    return jax_once(("select", r, layouts), lambda: [
        {k: np.asarray(v) for k, v in x.items()} if isinstance(x, dict) else np.asarray(x)
        for x in jpart.select_pu_layout(*c.j, r, jpart.mv_lambda(32), layouts, jssd_grid)])


@pytest.mark.parametrize("r", [8, 32])
def test_refine_layout_every_layout(r):
    c = case(r)
    base = 8
    jg = jax_once(("grids", r, base),
                  lambda: np.array(jpart.base_grid_search(c.j[0], c.j[3], r, jssd_grid, base)))
    _, mvs = tpart.layout_decision(tpart.grid_integral(torch.as_tensor(jg)), ALL, r,
                                   tpart.mv_lambda(32), base)
    for name in ALL:
        rects = tpart.PU_LAYOUTS[name]
        jpred, jmv = jax_once(("refine", r, name), lambda: [np.asarray(x) for x in (
            jpart.refine_layout(c.j[0], c.j[1], c.j[2], rects, jnp.asarray(mvs[name].numpy()),
                                r))])
        pred, mv = tpart.refine_layout(c.t[0], c.t[1], c.t[2], rects, mvs[name], r)
        same(pred, jpred, f"{name} pred")
        same(mv, jmv, f"{name} mv")


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("layouts", [DEFAULT, SMALL])
def test_select_pu_layout(r, layouts):
    c = case(r)
    jpred, jchoice, jmvq, jbest = jax_select(r, layouts)
    pred, choice, mvq, best = tpart.select_pu_layout(*c.t, r, tpart.mv_lambda(32), layouts,
                                                     ssd_grid)
    same(pred, jpred, "pred")
    same(choice, jchoice, "choice")
    same(best, jbest, "best64")
    for name in layouts:
        same(mvq[name], jmvq[name], name)


@pytest.mark.parametrize("r,routed", [(8, False), (32, False), (32, True)])
@pytest.mark.parametrize("layouts", [DEFAULT, SMALL])
def test_select_pu_layout_pruned(r, routed, layouts):
    """Both routes (with grid: B15 at base 16, B14 + integral at base 8)
    equal hevcasm_tpu's pruned decision and the unpruned one.  hevcasm_tpu's
    routes equal each other (tests/test_partition.py), and its routed one
    runs end to end in test_torch_rdo.py, so the routed case is held against
    its integral route here."""
    c = case(r)
    lam = tpart.mv_lambda(32)
    kw = dict(grid=c.grid) if routed else {}
    want = jax_once(("pruned", r, layouts), lambda: [np.asarray(x) for x in (
        jpart.select_pu_layout_pruned(*c.j, r, lam, layouts, jssd_grid))])
    got = tpart.select_pu_layout_pruned(*c.t, r, lam, layouts, ssd_grid, **kw)
    for name, a, b in zip(("pred", "choice", "mv_tiles", "best64"), got, want):
        same(a, b, name)
    jpred, jchoice, _, jbest = jax_select(r, layouts)
    same(got[0], jpred, "pred vs unpruned")
    same(got[1], jchoice, "choice vs unpruned")
    same(got[3], jbest, "best64 vs unpruned")
    if routed:
        plain = tpart.select_pu_layout_pruned(*c.t, r, lam, layouts, ssd_grid)
        for a, b in zip(got, plain):
            same(a, b)


def test_select_pu_layout_pruned_routes_to_the_kernels():
    c = case(32)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    kernels = dict(decide_fn=spy("decide", tpart.base_layout_decide),
                   grids_fn=spy("grids", tpart.base_grids_ctu),
                   costmap_dma_fn=spy("costmap", tpart.refine_qpel_costmap_dma))
    lam = tpart.mv_lambda(32)
    for layouts, grid, metric, want in [
            (DEFAULT, c.grid, "ssd", ["decide", "costmap"]),
            (SMALL, c.grid, "ssd", ["grids", "costmap"]),
            (DEFAULT, None, "ssd", ["costmap"]),
            (DEFAULT, c.grid, "sad", ["costmap"])]:
        calls.clear()
        grid_fn = ssd_grid if metric == "ssd" else spy("grid_fn", ssd_grid)
        tpart.select_pu_layout_pruned(*c.t, 32, lam, layouts, grid_fn, grid=grid,
                                      metric=metric, **kernels)
        assert calls == (["grid_fn"] if metric == "sad" else []) + want, (layouts, grid)


def test_pruned_whole_ctu_layout_raises_value_error():
    c = case(8)
    with pytest.raises(ValueError, match="up to 32"):
        tpart.select_pu_layout_pruned(*c.t, 8, 10, ("2Nx2N",), ssd_grid)


@pytest.mark.parametrize("tu_sizes", [(4, 8, 16, 32), (8,), (32, 4)])
def test_select_tu_recon(tu_sizes):
    c = case(8)
    rng = np.random.default_rng(3)
    pred = np.clip(np.asarray(c.j[0]).astype(np.int32) + rng.integers(-9, 10, (6, 64, 64)),
                   0, 255).astype(np.uint8)
    want = [np.asarray(x) for x in jpart.select_tu_recon(
        c.j[0], jnp.asarray(pred), JaxConfig(qp=32), tu_sizes)]
    got = tpart.select_tu_recon(c.t[0], torch.as_tensor(pred), EncodeConfig(qp=32), tu_sizes)
    for name, a, b in zip(("recon", "tu_choice", "nnz"), got, want):
        same(a, b, name)
    if len(tu_sizes) == 4:
        assert len(np.unique(want[1])) > 1, "the sizes should differ per CTU"
