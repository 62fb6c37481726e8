"""Kernels chroma_p_fused and chroma_b_fused (csrc/chroma_fused.cu,
kernels/chroma_fused.py) on the CPU, and the rule by which
encode_inter_frame_yuv and encode_b_frame_yuv take them.

The kernels' CTA body (chroma::code_block<R>, all of csrc/chroma_fused.cu
above its kernels and C entries, R = 1 for the P frame, 2 for the B frame)
is compiled for the CPU with tests/warp_emu.h, over the two cores it runs
(csrc/mc_tc.cuh and csrc/residual_core.cuh, their inline PTX replaced by
the emulated mma.sync and plain copies for cp.async, as
tests/torch_testing.py builds them for every emulated test): a CTA of one
warp, 32 threads that meet at a barrier at each product, shuffle and
__syncthreads, its shared memory poisoned, the output planes poisoned
outside the blocks it codes.  It is held bit for bit against the plain
versions, chroma_p_fused_ref (encode.video._chroma_mc then _chroma_residual
at Tier.REF) and chroma_b_fused_ref (each reference's _chroma_mc as int16,
the mean, then _chroma_residual): the reconstruction of each block it codes
and both planes' nnz, on a plane of 2 x 3 blocks and the 1080p (and, for
P, 4K) chroma plane shapes (the border blocks and some inside ones), at
every eighth-pel fraction on both axes (for B, the two references at
different fractions), with MVs that take the window past each edge of the
plane (to the plain version's padding: clamping equals pad_frame there;
for B, each reference's on its own), at the chroma QPs of ldp1080_live
(qPc 33, 33, 33, 32), of ra1080_ibpbp33 (luma 32, qPc 31) and one below 30,
on random and full-swing (0/255 checkerboard and stripes) content.  On the
card the kernels are held against the plain versions in test_torch_cuda.py
and chip_smoke.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_testing
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import ctu as ctu_mod
from hevcasm_tpu_torch.encode import video
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import chroma_fused
from hevcasm_tpu_torch.ops.residual import residual_levels

N = chroma_fused.BLOCK

EMULATED_MAIN = r"""
#include "chroma_body.cuh"

#include <cstdio>
#include <random>
#include <vector>

// stdin: R (1 or 2: the P or B frame's kernel, references; 0: the per-PU
// instance, one reference, then k) h w qscale qshift qoffset dscale dshift
// runs seed, then the planes cur_cb, cur_cr, then each reference's cb and cr
// (h x w bytes each), each reference's (h / 32) (w / 32) MVs (dy, dx) (the
// per-PU instance: its (h / 32) (w / 32) k k field), and the indices of the
// blocks to code; stdout: each coded block's 32 x 32 reconstruction of Cb
// then Cr, nnz[0], nnz[1], then the number of output bytes outside the
// coded blocks that changed.  A CTA of one warp: 32 threads, one a lane;
// shared memory poisoned.
static uint8_t* aligned16(std::vector<uint8_t>& v, size_t n) {
  v.assign(n + 16, 77);
  return v.data() + (16 - reinterpret_cast<uintptr_t>(v.data()) % 16) % 16;
}

template <int R, bool PU>
static int run(long long h, long long w, long long k, const long long (&q)[5], int runs,
               unsigned seed) {
  constexpr int IN = 2 + 2 * R;    // source and reference planes
  std::vector<uint8_t> store[IN + 3];
  uint8_t* plane[IN + 2];
  for (int j = 0; j < IN + 2; ++j) plane[j] = aligned16(store[j], h * w);
  for (int j = 0; j < IN; ++j)
    for (long long x = 0; x < h * w; ++x) {
      int v;
      if (scanf("%d", &v) != 1) return 1;
      plane[j][x] = static_cast<uint8_t>(v);
    }
  const long long n = (h / 32) * (w / 32);
  std::vector<int32_t> mv(2 * n * R * (PU ? k * k : 1));
  for (auto& v : mv)
    if (scanf("%d", &v) != 1) return 1;
  std::vector<long long> run(runs);
  for (auto& i : run)
    if (scanf("%lld", &i) != 1) return 1;
  int32_t nnz[2] = {0, 0};
  using Args = std::conditional_t<PU, ChromaPuArgs, ChromaFusedArgs<R>>;
  constexpr int SMEM = PU ? chroma::SMEM_PU : chroma::SMEM<R>;
  Args a{};
  for (int p = 0; p < 2; ++p) {
    a.cur[p] = reinterpret_cast<long long>(plane[p]);
    a.rec[p] = reinterpret_cast<long long>(plane[IN + p]);
    if constexpr (PU) {
      a.ref[p] = reinterpret_cast<long long>(plane[2 + p]);
    } else {
      for (int r = 0; r < R; ++r) a.ref[r][p] = reinterpret_cast<long long>(plane[2 + 2 * r + p]);
    }
  }
  if constexpr (PU) {
    a.mv = reinterpret_cast<long long>(mv.data());
    a.k = k;
  } else {
    for (int r = 0; r < R; ++r) a.mv[r] = reinterpret_cast<long long>(mv.data() + 2 * n * r);
  }
  a.nnz = reinterpret_cast<long long>(nnz);
  a.h = h;
  a.w = w;
  for (int j = 0; j < 5; ++j) a.q[j] = q[j];
  uint8_t* smem = aligned16(store[IN + 2], SMEM);
  std::mt19937 poison(seed);
  for (long long i : run) {
    for (int j = 0; j < SMEM; ++j) smem[j] = static_cast<uint8_t>(poison());
    if constexpr (PU)
      emu_run_block([&] { chroma::code_block_pu(a, i, 32, smem); });
    else
      emu_run_block([&] { chroma::code_block(a, i, 32, smem); });
  }
  const long long gc = w / 32;
  std::vector<char> coded(h * w, 0);
  for (long long i : run)
    for (int p = 0; p < 2; ++p)
      for (int r = 0; r < 32; ++r)
        for (int c = 0; c < 32; ++c) {
          const long long x = (32 * (i / gc) + r) * w + 32 * (i % gc) + c;
          printf("%d ", plane[IN + p][x]);
          coded[x] = 1;
        }
  int changed = 0;
  for (int p = 0; p < 2; ++p)
    for (long long x = 0; x < h * w; ++x) changed += !coded[x] && plane[IN + p][x] != 77;
  printf("%d %d %d\n", nnz[0], nnz[1], changed);
  return 0;
}

int main() {
  int refs, runs;
  long long h, w, k = 0, q[5];
  unsigned seed;
  if (scanf("%d", &refs) != 1 || (refs == 0 && scanf("%lld", &k) != 1)) return 1;
  if (scanf("%lld %lld %lld %lld %lld %lld %lld %d %u", &h, &w, &q[0], &q[1], &q[2], &q[3],
            &q[4], &runs, &seed) != 9)
    return 1;
  return refs == 0 ? run<1, true>(h, w, k, q, runs, seed)
       : refs == 1 ? run<1, false>(h, w, k, q, runs, seed)
       : refs == 2 ? run<2, false>(h, w, k, q, runs, seed) : 1;
}
"""


@pytest.fixture(scope="module")
def emulated_chroma(tmp_path_factory):
    """chroma::code_block built for the CPU over the two cores, their inline
    PTX replaced as for their own tests.  Skips without a C++20
    compiler."""
    tmp = tmp_path_factory.mktemp("chroma_emu")
    torch_testing.emulated_mc_tc(tmp)
    torch_testing.emulated_residual_core(tmp)
    torch_testing.kernel_body(tmp, "chroma_fused.cu", "chroma_body.cuh")
    return torch_testing.build_emulator(tmp, EMULATED_MAIN, "chroma")


def reach(cfg) -> int:
    """The plain version's chroma integer reach: its padding holds windows
    at mv >> 3 in [-reach, reach + 1] on both axes."""
    return cfg.search_range // 2 + 1


def plain(planes, mvs, cfg):
    """The plain version's (rec_cb, rec_cr) planes and nnz, and the nnz of
    each block and plane (n, 2) from the same plain prediction: with one
    MV array or MV field (planes cur_cb, cur_cr, ref_cb, ref_cr)
    chroma_p_fused_ref's, with two (then ref1_cb, ref1_cr)
    chroma_b_fused_ref's."""
    t = [torch.as_tensor(p) for p in planes]
    mv_t = [torch.as_tensor(mv) for mv in mvs]
    ref_fn = chroma_fused.chroma_p_fused_ref if len(mvs) == 1 else chroma_fused.chroma_b_fused_ref
    rec_cb, nnz_cb, rec_cr, nnz_cr = ref_fn(*t, *mv_t, cfg)
    q = chroma_fused._qargs(cfg.qp)
    per_block = []
    for p in range(2):
        if len(mvs) == 1:
            pred = video._chroma_mc(t[2 + p], mv_t[0], cfg)
        else:
            p0, p1 = (video._chroma_mc(t[2 + 2 * r + p], mv_t[r], cfg, out16=True).to(torch.int32)
                      for r in range(2))
            pred = ((p0 + p1 + 64) >> 7).clamp(0, 255).to(torch.uint8)
        _, levels, _ = residual_levels(ctu_mod.tile_frame(t[p], N), pred, *q, tu=4)
        per_block.append((levels != 0).reshape(pred.shape[0], -1).sum(-1).numpy())
    per_block = np.stack(per_block, axis=1)
    assert per_block.sum(0).tolist() == [int(nnz_cb), int(nnz_cr)]
    return np.stack([rec_cb.numpy(), rec_cr.numpy()]), per_block


def emulate(exe, planes, mvs, cfg, blocks, seed=7):
    """The emulated kernel of len(mvs) references over ``blocks`` (the
    per-PU instance's for one MV field (n, k, k, 2)): (their
    reconstructions (len(blocks), 2, 32, 32), both planes' nnz over them,
    bytes changed outside them)."""
    h, w = planes[0].shape
    head = (0, mvs[0].shape[1]) if mvs[0].ndim == 4 else (len(mvs),)
    stdin = " ".join(map(str, (*head, h, w, *chroma_fused._qargs(cfg.qp), len(blocks), seed,
                               *np.concatenate([p.ravel() for p in planes]),
                               *np.concatenate([mv.ravel() for mv in mvs]), *blocks)))
    out = torch_testing.run_emulator(exe, stdin, f"{h}x{w} qp {cfg.qp} seed {seed}").split()
    vals = np.array(out, dtype=np.int64)
    return vals[:-3].reshape(len(blocks), 2, N, N), vals[-3:-1], int(vals[-1])


def assert_kernel_equals_plain(exe, planes, mvs, cfg, blocks=None, seed=7):
    """The emulated kernel against the plain version; mvs is a list of one
    MV array (the P frame's kernel, four planes), one MV field (n, k, k, 2)
    (the per-PU instance's, four planes) or two MV arrays (the B frame's,
    six)."""
    gr, gc = planes[0].shape[0] // N, planes[0].shape[1] // N
    blocks = list(range(gr * gc)) if blocks is None else blocks
    want_rec, want_nnz = plain(planes, mvs, cfg)
    rec, nnz, changed = emulate(exe, planes, mvs, cfg, blocks, seed)
    assert changed == 0, "a store outside the coded blocks"
    for k, i in enumerate(blocks):
        y, x = N * (i // gc), N * (i % gc)
        np.testing.assert_array_equal(rec[k], want_rec[:, y:y + N, x:x + N],
                                      err_msg=f"block {i}")
    np.testing.assert_array_equal(nnz, want_nnz[blocks].sum(0))


def random_planes(rng, h, w, k=4):
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(k)]


def full_swing(h, w, kind):
    """0/255 content, six planes (cur_cb, cur_cr, then two references' cb
    and cr): a checkerboard of 1-pixel cells (cur) over ones of 2-pixel
    cells or 1 x 2 cells (refs), or vertical stripes over horizontal ones
    and wider vertical ones."""
    y, x = np.mgrid[:h, :w]
    if kind == "checkerboard":
        pats = [(y + x) & 1, ((y >> 1) + (x >> 1)) & 1, (y + x + 1) & 1, ((y >> 1) + x) & 1,
                (y + (x >> 1)) & 1, ((y >> 1) + (x >> 1) + 1) & 1]
    else:
        pats = [x & 1, y & 1, (x >> 1) & 1, (y >> 2) & 1, (x >> 2) & 1, (y >> 1) & 1]
    return [(255 * p).astype(np.uint8) for p in pats]


def random_mvs(rng, n, cfg):
    """MVs (n, 2) int32 whose windows stay within the plain version's
    padding, every fraction likely."""
    r = reach(cfg)
    return rng.integers(-8 * r, 8 * (r + 1) + 8, (n, 2)).astype(np.int32)


def outward_mvs(rng, gr, gc, cfg):
    """MVs that take each border block's window as far past its edges as
    the plain version's padding reaches (mv >> 3 = -reach on the top and
    left, reach + 1 on the bottom and right), random fractions, random MVs
    inside."""
    r = reach(cfg)
    mv = random_mvs(rng, gr * gc, cfg).reshape(gr, gc, 2)
    frac = rng.integers(0, 8, (gr, gc, 2))
    mv[0, :, 0] = -8 * r + frac[0, :, 0]
    mv[-1, :, 0] = 8 * (r + 1) + frac[-1, :, 0]
    mv[:, 0, 1] = -8 * r + frac[:, 0, 1]
    mv[:, -1, 1] = 8 * (r + 1) + frac[:, -1, 1]
    return mv.reshape(-1, 2).astype(np.int32)


def border_blocks(gr, gc):
    """The corners, the middle of each edge and two blocks inside of a grid
    of gr x gc blocks."""
    return [0, gc // 2, gc - 1, (gr // 2) * gc, (gr // 2) * gc + gc - 1, (gr - 1) * gc,
            (gr - 1) * gc + gc // 3, gr * gc - 1, (gr // 3) * gc + gc // 4,
            (2 * gr // 3) * gc + 2 * gc // 3]


# ldp1080_live's luma QPs 35, 34, 35, 33 code chroma at qPc 33, 33, 33, 32;
# 22 stays below 30, where qPc = qp.
QPS = (35, 34, 33, 22)
# ra1080_ibpbp33's luma QP 32 codes chroma at qPc 31; 22 as above.
B_QPS = (32, 22)


@pytest.mark.parametrize("qp", QPS)
def test_small_plane_random(emulated_chroma, qp):
    rng = np.random.default_rng(qp)
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               [random_mvs(rng, 6, cfg)], cfg)


@pytest.mark.parametrize("qp", (35, 22))
def test_every_fraction_on_both_axes(emulated_chroma, qp):
    # 64 blocks, block i at fraction (i // 8, i % 8) and a random integer MV.
    rng = np.random.default_rng(100 + qp)
    cfg = EncodeConfig(qp=qp, search_range=16)
    mv = random_mvs(rng, 64, cfg) & ~7
    mv[:, 0] |= np.arange(64) // 8
    mv[:, 1] |= np.arange(64) % 8
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 8 * N, 8 * N), [mv], cfg)


@pytest.mark.parametrize("r", (32, 8))
def test_windows_past_each_edge(emulated_chroma, r):
    rng = np.random.default_rng(r)
    cfg = EncodeConfig(qp=33, search_range=r)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               [outward_mvs(rng, 2, 3, cfg)], cfg)


@pytest.mark.parametrize("shape", [(544, 960), (1088, 1920)], ids=["1080p", "4K"])
def test_frame_plane_shapes(emulated_chroma, shape):
    # The corners, the middle of each edge and two blocks inside, their
    # windows past the edges they touch.
    h, w = shape
    gr, gc = h // N, w // N
    rng = np.random.default_rng(h)
    cfg = EncodeConfig(qp=35)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, h, w),
                               [outward_mvs(rng, gr, gc, cfg)], cfg, border_blocks(gr, gc))


@pytest.mark.parametrize("kind", ["checkerboard", "stripes"])
@pytest.mark.parametrize("qp", (35, 22))
def test_full_swing_content(emulated_chroma, kind, qp):
    rng = np.random.default_rng(qp + len(kind))
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, full_swing(2 * N, 3 * N, kind)[:4],
                               [outward_mvs(rng, 2, 3, cfg)], cfg)


# ---- the B frame's kernel: two references ------------------------------------------------

@pytest.mark.parametrize("qp", B_QPS)
def test_b_small_plane_random(emulated_chroma, qp):
    rng = np.random.default_rng(200 + qp)
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N, 6),
                               [random_mvs(rng, 6, cfg), random_mvs(rng, 6, cfg)], cfg)


@pytest.mark.parametrize("qp", B_QPS)
def test_b_every_fraction_references_apart(emulated_chroma, qp):
    # 64 blocks: reference 0 at fraction (i // 8, i % 8), reference 1 at
    # (i % 8, (i // 8 + 5) % 8), never the same pair, random integer MVs.
    rng = np.random.default_rng(300 + qp)
    cfg = EncodeConfig(qp=qp, search_range=16)
    mv0, mv1 = random_mvs(rng, 64, cfg) & ~7, random_mvs(rng, 64, cfg) & ~7
    i = np.arange(64)
    mv0[:, 0] |= i // 8
    mv0[:, 1] |= i % 8
    mv1[:, 0] |= i % 8
    mv1[:, 1] |= (i // 8 + 5) % 8
    assert not ((mv0 & 7) == (mv1 & 7)).all(axis=1).any()
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 8 * N, 8 * N, 6),
                               [mv0, mv1], cfg)


@pytest.mark.parametrize("outward", ["ref0", "ref1", "both"])
@pytest.mark.parametrize("r", (32, 8))
def test_b_windows_past_each_edge(emulated_chroma, r, outward):
    # Each reference's windows past the plane's edges on their own: the
    # other reference's MVs random within the padding.
    rng = np.random.default_rng(400 + r + len(outward))
    cfg = EncodeConfig(qp=32, search_range=r)
    mvs = [outward_mvs(rng, 2, 3, cfg) if outward in (ref, "both") else random_mvs(rng, 6, cfg)
           for ref in ("ref0", "ref1")]
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N, 6), mvs, cfg)


def test_b_frame_plane_1080p(emulated_chroma):
    # The 1080p chroma plane's border blocks and two inside, both
    # references' windows past the edges they touch.
    h, w = 544, 960
    gr, gc = h // N, w // N
    rng = np.random.default_rng(500)
    cfg = EncodeConfig(qp=32)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, h, w, 6),
                               [outward_mvs(rng, gr, gc, cfg), outward_mvs(rng, gr, gc, cfg)],
                               cfg, border_blocks(gr, gc))


@pytest.mark.parametrize("kind", ["checkerboard", "stripes"])
@pytest.mark.parametrize("qp", B_QPS)
def test_b_full_swing_content(emulated_chroma, kind, qp):
    # 0/255 predictions from each reference, where the mean's rounding and
    # its clip to 8 bits decide samples.
    rng = np.random.default_rng(600 + qp + len(kind))
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, full_swing(2 * N, 3 * N, kind),
                               [outward_mvs(rng, 2, 3, cfg), random_mvs(rng, 6, cfg)], cfg)


# ---- the per-PU instance: an MV a (32 / k)-square tile --------------------------------

def random_field(rng, n, k, cfg):
    """An MV field (n, k, k, 2) int32 whose windows stay within the plain
    version's padding, every fraction likely."""
    return random_mvs(rng, n * k * k, cfg).reshape(n, k, k, 2)


def outward_field(rng, gr, gc, k, cfg):
    """An MV field (gr * gc, k, k, 2) whose tiles on the plane's border take
    their windows as far past its edges as the plain version's padding
    reaches: outward_mvs over the plane's grid of tiles."""
    mv = outward_mvs(rng, gr * k, gc * k, cfg).reshape(gr, k, gc, k, 2)
    return np.ascontiguousarray(mv.transpose(0, 2, 1, 3, 4)).reshape(gr * gc, k, k, 2)


@pytest.mark.parametrize("k", chroma_fused.PU_TILES)
@pytest.mark.parametrize("qp", (35, 22))
def test_pu_small_plane_random(emulated_chroma, k, qp):
    rng = np.random.default_rng(700 + 10 * k + qp)
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               [random_field(rng, 6, k, cfg)], cfg)


@pytest.mark.parametrize("k", (8, 4))
def test_pu_every_fraction_on_both_axes(emulated_chroma, k):
    # Tile j of the plane (raster over blocks, then over each block's
    # tiles) at fraction ((j // 8) % 8, j % 8): every pair, odd and even,
    # on both axes, beside neighbours at other fractions.
    rng = np.random.default_rng(800 + k)
    cfg = EncodeConfig(qp=33, search_range=16)
    field = random_field(rng, 6, k, cfg) & ~7
    j = np.arange(6 * k * k).reshape(6, k, k)
    field[..., 0] |= (j // 8) % 8
    field[..., 1] |= j % 8
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N), [field], cfg)


@pytest.mark.parametrize("k", (8, 2))
@pytest.mark.parametrize("r", (32, 8))
def test_pu_windows_past_each_edge(emulated_chroma, k, r):
    rng = np.random.default_rng(900 + r + k)
    cfg = EncodeConfig(qp=33, search_range=r)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               [outward_field(rng, 2, 3, k, cfg)], cfg)


def test_pu_frame_plane_1080p(emulated_chroma):
    # The 1080p chroma plane's border blocks and two inside at 4x4 tiles
    # (the six layouts' 8x8 luma base), each border tile's window past the
    # edges it touches.
    h, w = 544, 960
    gr, gc = h // N, w // N
    rng = np.random.default_rng(1000)
    cfg = EncodeConfig(qp=35)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, h, w),
                               [outward_field(rng, gr, gc, 8, cfg)], cfg, border_blocks(gr, gc))


@pytest.mark.parametrize("kind", ["checkerboard", "stripes"])
def test_pu_full_swing_content(emulated_chroma, kind):
    rng = np.random.default_rng(1100 + len(kind))
    cfg = EncodeConfig(qp=35)
    assert_kernel_equals_plain(emulated_chroma, full_swing(2 * N, 3 * N, kind)[:4],
                               [outward_field(rng, 2, 3, 8, cfg)], cfg)


# ---- the wrapper and the route on the CPU ----------------------------------------------

@pytest.mark.parametrize("qp", (*QPS, 0, 51))
def test_quantizer_is_the_chroma_configs(qp):
    ccfg = video._chroma_cfg(EncodeConfig(qp=qp))
    assert ccfg.tu == 4 and ccfg.ctu == N
    assert chroma_fused._qargs(qp) == (*ccfg.quant_params(False), *ccfg.dequant_params())


def test_registered_and_cpu_runs_the_plain_version():
    assert registry.tiers_of("chroma_p_fused") == Tier.REF | Tier.KERNEL
    assert registry._REGISTRY[("chroma_p_fused", Tier.REF)] is chroma_fused.chroma_p_fused_ref
    assert registry._REGISTRY[("chroma_p_fused", Tier.KERNEL)] is chroma_fused.chroma_p_fused
    rng = np.random.default_rng(3)
    cfg = EncodeConfig(qp=34)
    planes = [torch.as_tensor(p) for p in random_planes(rng, 2 * N, 3 * N)]
    mv = torch.as_tensor(random_mvs(rng, 6, cfg))
    before = chroma_fused.chroma_p_fused.launches
    got = chroma_fused.chroma_p_fused(*planes, mv, cfg)
    assert chroma_fused.chroma_p_fused.launches == before
    want = chroma_fused.chroma_p_fused_ref(*planes, mv, cfg)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert [tuple(x.shape) for x in got] == [(2 * N, 3 * N), (), (2 * N, 3 * N), ()]
    assert [x.dtype for x in got] == [torch.uint8, torch.int32] * 2


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.KERNEL, Tier.REF])
@pytest.mark.parametrize("cuda", [True, False])
@pytest.mark.parametrize("ctu", [64, 32, 16])
def test_route_rule(tiers, cuda, ctu):
    cfg = EncodeConfig(ctu=ctu, search_range=8)
    want = bool(tiers & Tier.KERNEL) and cuda and ctu == 64
    assert video._uses_chroma_kernel(cfg, tiers, SimpleNamespace(is_cuda=cuda)) is want


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.REF])
def test_cpu_frames_keep_the_plain_path(monkeypatch, tiers):
    def refuse(*args, **kwargs):
        raise AssertionError("chroma_p_fused called on a CPU frame")

    rng = np.random.default_rng(11)
    frames = [video.YuvFrame(rng.integers(0, 256, (128, 192), dtype=np.uint8),
                             *(rng.integers(0, 256, (64, 96), dtype=np.uint8) for _ in range(2)))
              for _ in range(2)]
    cfg = EncodeConfig(search_range=8, qp=34)
    want = video.encode_inter_frame_yuv(frames[1], frames[0], cfg, tiers, device="cpu")
    for tier in (Tier.REF, Tier.KERNEL):
        monkeypatch.setitem(registry._REGISTRY, ("chroma_p_fused", tier), refuse)
    got = video.encode_inter_frame_yuv(frames[1], frames[0], cfg, tiers, device="cpu")
    for a, b in zip(got["recon"], want["recon"]):
        assert torch.equal(a, b)
    assert torch.equal(got["nnz"], want["nnz"])


def test_selftest_suite_passes_on_the_cpu(capsys):
    from hevcasm_tpu_torch import selftest

    suite = selftest.PORT_SUITES[0]
    assert suite.op == "chroma_p_fused"
    assert selftest.run_suite(suite, Tier.REF, time_it=False, device="cpu") == 0
    assert capsys.readouterr().out.count("REF:ok") == 2


def test_b_registered_and_cpu_runs_the_plain_composition():
    # The REF tier is the B frame's plain composition (per plane: each
    # reference's int16 MC, the mean, the residual), and the KERNEL tier's
    # wrapper runs it on CPU tensors without counting a launch.
    assert registry.tiers_of("chroma_b_fused") == Tier.REF | Tier.KERNEL
    assert registry._REGISTRY[("chroma_b_fused", Tier.REF)] is chroma_fused.chroma_b_fused_ref
    assert registry._REGISTRY[("chroma_b_fused", Tier.KERNEL)] is chroma_fused.chroma_b_fused
    rng = np.random.default_rng(13)
    cfg = EncodeConfig(qp=32)
    planes = [torch.as_tensor(p) for p in random_planes(rng, 2 * N, 3 * N, 6)]
    mvs = [torch.as_tensor(random_mvs(rng, 6, cfg)) for _ in range(2)]
    before = chroma_fused.chroma_b_fused.launches
    got = chroma_fused.chroma_b_fused(*planes, *mvs, cfg)
    assert chroma_fused.chroma_b_fused.launches == before
    want = []
    for cur, ref0, ref1 in zip(planes[:2], planes[2:4], planes[4:]):
        p0, p1 = (video._chroma_mc(ref, mv, cfg, out16=True).to(torch.int32)
                  for ref, mv in ((ref0, mvs[0]), (ref1, mvs[1])))
        pred = ((p0 + p1 + 64) >> 7).clamp(0, 255).to(torch.uint8)
        want += video._chroma_residual(cur, pred, cfg, False, Tier.ALL)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert [tuple(x.shape) for x in got] == [(2 * N, 3 * N), (), (2 * N, 3 * N), ()]
    assert [x.dtype for x in got] == [torch.uint8, torch.int32] * 2


def small_yuv(rng, h=64, w=64, frames=3):
    return [video.YuvFrame(rng.integers(0, 256, (h, w), dtype=np.uint8),
                           *(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
                             for _ in range(2)))
            for _ in range(frames)]


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.KERNEL, Tier.REF])
@pytest.mark.parametrize("cuda", [True, False])
@pytest.mark.parametrize("ctu", [64, 32, 16])
def test_b_frame_route_rule(monkeypatch, tiers, cuda, ctu):
    # encode_b_frame_yuv asks _uses_chroma_kernel (here answering for a
    # CUDA or a CPU plane) and takes the KERNEL tier of chroma_b_fused where
    # it says so, else the REF tier; both shims run the plain composition.
    real = video._uses_chroma_kernel
    monkeypatch.setattr(video, "_uses_chroma_kernel",
                        lambda cfg, t, plane: real(cfg, t, SimpleNamespace(is_cuda=cuda)))
    monkeypatch.setattr(registry, "_usable", lambda tier: True)
    called = []
    for tier in (Tier.REF, Tier.KERNEL):
        def shim(*args, tier=tier):
            called.append(tier)
            return chroma_fused.chroma_b_fused_ref(*args)

        monkeypatch.setitem(registry._REGISTRY, ("chroma_b_fused", tier), shim)
    frames = small_yuv(np.random.default_rng(ctu))
    cfg = EncodeConfig(ctu=ctu, search_range=8, qp=32)
    video.encode_b_frame_yuv(frames[1], frames[0], frames[2], cfg, tiers, device="cpu")
    want = Tier.KERNEL if bool(tiers & Tier.KERNEL) and cuda and ctu == 64 else Tier.REF
    assert called == [want]


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.REF])
def test_b_cpu_frames_keep_the_plain_path(monkeypatch, tiers):
    def refuse(*args, **kwargs):
        raise AssertionError("chroma_b_fused's kernel called on a CPU frame")

    frames = small_yuv(np.random.default_rng(17), 128, 192)
    cfg = EncodeConfig(search_range=8, qp=32)
    want = video.encode_b_frame_yuv(frames[1], frames[0], frames[2], cfg, tiers, device="cpu")
    monkeypatch.setitem(registry._REGISTRY, ("chroma_b_fused", Tier.KERNEL), refuse)
    got = video.encode_b_frame_yuv(frames[1], frames[0], frames[2], cfg, tiers, device="cpu")
    for a, b in zip(got["recon"], want["recon"]):
        assert torch.equal(a, b)
    assert torch.equal(got["nnz"], want["nnz"])


def test_selftest_b_suite_passes_on_the_cpu(capsys):
    from hevcasm_tpu_torch import selftest

    assert [s.op for s in selftest.PORT_SUITES] == ["chroma_p_fused", "chroma_b_fused"]
    assert selftest.run_suite(selftest.PORT_SUITES[1], Tier.REF, time_it=False,
                              device="cpu") == 0
    assert capsys.readouterr().out.count("REF:ok") == 2


# ---- chroma_pu_fused's wrapper, the MV field's plain path and the RD frame's route ------

def test_pu_registered_and_cpu_runs_the_plain_version():
    assert registry.tiers_of("chroma_pu_fused") == Tier.REF | Tier.KERNEL
    assert registry._REGISTRY[("chroma_pu_fused", Tier.REF)] is chroma_fused.chroma_p_fused_ref
    assert registry._REGISTRY[("chroma_pu_fused", Tier.KERNEL)] is chroma_fused.chroma_pu_fused
    rng = np.random.default_rng(23)
    cfg = EncodeConfig(qp=33)
    planes = [torch.as_tensor(p) for p in random_planes(rng, 2 * N, 3 * N)]
    field = torch.as_tensor(random_field(rng, 6, 8, cfg))
    before = chroma_fused.chroma_pu_fused.launches
    got = chroma_fused.chroma_pu_fused(*planes, field, cfg)
    assert chroma_fused.chroma_pu_fused.launches == before
    want = chroma_fused.chroma_p_fused_ref(*planes, field, cfg)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert [tuple(x.shape) for x in got] == [(2 * N, 3 * N), (), (2 * N, 3 * N), ()]


@pytest.mark.parametrize("k", chroma_fused.PU_TILES)
def test_a_field_of_one_mv_a_block_is_todays_path(k):
    # Granularity 1 is the fixed frame's path: a field whose tiles all take
    # their block's MV predicts what the (n, 2) MVs predict, on both
    # outputs of _chroma_mc, at any k.
    rng = np.random.default_rng(31 + k)
    cfg = EncodeConfig(qp=35, search_range=16)
    plane = torch.as_tensor(random_planes(rng, 2 * N, 3 * N, 1)[0])
    mv = torch.as_tensor(random_mvs(rng, 6, cfg))
    field = mv[:, None, None].expand(6, k, k, 2)
    for out16 in (False, True):
        want = video._chroma_mc(plane, mv, cfg, out16=out16)
        got = video._chroma_mc(plane, field, cfg, out16=out16)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("k", (8, 4, 2))
def test_pu_plain_prediction_is_each_tile_at_its_mv(k):
    # _chroma_mc on a field against each (32 / k)-square tile predicted on
    # its own from the edge-extended plane at its MV.
    from hevcasm_tpu_torch.ops.pred_inter import pred_uni

    rng = np.random.default_rng(41 + k)
    cfg = EncodeConfig(qp=35, search_range=8)
    plane = torch.as_tensor(random_planes(rng, 2 * N, 3 * N, 1)[0])
    field = torch.as_tensor(outward_field(rng, 2, 3, k, cfg))
    got = video._chroma_mc(plane, field, cfg)
    pad = 16
    padded = ctu_mod.pad_frame(plane, pad, pad, pad, pad)
    t = N // k
    for i in range(6):
        for ty in range(k):
            for tx in range(k):
                dy, dx = (int(v) for v in field[i, ty, tx])
                y = N * (i // 3) + t * ty + (dy >> 3) - 1 + pad
                x = N * (i % 3) + t * tx + (dx >> 3) - 1 + pad
                want = pred_uni(padded[y:y + t + 3, x:x + t + 3], dx & 7, dy & 7, 4)
                assert torch.equal(got[i, t * ty:t * ty + t, t * tx:t * tx + t], want), \
                    (i, ty, tx)


@pytest.mark.parametrize("kw,want", [
    (dict(pu_decision=True, pu_layouts=("2Nx2N", "NxN", "quarter", "eighth")),
     "chroma_pu_fused"),
    (dict(pu_decision=True), "chroma_pu_fused"),
    (dict(tu_sizes=(4, 8)), "chroma_p_fused"),
    (dict(), "chroma_p_fused")])
@pytest.mark.parametrize("cuda", [True, False])
def test_rd_frame_route_rule(monkeypatch, kw, want, cuda):
    # encode_inter_frame_yuv asks _uses_chroma_kernel (here answering for a
    # CUDA or a CPU plane): the PU decision's field takes chroma_pu_fused's
    # KERNEL tier, one MV a CTU chroma_p_fused's, a CPU plane neither; the
    # shims run the plain version.
    real = video._uses_chroma_kernel
    monkeypatch.setattr(video, "_uses_chroma_kernel",
                        lambda cfg, t, plane: real(cfg, t, SimpleNamespace(is_cuda=cuda)))
    monkeypatch.setattr(registry, "_usable", lambda tier: True)
    called = []
    for op in ("chroma_p_fused", "chroma_pu_fused"):
        def shim(*args, op=op):
            called.append(op)
            return chroma_fused.chroma_p_fused_ref(*args)

        monkeypatch.setitem(registry._REGISTRY, (op, Tier.KERNEL), shim)
    frames = small_yuv(np.random.default_rng(51), 64, 128, 2)
    cfg = EncodeConfig(search_range=8, qp=32, **kw)
    got = video.encode_inter_frame_yuv(frames[1], frames[0], cfg, device="cpu")
    assert called == ([want] if cuda else [])
    monkeypatch.setattr(video, "_uses_chroma_kernel", lambda cfg, t, plane: False)
    plain = video.encode_inter_frame_yuv(frames[1], frames[0], cfg, device="cpu")
    for a, b in zip(got["recon"], plain["recon"]):
        assert torch.equal(a, b)
    assert torch.equal(got["nnz"], plain["nnz"])
