"""Kernel chroma_p_fused (csrc/chroma_fused.cu, kernels/chroma_fused.py) on
the CPU, and the rule by which encode_inter_frame_yuv takes it.

The kernel's CTA body (chroma::code_block, all of csrc/chroma_fused.cu above
its kernel and C entry) is compiled for the CPU with tests/warp_emu.h, over
the two cores it runs (csrc/mc_tc.cuh and csrc/residual_core.cuh, their
inline PTX replaced by the emulated mma.sync and plain copies for cp.async,
as tests/torch_testing.py builds them for every emulated test): a
CTA of one warp, 32 threads that meet at a barrier at each product, shuffle
and __syncthreads, its shared memory poisoned, the output planes poisoned
outside the blocks it codes.  It is held bit for bit against the plain
version, chroma_p_fused_ref (encode.video._chroma_mc then _chroma_residual
at Tier.REF): the reconstruction of each block it codes and both planes'
nnz, on a plane of 2 x 3 blocks and the 1080p and 4K chroma plane shapes
(the border blocks and some inside ones), at every eighth-pel fraction on
both axes, with MVs that take the window past each edge of the plane (to
the plain version's padding: clamping equals pad_frame there), at the
chroma QPs of ldp1080_live (qPc 33, 33, 33, 32) and one below 30, on random
and full-swing (0/255 checkerboard and stripes) content.  On the card the
kernel is held against the plain version in test_torch_cuda.py and
chip_smoke.py."""

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

// stdin: h w qscale qshift qoffset dscale dshift runs seed, then the planes
// cur_cb, cur_cr, ref_cb, ref_cr (h x w bytes each), the (h / 32) (w / 32)
// MVs (dy, dx), and the indices of the blocks to code; stdout: each coded
// block's 32 x 32 reconstruction of Cb then Cr, nnz[0], nnz[1], then the
// number of output bytes outside the coded blocks that changed.  A CTA of
// one warp: 32 threads, one a lane; shared memory poisoned.
static uint8_t* aligned16(std::vector<uint8_t>& v, size_t n) {
  v.assign(n + 16, 77);
  return v.data() + (16 - reinterpret_cast<uintptr_t>(v.data()) % 16) % 16;
}

int main() {
  long long h, w, q[5];
  int runs;
  unsigned seed;
  if (scanf("%lld %lld %lld %lld %lld %lld %lld %d %u", &h, &w, &q[0], &q[1], &q[2], &q[3],
            &q[4], &runs, &seed) != 9)
    return 1;
  std::vector<uint8_t> store[7];
  uint8_t* plane[6];
  for (int j = 0; j < 6; ++j) plane[j] = aligned16(store[j], h * w);
  for (int j = 0; j < 4; ++j)
    for (long long k = 0; k < h * w; ++k) {
      int x;
      if (scanf("%d", &x) != 1) return 1;
      plane[j][k] = static_cast<uint8_t>(x);
    }
  const long long n = (h / 32) * (w / 32);
  std::vector<int32_t> mv(2 * n);
  for (auto& v : mv)
    if (scanf("%d", &v) != 1) return 1;
  std::vector<long long> run(runs);
  for (auto& i : run)
    if (scanf("%lld", &i) != 1) return 1;
  int32_t nnz[2] = {0, 0};
  ChromaArgs a{};
  for (int p = 0; p < 2; ++p) {
    a.cur[p] = reinterpret_cast<long long>(plane[p]);
    a.ref[p] = reinterpret_cast<long long>(plane[2 + p]);
    a.rec[p] = reinterpret_cast<long long>(plane[4 + p]);
  }
  a.mv = reinterpret_cast<long long>(mv.data());
  a.nnz = reinterpret_cast<long long>(nnz);
  a.h = h;
  a.w = w;
  for (int k = 0; k < 5; ++k) a.q[k] = q[k];
  uint8_t* smem = aligned16(store[6], chroma::SMEM);
  std::mt19937 poison(seed);
  for (long long i : run) {
    for (int k = 0; k < chroma::SMEM; ++k) smem[k] = static_cast<uint8_t>(poison());
    emu_run_block([&] { chroma::code_block(a, i, 32, smem); });
  }
  const long long gc = w / 32;
  std::vector<char> coded(h * w, 0);
  for (long long i : run)
    for (int p = 0; p < 2; ++p)
      for (int r = 0; r < 32; ++r)
        for (int c = 0; c < 32; ++c) {
          const long long k = (32 * (i / gc) + r) * w + 32 * (i % gc) + c;
          printf("%d ", plane[4 + p][k]);
          coded[k] = 1;
        }
  int changed = 0;
  for (int p = 0; p < 2; ++p)
    for (long long k = 0; k < h * w; ++k) changed += !coded[k] && plane[4 + p][k] != 77;
  printf("%d %d %d\n", nnz[0], nnz[1], changed);
  return 0;
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


def plain(planes, mv, cfg):
    """chroma_p_fused_ref's (rec_cb, rec_cr) planes and nnz, and the nnz of
    each block and plane (n, 2) from the same plain prediction."""
    t = [torch.as_tensor(p) for p in planes]
    mv_t = torch.as_tensor(mv)
    rec_cb, nnz_cb, rec_cr, nnz_cr = chroma_fused.chroma_p_fused_ref(*t, mv_t, cfg)
    q = chroma_fused._qargs(cfg.qp)
    per_block = []
    for cur, ref in ((t[0], t[2]), (t[1], t[3])):
        pred = video._chroma_mc(ref, mv_t, cfg)
        _, levels, _ = residual_levels(ctu_mod.tile_frame(cur, N), pred, *q, tu=4)
        per_block.append((levels != 0).reshape(pred.shape[0], -1).sum(-1).numpy())
    per_block = np.stack(per_block, axis=1)
    assert per_block.sum(0).tolist() == [int(nnz_cb), int(nnz_cr)]
    return np.stack([rec_cb.numpy(), rec_cr.numpy()]), per_block


def emulate(exe, planes, mv, cfg, blocks, seed=7):
    """The emulated kernel over ``blocks``: (their reconstructions (k, 2, 32,
    32), both planes' nnz over them, bytes changed outside them)."""
    h, w = planes[0].shape
    stdin = " ".join(map(str, (h, w, *chroma_fused._qargs(cfg.qp), len(blocks), seed,
                               *np.concatenate([p.ravel() for p in planes]), *mv.ravel(),
                               *blocks)))
    out = torch_testing.run_emulator(exe, stdin, f"{h}x{w} qp {cfg.qp} seed {seed}").split()
    vals = np.array(out, dtype=np.int64)
    return vals[:-3].reshape(len(blocks), 2, N, N), vals[-3:-1], int(vals[-1])


def assert_kernel_equals_plain(exe, planes, mv, cfg, blocks=None, seed=7):
    gr, gc = planes[0].shape[0] // N, planes[0].shape[1] // N
    blocks = list(range(gr * gc)) if blocks is None else blocks
    want_rec, want_nnz = plain(planes, mv, cfg)
    rec, nnz, changed = emulate(exe, planes, mv, cfg, blocks, seed)
    assert changed == 0, "a store outside the coded blocks"
    for k, i in enumerate(blocks):
        y, x = N * (i // gc), N * (i % gc)
        np.testing.assert_array_equal(rec[k], want_rec[:, y:y + N, x:x + N],
                                      err_msg=f"block {i}")
    np.testing.assert_array_equal(nnz, want_nnz[blocks].sum(0))


def random_planes(rng, h, w):
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(4)]


def full_swing(h, w, kind):
    """0/255 content: a checkerboard of 1-pixel cells (cur) over one of
    2-pixel cells (ref), or vertical stripes over horizontal ones."""
    y, x = np.mgrid[:h, :w]
    if kind == "checkerboard":
        pats = [(y + x) & 1, ((y >> 1) + (x >> 1)) & 1, (y + x + 1) & 1, ((y >> 1) + x) & 1]
    else:
        pats = [x & 1, y & 1, (x >> 1) & 1, (y >> 2) & 1]
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


# ldp1080_live's luma QPs 35, 34, 35, 33 code chroma at qPc 33, 33, 33, 32;
# 22 stays below 30, where qPc = qp.
QPS = (35, 34, 33, 22)


@pytest.mark.parametrize("qp", QPS)
def test_small_plane_random(emulated_chroma, qp):
    rng = np.random.default_rng(qp)
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               random_mvs(rng, 6, cfg), cfg)


@pytest.mark.parametrize("qp", (35, 22))
def test_every_fraction_on_both_axes(emulated_chroma, qp):
    # 64 blocks, block i at fraction (i // 8, i % 8) and a random integer MV.
    rng = np.random.default_rng(100 + qp)
    cfg = EncodeConfig(qp=qp, search_range=16)
    mv = random_mvs(rng, 64, cfg) & ~7
    mv[:, 0] |= np.arange(64) // 8
    mv[:, 1] |= np.arange(64) % 8
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 8 * N, 8 * N), mv, cfg)


@pytest.mark.parametrize("r", (32, 8))
def test_windows_past_each_edge(emulated_chroma, r):
    rng = np.random.default_rng(r)
    cfg = EncodeConfig(qp=33, search_range=r)
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, 2 * N, 3 * N),
                               outward_mvs(rng, 2, 3, cfg), cfg)


@pytest.mark.parametrize("shape", [(544, 960), (1088, 1920)], ids=["1080p", "4K"])
def test_frame_plane_shapes(emulated_chroma, shape):
    # The corners, the middle of each edge and two blocks inside, their
    # windows past the edges they touch.
    h, w = shape
    gr, gc = h // N, w // N
    rng = np.random.default_rng(h)
    cfg = EncodeConfig(qp=35)
    blocks = [0, gc // 2, gc - 1, (gr // 2) * gc, (gr // 2) * gc + gc - 1, (gr - 1) * gc,
              (gr - 1) * gc + gc // 3, gr * gc - 1, (gr // 3) * gc + gc // 4,
              (2 * gr // 3) * gc + 2 * gc // 3]
    assert_kernel_equals_plain(emulated_chroma, random_planes(rng, h, w),
                               outward_mvs(rng, gr, gc, cfg), cfg, blocks)


@pytest.mark.parametrize("kind", ["checkerboard", "stripes"])
@pytest.mark.parametrize("qp", (35, 22))
def test_full_swing_content(emulated_chroma, kind, qp):
    rng = np.random.default_rng(qp + len(kind))
    cfg = EncodeConfig(qp=qp)
    assert_kernel_equals_plain(emulated_chroma, full_swing(2 * N, 3 * N, kind),
                               outward_mvs(rng, 2, 3, cfg), cfg)


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

    suite, = selftest.PORT_SUITES
    assert suite.op == "chroma_p_fused"
    assert selftest.run_suite(suite, Tier.REF, time_it=False, device="cpu") == 0
    assert capsys.readouterr().out.count("REF:ok") == 2
