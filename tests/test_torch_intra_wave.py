"""Kernel intra_wave_fused (csrc/intra_wave.cu, kernels/intra_wave.py) on the
CPU, and the rule by which encode_intra_frame_wavefront takes it.

The kernel's CTA body (iwave::code_block, all of csrc/intra_wave.cu above
its kernel and C entry) is compiled for the CPU with tests/warp_emu.h, over
csrc/residual_core.cuh with its inline PTX replaced by the emulated
mma.sync (as tests/torch_testing.py builds it): a CTA of one warp,
32 threads that meet at a barrier at each product, shuffle and
__syncthreads, its shared memory poisoned before each block.  The emulated
kernel codes whole frames wave by wave from the wave tables of
encode.intra_wavefront._schedule, and is held bit for bit against the plain
version, intra_wave_ref, run wave by wave on the same tables: after every
wave the whole canvas (so also what it must leave alone), the modes chosen
and the frame's nnz so far.  Frames of 2 x 3 blocks, one block column
(whose odd waves are empty) and 3 x 5 blocks (the above-right run leaves
the frame), at QP 22, 32 and 37 with strong intra smoothing on and off, on
random, flat (strong smoothing engages) and full-swing content
(checkerboards and stripes: near-ties between modes).  On the card the
kernel is held against the plain version in test_torch_cuda.py and
chip_smoke.py."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_testing
from hevcasm_tpu_torch import Tier, registry
from hevcasm_tpu_torch.encode import ctu as ctu_mod
from hevcasm_tpu_torch.encode import intra_wavefront
from hevcasm_tpu_torch.encode.intra_wavefront import encode_intra_frame_wavefront
from hevcasm_tpu_torch.encode.loop import EncodeConfig
from hevcasm_tpu_torch.kernels import intra_wave
from hevcasm_tpu_torch.ops.pred_intra import strong_smoothing_condition, substitute_references

N = intra_wave.BLOCK

EMULATED_MAIN = r"""
#include "intra_body.cuh"

#include <cstdio>
#include <random>
#include <vector>

// stdin: h w qscale qshift qoffset dscale dshift strong num waves seed, then
// the tables: src (num x 1024 bytes, wave order), order (num), refs (num x
// 129), lav, aav (num x 64 each), cav (num), the waves' spans (start stop);
// stdout: after each wave the whole canvas (h w bytes, tiled), the frame's
// nnz so far and the wave's modes.  A CTA of one warp: 32 threads, one a
// lane; shared memory poisoned before each block.
template <class T>
static bool read_all(std::vector<T>& v, size_t n) {
  v.resize(n);
  for (auto& x : v) {
    long long y;
    if (scanf("%lld", &y) != 1) return false;
    x = static_cast<T>(y);
  }
  return true;
}

int main() {
  long long h, w, q[5], strong, num;
  int waves;
  unsigned seed;
  if (scanf("%lld %lld %lld %lld %lld %lld %lld %lld %lld %d %u", &h, &w, &q[0], &q[1], &q[2],
            &q[3], &q[4], &strong, &num, &waves, &seed) != 11)
    return 1;
  std::vector<uint8_t> src, lav, aav, cav;
  std::vector<long long> order, refs, spans;
  if (!read_all(src, num * 1024) || !read_all(order, num) || !read_all(refs, num * 129) ||
      !read_all(lav, num * 64) || !read_all(aav, num * 64) || !read_all(cav, num) ||
      !read_all(spans, 2 * waves))
    return 1;
  std::vector<uint8_t> canvas_store(h * w + 16);
  uint8_t* canvas = canvas_store.data() +
                    (16 - reinterpret_cast<uintptr_t>(canvas_store.data()) % 16) % 16;
  for (long long k = 0; k < h * w; ++k) canvas[k] = 128;
  std::vector<int32_t> modes(num, -1);
  int32_t nnz = 0;
  IntraWaveArgs a{};
  a.canvas = reinterpret_cast<long long>(canvas);
  a.src = reinterpret_cast<long long>(src.data());
  a.order = reinterpret_cast<long long>(order.data());
  a.refs = reinterpret_cast<long long>(refs.data());
  a.lav = reinterpret_cast<long long>(lav.data());
  a.aav = reinterpret_cast<long long>(aav.data());
  a.cav = reinterpret_cast<long long>(cav.data());
  a.nnz = reinterpret_cast<long long>(&nnz);
  a.modes = reinterpret_cast<long long>(modes.data());
  a.num = num;
  a.strong = strong;
  for (int k = 0; k < 5; ++k) a.q[k] = q[k];
  auto* sm = new iwave::Smem;
  std::mt19937 poison(seed);
  for (int v = 0; v < waves; ++v) {
    a.start = spans[2 * v];
    a.stop = spans[2 * v + 1];
    for (long long row = a.start; row < a.stop; ++row) {
      auto* bytes = reinterpret_cast<uint8_t*>(sm);
      for (size_t k = 0; k < sizeof(iwave::Smem); ++k) bytes[k] = static_cast<uint8_t>(poison());
      emu_run_block([&] { iwave::code_block(a, row, 32, *sm); });
    }
    for (long long k = 0; k < h * w; ++k) printf("%d ", canvas[k]);
    printf("%d", nnz);
    for (long long row = a.start; row < a.stop; ++row) printf(" %d", modes[row]);
    printf("\n");
  }
  delete sm;
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated_wave(tmp_path_factory):
    """iwave::code_block built for the CPU over residual_core.cuh, its
    inline PTX replaced as for test_torch_residual_tc.py.  Skips
    without a C++20 compiler."""
    tmp = tmp_path_factory.mktemp("intra_wave_emu")
    torch_testing.emulated_residual_core(tmp)
    torch_testing.kernel_body(tmp, "intra_wave.cu", "intra_body.cuh")
    return torch_testing.build_emulator(tmp, EMULATED_MAIN, "intra_wave")


def tables(h, w):
    """The wave tables on the CPU and the non-empty waves' spans."""
    spans, order, refs, lav, aav, cav = intra_wavefront._schedule(h, w, N, torch.device("cpu"))
    return [(s, e) for s, e in spans if s < e], order, refs, lav, aav, cav


def plain_waves(frame, cfg):
    """intra_wave_ref wave by wave: [(canvas, nnz, modes of the wave)] after
    each wave, and how many blocks met the strong-smoothing condition."""
    h, w = frame.shape
    spans, order, refs, lav, aav, cav = tables(h, w)
    cur = torch.as_tensor(frame)
    src = ctu_mod.tile_frame(cur, N).index_select(0, order)
    canvas = torch.full((h * w,), intra_wavefront.UNAVAILABLE, dtype=torch.uint8)
    nnz = torch.zeros((), dtype=torch.int32)
    modes = torch.full((order.shape[0],), -1, dtype=torch.int32)
    out, flat = [], 0
    for s, e in spans:
        nb = canvas.index_select(0, refs[s:e].reshape(-1)).view(e - s, 4 * N + 1)
        sub = substitute_references(nb[:, :2 * N], nb[:, 2 * N:4 * N], nb[:, 4 * N],
                                    lav[s:e], aav[s:e], cav[s:e])
        flat += int(strong_smoothing_condition(*sub).sum())
        intra_wave.intra_wave_ref(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg,
                                  modes)
        out.append((canvas.numpy().copy(), int(nnz), modes[s:e].numpy().copy()))
    return out, flat


def emulated_waves(exe, frame, cfg, seed=7):
    """The emulated kernel wave by wave: [(canvas, nnz, modes of the wave)]."""
    h, w = frame.shape
    spans, order, refs, lav, aav, cav = tables(h, w)
    src = ctu_mod.tile_frame(torch.as_tensor(frame), N).index_select(0, order)
    head = (h, w, *intra_wave._qargs(cfg.qp), int(cfg.strong_intra_smoothing), order.shape[0],
            len(spans), seed)
    body = [t.reshape(-1).to(torch.int64).numpy() for t in (src, order, refs, lav, aav, cav)]
    stdin = " ".join(map(str, (*head, *np.concatenate(body), *np.ravel(spans))))
    lines = torch_testing.run_emulator(exe, stdin,
                                       f"{h}x{w} qp {cfg.qp} seed {seed}").splitlines()
    out = []
    for line, (s, e) in zip(lines, spans, strict=True):
        vals = np.array(line.split(), dtype=np.int64)
        out.append((vals[:h * w].astype(np.uint8), int(vals[h * w]), vals[h * w + 1:]))
    return out


def assert_kernel_equals_plain(exe, frame, cfg, seed=7):
    want, flat = plain_waves(frame, cfg)
    got = emulated_waves(exe, frame, cfg, seed)
    assert len(got) == len(want)
    for k, ((canvas, nnz, modes), (w_canvas, w_nnz, w_modes)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(canvas, w_canvas, err_msg=f"canvas after wave {k}")
        np.testing.assert_array_equal(modes, w_modes, err_msg=f"modes of wave {k}")
        assert nnz == w_nnz, f"nnz after wave {k}"
    return flat


def content(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    if kind == "random":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "flat":
        # Near-constant with a gentle ramp: every edge near-linear.
        return np.clip(90 + (y + 2 * x) // 24 + rng.integers(0, 2, (h, w)), 0, 255).astype(np.uint8)
    if kind == "checkerboard":
        return (255 * ((y + x) & 1)).astype(np.uint8)
    return (255 * ((x >> 1) & 1 if seed & 1 else (y >> 2) & 1)).astype(np.uint8)


SHAPES = {"2x3": (2 * N, 3 * N), "column": (4 * N, N), "3x5": (3 * N, 5 * N)}
CONTENTS = ("random", "flat", "checkerboard", "stripes")
SETTINGS = [(qp, strong) for qp in (22, 32, 37) for strong in (True, False)]


@pytest.mark.parametrize("kind", CONTENTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_frames_wave_by_wave(emulated_wave, shape, kind):
    # Each (QP, smoothing) pair falls on two of the twelve cases.
    i = list(SHAPES).index(shape) * len(CONTENTS) + CONTENTS.index(kind)
    qp, strong = SETTINGS[i % len(SETTINGS)]
    h, w = SHAPES[shape]
    cfg = EncodeConfig(qp=qp, strong_intra_smoothing=strong)
    assert_kernel_equals_plain(emulated_wave, content(kind, h, w, i), cfg, seed=i)


@pytest.mark.parametrize("qp,strong", SETTINGS)
def test_every_quantizer_and_smoothing(emulated_wave, qp, strong):
    h, w = SHAPES["3x5"]
    cfg = EncodeConfig(qp=qp, strong_intra_smoothing=strong)
    flat = assert_kernel_equals_plain(emulated_wave, content("flat", h, w, qp), cfg, seed=qp)
    assert flat > 0, "no block met the strong-smoothing condition"


def test_odd_waves_of_one_column_are_empty():
    spans = intra_wavefront._schedule(4 * N, N, N, torch.device("cpu"))[0]
    assert [e - s for s, e in spans] == [1, 0, 1, 0, 1, 0, 1]
    assert len(tables(4 * N, N)[0]) == 4


# ---- the wrapper and the route on the CPU ----------------------------------------------

@pytest.mark.parametrize("qp", (0, 22, 32, 37, 51))
def test_quantizer_is_the_intra_one_at_8x8(qp):
    cfg = EncodeConfig(qp=qp)
    assert cfg.tu == intra_wave.TU
    assert intra_wave._qargs(qp) == (*cfg.quant_params(intra=True), *cfg.dequant_params())


def test_registered_and_cpu_runs_the_plain_version():
    assert registry.tiers_of("intra_wave") == Tier.REF | Tier.KERNEL
    assert registry._REGISTRY[("intra_wave", Tier.REF)] is intra_wave.intra_wave_ref
    assert registry._REGISTRY[("intra_wave", Tier.KERNEL)] is intra_wave.intra_wave_fused
    frame = content("random", 2 * N, 3 * N, 5)
    cfg = EncodeConfig(qp=32)
    want, _ = plain_waves(frame, cfg)
    spans, order, refs, lav, aav, cav = tables(*frame.shape)
    src = ctu_mod.tile_frame(torch.as_tensor(frame), N).index_select(0, order)
    canvas = torch.full((frame.size,), intra_wavefront.UNAVAILABLE, dtype=torch.uint8)
    nnz = torch.zeros((), dtype=torch.int32)
    before = intra_wave.intra_wave_fused.launches
    for s, e in spans:
        intra_wave.intra_wave_fused(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg)
    assert intra_wave.intra_wave_fused.launches == before
    np.testing.assert_array_equal(canvas.numpy(), want[-1][0])
    assert int(nnz) == want[-1][1]


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.KERNEL, Tier.REF])
@pytest.mark.parametrize("cuda", [True, False])
@pytest.mark.parametrize("n,tu", [(32, 8), (32, 4), (16, 8), (64, 8), (32, 16)])
def test_route_rule(tiers, cuda, n, tu):
    cfg = EncodeConfig(intra_block=n, tu=tu)
    want = bool(tiers & Tier.KERNEL) and cuda and n == 32 and tu == 8
    assert intra_wavefront._uses_intra_kernel(cfg, tiers, SimpleNamespace(is_cuda=cuda)) is want


@pytest.mark.parametrize("tiers", [Tier.ALL, Tier.REF])
@pytest.mark.parametrize("n,tu", [(32, 8), (32, 4), (16, 8)])
def test_cpu_frames_keep_the_plain_path(monkeypatch, tiers, n, tu):
    frame = content("random", 2 * 32, 3 * 32, n + tu)
    cfg = dataclasses.replace(EncodeConfig(qp=30), intra_block=n, tu=tu)
    want = encode_intra_frame_wavefront(frame, cfg, tiers, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("intra_wave_fused called on a CPU frame")

    monkeypatch.setattr(intra_wave, "intra_wave_fused", refuse)
    monkeypatch.setitem(registry._REGISTRY, ("intra_wave", Tier.KERNEL), refuse)
    got = encode_intra_frame_wavefront(frame, cfg, tiers, device="cpu")
    assert torch.equal(got["recon"], want["recon"])
    assert torch.equal(got["nnz"], want["nnz"])
