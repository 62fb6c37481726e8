"""The port's spans (hevcasm_tpu_torch.utils.trace) on the CPU: off without
a profiler (one shared null context, nothing recorded), host ranges at
scope FUNCTION under one, nested as documented in a 4:2:0 P frame, a
closed-loop 4:2:0 IPPP GOP, closed-loop 4:2:0 IBPBP GOPs and the RD P frame
(4:2:0 and luma), and the outputs bit-identical traced and untraced.  A
128x64 clip at R = 8, an IPPP GOP of 3 frames and IBPBP GOPs of 3 and 5; a
few seconds."""

import collections
import contextlib

import numpy as np
import pytest
import torch

import torch_testing  # noqa: F401
from hevcasm_tpu_torch.encode import EncodeConfig, YuvFrame, loop, partition, video
from hevcasm_tpu_torch.encode.intra_wavefront import _schedule
from hevcasm_tpu_torch.utils import trace

H, W, R, T = 64, 128, 8, 3
CFG = EncodeConfig(search_range=R, inter_impl="fused_dma")

#: Each span's innermost enclosing span in a P frame coded alone.
P_PARENT = {
    "hevcasm.inter_yuv": None,
    "hevcasm.luma": "hevcasm.inter_yuv",
    "hevcasm.search": "hevcasm.luma",
    "hevcasm.refine_code": "hevcasm.luma",
    "hevcasm.chroma": "hevcasm.inter_yuv",
    "hevcasm.chroma_mc": "hevcasm.chroma",
    "hevcasm.chroma_residual": "hevcasm.chroma",
    "hevcasm.psnr": "hevcasm.inter_yuv",
}
#: And in a closed-loop GOP, whose P frames are its children.
GOP_PARENT = {
    **P_PARENT,
    "hevcasm.inter_yuv": "hevcasm.gop_closed_yuv",
    "hevcasm.gop_closed_yuv": None,
    "hevcasm.intra": "hevcasm.gop_closed_yuv",
    "hevcasm.intra_luma": "hevcasm.intra",
    "hevcasm.intra_wave": "hevcasm.intra_luma",
    "hevcasm.intra_chroma": "hevcasm.intra",
    "hevcasm.gop_stack": "hevcasm.gop_closed_yuv",
}
#: Spans a P frame records, a frame.
P_COUNT = {name: 2 if name in ("hevcasm.chroma_mc", "hevcasm.chroma_residual") else 1
           for name in P_PARENT}
#: The RD P frame: the six PU layouts and four TU sizes.
CFG_RD = EncodeConfig(search_range=R, pu_decision=True, pu_layouts=tuple(partition.PU_LAYOUTS),
                      tu_sizes=(4, 8, 16, 32))
#: Each span's innermost enclosing span in an RD 4:2:0 P frame coded alone
#: (its chroma on the plain path, as P_PARENT's).
RD_PARENT = {
    **{k: v for k, v in P_PARENT.items() if k not in ("hevcasm.search", "hevcasm.refine_code")},
    "hevcasm.pu_decision": "hevcasm.luma",
    "hevcasm.pu_grids": "hevcasm.pu_decision",
    "hevcasm.pu_layout": "hevcasm.pu_decision",
    "hevcasm.pu_refine": "hevcasm.pu_decision",
    "hevcasm.tu_select": "hevcasm.luma",
}
#: And in the RD luma frame (encode_inter_frame), which records only the
#: decisions' spans.
RD_LUMA_PARENT = {k: None if v == "hevcasm.luma" else v for k, v in RD_PARENT.items()
                  if k.startswith(("hevcasm.pu_", "hevcasm.tu_"))}
#: The spans of a closed-loop IBPBP GOP: (name, innermost enclosing span) and
#: how many a GOP records, for n = (T - 1) / 2 P and n B frames and the I
#: frame's waves (intra_wave).  Each B frame's chroma runs two chroma_mc (a
#: reference each) and one chroma_residual a plane.
B_GOP = "hevcasm.gop_closed_yuv_b"


def _b_gop_nest(n: int, waves: int) -> dict:
    p_frame = {(name, parent if parent else B_GOP): n * P_COUNT[name]
               for name, parent in P_PARENT.items()}
    return {(B_GOP, None): 1, ("hevcasm.gop_stack", B_GOP): 1,
            ("hevcasm.intra", B_GOP): 1, ("hevcasm.intra_luma", "hevcasm.intra"): 1,
            ("hevcasm.intra_wave", "hevcasm.intra_luma"): waves,
            ("hevcasm.intra_chroma", "hevcasm.intra"): 1, **p_frame,
            ("hevcasm.inter_b_yuv", B_GOP): n,
            ("hevcasm.bi_luma", "hevcasm.inter_b_yuv"): n,
            ("hevcasm.bi_chroma", "hevcasm.inter_b_yuv"): n,
            ("hevcasm.chroma_mc", "hevcasm.bi_chroma"): 4 * n,
            ("hevcasm.chroma_residual", "hevcasm.bi_chroma"): 2 * n,
            ("hevcasm.psnr", "hevcasm.inter_b_yuv"): n}


def _plane(rng, h, w, t=T):
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    out = np.stack([base[2 * i:2 * i + h, 3 * i:3 * i + w] for i in range(t)])
    out = np.rint(out + rng.integers(-3, 4, out.shape))
    return torch.as_tensor(np.clip(out, 0, 255).astype(np.uint8))


def _clip(t=T) -> YuvFrame:
    rng = np.random.default_rng(0x48455643)
    return YuvFrame(_plane(rng, H, W, t), _plane(rng, H // 2, W // 2, t),
                    _plane(rng, H // 2, W // 2, t))


def _waves() -> int:
    return sum(s != e for s, e in _schedule(H, W, CFG.intra_block, torch.device("cpu"))[0])


def _code(clip: YuvFrame):
    """The P frame 1 from frame 0 coded alone, and the whole GOP."""
    at = [YuvFrame(*(p[t] for p in clip)) for t in range(T)]
    return (video.encode_inter_frame_yuv(at[1], at[0], CFG),
            video.encode_gop_closed_loop_yuv(clip, CFG))


def _events(prof, names=None):
    """(name, start ns, end ns, scope, user annotation) of the port's spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hevcasm."):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.scope(),
                        e.is_user_annotation()))
    return out


def _parent(ev, events):
    """The innermost other span that contains ``ev``'s interval."""
    inside = [o for o in events if o is not ev and o[1] <= ev[1] and ev[2] <= o[2]]
    return min(inside, key=lambda o: o[2] - o[1])[0] if inside else None


@pytest.fixture(scope="module")
def coded():
    clip = _clip()
    plain = _code(clip)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof_p:
        at = [YuvFrame(*(p[t] for p in clip)) for t in range(2)]
        traced_p = video.encode_inter_frame_yuv(at[1], at[0], CFG)
    with torch.profiler.profile(activities=acts) as prof_g:
        traced_g = video.encode_gop_closed_loop_yuv(clip, CFG)
    return {"plain": plain, "traced": (traced_p, traced_g),
            "p": _events(prof_p), "gop": _events(prof_g)}


@pytest.fixture(scope="module")
def coded_rd():
    """The RD P frame 1 from frame 0, 4:2:0 and luma, untraced and traced."""
    at = [YuvFrame(*(p[t] for p in _clip())) for t in range(2)]
    plain = (video.encode_inter_frame_yuv(at[1], at[0], CFG_RD),
             loop.encode_inter_frame(at[1].y, at[0].y, CFG_RD))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof_yuv:
        traced_yuv = video.encode_inter_frame_yuv(at[1], at[0], CFG_RD)
    with torch.profiler.profile(activities=acts) as prof_luma:
        traced_luma = loop.encode_inter_frame(at[1].y, at[0].y, CFG_RD)
    return {"plain": plain, "traced": (traced_yuv, traced_luma),
            "yuv": _events(prof_yuv), "luma": _events(prof_luma)}


@pytest.fixture(scope="module", params=[3, 5], ids=["T3", "T5"])
def coded_b(request):
    """A closed-loop IBPBP GOP of T frames, untraced and traced."""
    clip = _clip(request.param)
    plain = video.encode_gop_closed_loop_yuv_b(clip, CFG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = video.encode_gop_closed_loop_yuv_b(clip, CFG)
    return {"t": request.param, "plain": plain, "traced": traced, "events": _events(prof)}


def test_span_is_one_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(*_):
        raise AssertionError("a span was recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    spans = {id(trace.span(name)) for name in trace.SPANS}
    assert len(spans) == 1
    assert isinstance(trace.span("hevcasm.luma"), contextlib.nullcontext)
    clip = _clip()
    video.encode_inter_frame_yuv(YuvFrame(*(p[1] for p in clip)),
                                 YuvFrame(*(p[0] for p in clip)), CFG)


def test_span_names_are_unique_and_prefixed():
    names = set(GOP_PARENT) | {name for name, _ in _b_gop_nest(1, 1)} | set(RD_PARENT)
    assert len(set(trace.SPANS)) == len(trace.SPANS) == len(names)
    assert set(trace.SPANS) == names
    assert all(name.startswith("hevcasm.") for name in trace.SPANS)


def test_spans_are_function_scope_host_ranges(coded):
    """cpu_op records at scope FUNCTION, as aten ops leave, never user
    annotations (which the profiler mirrors on a card as device records)."""
    function = int(torch._C._profiler.RecordScope.FUNCTION)
    events = coded["p"] + coded["gop"]
    assert events
    assert all(scope == function and not user for _, _, _, scope, user in events)


def test_every_recorded_name_is_in_SPANS(coded, coded_b, coded_rd):
    """Over a P frame, an IPPP GOP, an IBPBP GOP and an RD P frame, every
    name is recorded."""
    names = {e[0] for e in coded["p"] + coded["gop"] + coded_b["events"] + coded_rd["yuv"]}
    assert names <= set(trace.SPANS)
    assert names == set(trace.SPANS)


def test_p_frame_spans_nest_as_documented(coded):
    events = coded["p"]
    counts = {name: sum(e[0] == name for e in events) for name in P_PARENT}
    assert counts == P_COUNT
    for ev in events:
        assert _parent(ev, events) == P_PARENT[ev[0]], ev[0]


@pytest.mark.parametrize("name", trace.SPANS)
def test_gop_span_nests_as_documented(coded, name):
    """In an IPPP GOP: its spans once, the waves' and P frames' as counted,
    none of the B frame's or the IBPBP GOP's."""
    events = coded["gop"]
    mine = [e for e in events if e[0] == name]
    if name not in GOP_PARENT:
        want = 0
    elif name == "hevcasm.intra_wave":
        want = _waves()
    elif name in P_COUNT:
        want = (T - 1) * P_COUNT[name]
    else:
        want = 1
    assert len(mine) == want
    for ev in mine:
        assert _parent(ev, events) == GOP_PARENT[name]


@pytest.mark.parametrize("entry", [0, 1], ids=["inter_yuv", "gop_closed_yuv"])
def test_outputs_are_bit_identical_traced_and_untraced(coded, entry):
    plain, traced = coded["plain"][entry], coded["traced"][entry]
    assert plain.keys() == traced.keys()
    for key in plain:
        a, b = plain[key], traced[key]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and torch.equal(x, y), key


def test_b_gop_spans_nest_as_documented(coded_b):
    """Every span of an IBPBP GOP under its documented parent, as many as
    the GOP's frames, waves and planes give."""
    events = coded_b["events"]
    got = collections.Counter((ev[0], _parent(ev, events)) for ev in events)
    assert got == _b_gop_nest((coded_b["t"] - 1) // 2, _waves())


def test_b_gop_outputs_are_bit_identical_traced_and_untraced(coded_b):
    plain, traced = coded_b["plain"], coded_b["traced"]
    assert plain.keys() == traced.keys() == {"recon", "psnr_y"}
    assert traced["recon"].y.shape[0] == coded_b["t"]
    for a, b in [*zip(plain["recon"], traced["recon"]), (plain["psnr_y"], traced["psnr_y"])]:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("entry", ["yuv", "luma"])
def test_rd_p_frame_spans_nest_as_documented(coded_rd, entry):
    """The PU decision over its three steps and the TU decision, once a
    frame, inside the 4:2:0 frame's luma span or at the luma frame's top."""
    events = coded_rd[entry]
    parent = RD_PARENT if entry == "yuv" else RD_LUMA_PARENT
    counts = collections.Counter(e[0] for e in events)
    assert counts == {name: 2 if name in ("hevcasm.chroma_mc", "hevcasm.chroma_residual")
                      else 1 for name in parent}
    for ev in events:
        assert _parent(ev, events) == parent[ev[0]], ev[0]


@pytest.mark.parametrize("entry", [0, 1], ids=["inter_yuv", "inter_luma"])
def test_rd_outputs_are_bit_identical_traced_and_untraced(coded_rd, entry):
    plain, traced = coded_rd["plain"][entry], coded_rd["traced"][entry]
    assert plain.keys() == traced.keys()
    for key in plain:
        a, b = plain[key], traced[key]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and torch.equal(x, y), key
