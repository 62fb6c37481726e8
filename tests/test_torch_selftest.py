"""hevcasm_tpu_torch's self-test against hevcasm_tpu's on the CPU: the same
fixtures, the port's REF outputs equal to JAX's REF outputs on every
non-frame suite (values and dtypes), run_suite's error counting, the
--json records, the CLI's options and the device rule.  The KERNEL tier of
the self-test runs on the card only (test_torch_cuda.py, chip_smoke.py)."""

import json

import numpy as np
import pytest
import torch

from hevcasm_tpu import registry as jregistry
from hevcasm_tpu import selftest as jselftest
from hevcasm_tpu.config import Tier as JTier

import torch_testing  # noqa: F401
from hevcasm_tpu_torch import Tier, registry, selftest
from hevcasm_tpu_torch.cli import main as cli_main
from hevcasm_tpu_torch.utils import timing

FRAME_SUITES = {"sad_grid_frame", "ssd_grid_frame", "refine_qpel", "residual_pipeline"}
FAST_SUITES = [s.name for s in selftest.SUITES if s.name not in FRAME_SUITES]


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    return [out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)]


def test_suites_mirror_jax():
    assert [(s.name, s.op) for s in selftest.SUITES] == \
        [(s.name, s.op) for s in jselftest.SUITES]
    assert selftest.PARTITIONS == jselftest.PARTITIONS
    assert selftest.FRAME_CTUS == jselftest.FRAME_CTUS
    assert selftest._SEED == jselftest._SEED


@pytest.mark.parametrize("index", range(len(selftest.SUITES)),
                         ids=[s.name for s in selftest.SUITES])
def test_fixtures_equal_jax(index):
    ours = selftest.SUITES[index].cases(np.random.default_rng(selftest._SEED))
    theirs = jselftest.SUITES[index].cases(np.random.default_rng(jselftest._SEED))
    assert [c.name for c in ours] == [c.name for c in theirs]
    for a, b in zip(ours, theirs):
        assert (a.iters, a.heavy) == (b.iters, b.heavy), a.name
        assert len(a.args) == len(b.args)
        for x, y in zip(a.args, b.args):
            assert type(x) is type(y), a.name
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=a.name)


@pytest.mark.parametrize("name", FAST_SUITES)
def test_ref_outputs_equal_jax_ref(name):
    suite = next(s for s in selftest.SUITES if s.name == name)
    ours = registry.get_tier(suite.op, Tier.REF)
    theirs = jregistry.get_tier(suite.op, JTier.REF)
    assert ours is not None and theirs is not None
    cpu = torch.device("cpu")
    for case in suite.cases(np.random.default_rng(selftest._SEED)):
        got = _leaves(ours(*(selftest._on(a, cpu) for a in case.args)))
        want = _leaves(theirs(*case.args))
        assert len(got) == len(want), case.name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, (case.name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {case.name}")


def test_every_non_frame_suite_passes_on_the_cpu(capsys):
    # The CLI's `selftest --device cpu --tiers ref --no-time` over these
    # suites (by name: --suites sad_grid would also select its frame suite).
    errors = sum(selftest.run_suite(s, Tier.REF, time_it=False, device="cpu")
                 for s in selftest.SUITES if s.name in FAST_SUITES)
    assert errors == 0
    out = capsys.readouterr().out
    assert out.count("REF:ok") == sum(
        len(s.cases(np.random.default_rng(0))) for s in selftest.SUITES if s.name in FAST_SUITES)


def test_views_stay_views_on_the_device():
    base = np.arange(128 * 128, dtype=np.uint32).astype(np.uint8).reshape(128, 128)
    view = base[1:13, 1:17]
    got = selftest._on(view, torch.device("cpu"))
    assert tuple(got.shape) == (12, 16) and got.stride() == (128, 1)
    assert not got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), view)
    refs = np.arange(4 * 32 * 32, dtype=np.uint32).astype(np.uint8).reshape(4, 32, 32)
    np.testing.assert_array_equal(selftest._on(refs[:, :8, :4], torch.device("cpu")).numpy(),
                                  refs[:, :8, :4])
    corner = selftest._on(np.uint8(7), torch.device("cpu"))
    assert corner.dim() == 0 and corner.dtype == torch.uint8 and int(corner) == 7
    assert selftest._on(3, torch.device("cpu")) == 3


@pytest.fixture
def fake_card(monkeypatch):
    """run_suite as on a card: the KERNEL tier usable, fixtures passed as
    they are, and the probe op's tiers registered only for the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(selftest, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(selftest, "_on", lambda x, dev: x)

    def register(ref, kernel=None):
        monkeypatch.setitem(registry._REGISTRY, ("probe", Tier.REF), ref)
        if kernel is not None:
            monkeypatch.setitem(registry._REGISTRY, ("probe", Tier.KERNEL), kernel)

    return register


PROBE = selftest.Suite("probe", lambda rng: [selftest.Case("a", (torch.arange(4),)),
                                             selftest.Case("b", (torch.arange(6),))])


def _unimplemented(x):
    raise NotImplementedError


def _broken(x):
    raise ValueError("broken")


@pytest.mark.parametrize("kernel,errors,records", [
    (lambda x: (x * 2, x.sum()), 0, [True, True]),
    (lambda x: (x * 2, x.sum() + (x.numel() == 6)), 1, [True, False]),
    (lambda x: (x * 2,), 2, [False, False]),
    (_unimplemented, 0, []),
    (_broken, 2, ["ValueError", "ValueError"]),
])
def test_run_suite_counts_errors(fake_card, capsys, kernel, errors, records):
    fake_card(lambda x: (x * 2, x.sum()), kernel)
    recs = []
    assert selftest.run_suite(PROBE, Tier.ALL, time_it=False, records=recs) == errors
    kernel_recs = [r for r in recs if r["tier"] == "KERNEL"]
    assert [r.get("error", r.get("match")) for r in kernel_recs] == records
    assert all(r["match"] for r in recs if r["tier"] == "REF")
    out = capsys.readouterr().out
    if errors and records[-1] is False:
        assert "-MISMATCH" in out
    if records and records[0] == "ValueError":
        assert "KERNEL:ERROR(ValueError)" in out


def test_run_suite_without_ref_counts_one_error(fake_card, capsys):
    assert selftest.run_suite(selftest.Suite("no_such_op", PROBE.cases)) == 1
    assert "no REF tier registered" in capsys.readouterr().out


def test_run_suite_times_each_tier(fake_card):
    fake_card(lambda x: x * 2, lambda x: x + x)
    recs = []
    assert selftest.run_suite(PROBE, Tier.ALL, verbose=False, records=recs) == 0
    assert [r["tier"] for r in recs] == ["REF", "KERNEL"] * 2
    assert all(r["time_us"] >= 0 for r in recs)
    assert all("speedup_vs_ref" in r for r in recs if r["tier"] == "KERNEL")


def test_cpu_run_skips_the_kernel_tier_and_writes_json_records(tmp_path, capsys):
    path = tmp_path / "st.json"
    assert selftest.main(suites=["satd"], json_path=str(path), device="cpu") == 0
    payload = json.loads(path.read_text())
    assert payload["errors"] == 0
    recs = payload["results"]
    assert [(r["op"], r["case"], r["tier"]) for r in recs] == \
        [("satd", c, "REF") for c in ("8x8", "4x4", "2x2")]
    for r in recs:
        assert set(r) == {"op", "case", "tier", "match", "time_us", "speedup_vs_ref"}
        assert r["match"] and r["speedup_vs_ref"] == 1.0
    assert "self test passed" in capsys.readouterr().out
    assert selftest.main(time_it=False, suites=["ssd_linear"], json_path="-",
                         device="cpu") == 0
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed == {"errors": 0, "results": [
        {"op": "ssd_linear", "case": "0x200", "tier": "REF", "match": True}]}


def test_no_card_raises_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selftest.main(suites=["satd"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["selftest", "--suites", "satd", "--no-time"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([])
    assert selftest.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("tiers,rc", [("ref", 0), ("REF, kernel", 0), ("kernel", 0),
                                      ("ref,pallas", 2), ("jit", 2)])
def test_cli_tiers(capsys, tiers, rc):
    argv = ["selftest", "--tiers", tiers, "--no-time", "--suites", "satd", "--device", "cpu"]
    assert cli_main(argv) == rc
    captured = capsys.readouterr()
    if rc:
        assert "unknown tier" in captured.err and "valid: ref, kernel" in captured.err
    else:
        assert "self test passed" in captured.out
        assert ("REF:ok" in captured.out) == ("ref" in tiers.lower())


def test_cli_passes_every_option(monkeypatch):
    seen = {}
    monkeypatch.setattr(selftest, "main", lambda **kw: seen.update(kw) or 0)
    assert cli_main(["selftest", "--tiers", "kernel", "--suites", "sad,pred_uni",
                     "--converged", "--json", "-", "--device", "cuda:0"]) == 0
    assert seen == {"mask": Tier.KERNEL, "time_it": True, "suites": ["sad", "pred_uni"],
                    "json_path": "-", "converged": True, "device": "cuda:0"}
    seen.clear()
    assert cli_main([]) == 0
    assert seen == {"mask": Tier.ALL, "time_it": True, "suites": None, "json_path": None,
                    "converged": False, "device": None}


@pytest.mark.parametrize("fn", [timing.time_fn, timing.time_fn_converged])
def test_timing_on_the_host_clock(fn):
    calls = []
    t = fn(lambda x: calls.append(x) or x, torch.zeros(3))
    assert t >= 0 and len(calls) >= 3
    assert timing.gbps(2e9, 2.0) == 1.0 and timing.gops(3e9, 1.5) == 2.0
