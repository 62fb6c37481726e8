"""Frame I/O and the CLI's encode: hevcasm_tpu_torch.io (Y4M and raw round
trips, the native reader against the numpy one, files written by
hevcasm_tpu.io read by the port and the reverse, the native library built
outside native/) and ``python -m hevcasm_tpu_torch encode --device cpu``,
synthetic and from a Y4M file, against hevcasm_tpu's encode on the CPU:
its JSON must carry the same keys and nnz and a PSNR within 1e-3 dB."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hevcasm_tpu import cli as jax_cli
from hevcasm_tpu import io as jax_io

from hevcasm_tpu_torch import cli
from hevcasm_tpu_torch import io as yio
from hevcasm_tpu_torch.encode import EncodeConfig
from hevcasm_tpu_torch.encode.video import YuvFrame, encode_gop_yuv

REPO = Path(__file__).resolve().parents[1]
PSNR_TOL_DB = 1e-3


def _frames(rng, t, h, w):
    return [yio.YuvArrays(rng.integers(0, 256, (h, w), dtype=np.uint8),
                          rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                          rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(t)]


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


def test_y4m_roundtrip(rng, tmp_path):
    frames = _frames(rng, 3, 64, 96)
    p = tmp_path / "clip.y4m"
    yio.write_y4m(p, frames, 96, 64, fps=(30, 1))
    assert yio.read_y4m(p)[:4] == (96, 64, 30, 1)
    assert_frames_equal(list(yio.iter_frames(p)), frames)


def test_raw_yuv_roundtrip(rng, tmp_path):
    frames = _frames(rng, 2, 32, 48)
    p = tmp_path / "clip.yuv"
    p.write_bytes(b"".join(plane.tobytes() for fr in frames for plane in fr))
    assert_frames_equal(list(yio.iter_frames(p, width=48, height=32)), frames)
    with pytest.raises(ValueError, match="width and height"):
        list(yio.iter_frames(p))


def test_native_path_equals_numpy_path(rng, tmp_path, monkeypatch):
    frames = _frames(rng, 2, 32, 64)
    p = tmp_path / "c.y4m"
    yio.write_y4m(p, frames, 64, 32, fps=(24, 1))
    native = list(yio.iter_frames(p)), yio.read_y4m(p)
    assert yio.last_path == "native"          # g++ is on every machine the tests run on
    monkeypatch.setattr(yio, "_native", lambda: None)
    numpy_ = list(yio.iter_frames(p)), yio.read_y4m(p)
    assert yio.last_path == "numpy"
    assert native[1] == numpy_[1]
    assert_frames_equal(native[0], numpy_[0])
    assert_frames_equal(numpy_[0], frames)


def test_files_cross_read_with_hevcasm_tpu(rng, tmp_path):
    frames = _frames(rng, 2, 64, 64)
    ours, theirs = tmp_path / "ours.y4m", tmp_path / "theirs.y4m"
    yio.write_y4m(ours, frames, 64, 64)
    jax_io.write_y4m(theirs, [jax_io.YuvArrays(*f) for f in frames], 64, 64)
    assert ours.read_bytes() == theirs.read_bytes()
    assert_frames_equal(list(yio.iter_frames(theirs)), frames)
    assert_frames_equal(list(jax_io.iter_frames(ours)), frames)
    assert yio.read_y4m(theirs) == jax_io.read_y4m(ours)


def test_native_library_is_built_outside_native(tmp_path):
    # The port builds its own copy of native/yuv_io.cpp under build/ and
    # never writes into native/, where hevcasm_tpu.io keeps its build (a
    # concurrent hevcasm_tpu test may build that one, so the port's own
    # writes are watched instead): a fresh process with an audit hook
    # records every file it opens for writing and every command it runs
    # while it builds into an empty directory and reads a clip.
    code = f"""
import sys
from pathlib import Path
events = []
def hook(event, args):
    if event == "open" and args[1] and any(c in str(args[1]) for c in "wax+"):
        events.append(("open", str(args[0])))
    elif event == "subprocess.Popen":
        events.append(("run", " ".join(map(str, args[1]))))
sys.addaudithook(hook)
import numpy as np
from hevcasm_tpu_torch import io as yio
yio._BUILD = Path({str(tmp_path / 'build')!r})
frames = [yio.YuvArrays(np.zeros((32, 32), np.uint8), np.ones((16, 16), np.uint8),
                        np.full((16, 16), 2, np.uint8))]
yio.write_y4m({str(tmp_path / 'c.y4m')!r}, frames, 32, 32)
got = list(yio.iter_frames({str(tmp_path / 'c.y4m')!r}))
assert yio.last_path == "native" and int(got[0].cr[0, 0]) == 2
print(repr(events))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    events = eval(proc.stdout.strip().splitlines()[-1])
    builds = [cmd.split() for kind, cmd in events if kind == "run" and "g++" in cmd]
    assert len(builds) == 1
    written = [cmd[cmd.index("-o") + 1] for cmd in builds]
    written += [path for kind, path in events if kind == "open"]
    assert written[0].startswith(str(tmp_path / "build"))
    assert not [path for path in written if path.startswith(str(REPO / "native"))]


def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_same_report(ours, theirs, psnr_key):
    assert set(ours) == set(theirs)
    for k in theirs:
        if k == psnr_key:
            assert abs(ours[k] - theirs[k]) <= PSNR_TOL_DB
        elif k != "output":
            assert ours[k] == theirs[k], k


SMALL = ["--frames", "2", "--width", "192", "--height", "128", "--search-range", "8"]


def test_cli_encode_synthetic_equals_hevcasm_tpu(capsys):
    ours = _cli_json(cli.main, ["encode", "--device", "cpu", *SMALL], capsys)
    theirs = _cli_json(jax_cli.main, ["encode", *SMALL], capsys)
    assert_same_report(ours, theirs, "psnr_db")
    assert ours["size"] == "192x128" and ours["nnz"] > 0


def test_cli_encode_y4m_equals_hevcasm_tpu_and_writes_the_reconstruction(tmp_path, capsys):
    rng = np.random.default_rng(7)
    # A panned smooth clip, 4:2:0, 130 x 200: cropped to 128 x 192.
    base = rng.integers(0, 256, (140, 210)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    frames = [yio.YuvArrays(base[2 * t:2 * t + 130, 3 * t:3 * t + 200],
                            base[t:t + 65, t:t + 100], base[:65, 2 * t:2 * t + 100])
              for t in range(3)]
    src = tmp_path / "in.y4m"
    yio.write_y4m(src, frames, 200, 130)
    args = ["encode", "--input", str(src), "--frames", "2", "--search-range", "8"]
    ours = _cli_json(cli.main, [*args, "--device", "cpu", "--output",
                                str(tmp_path / "ours.y4m")], capsys)
    theirs = _cli_json(jax_cli.main, [*args, "--output", str(tmp_path / "theirs.y4m")], capsys)
    assert_same_report(ours, theirs, "psnr_y_db")
    assert ours["output"] == str(tmp_path / "ours.y4m") and ours["size"] == "192x128"
    assert (tmp_path / "ours.y4m").read_bytes() == (tmp_path / "theirs.y4m").read_bytes()
    # The written reconstruction is encode_gop_yuv's.
    gop = YuvFrame(*(np.stack([p[:h, :w] for p in planes])
                     for planes, h, w in zip(zip(*frames[:2]), (128, 64, 64), (192, 96, 96))))
    want = encode_gop_yuv(gop, EncodeConfig(search_range=8), device="cpu")["recon"]
    assert_frames_equal(list(yio.iter_frames(tmp_path / "ours.y4m")),
                        [[p[t].numpy() for p in want] for t in range(2)])


def test_cli_encode_needs_a_card_or_an_explicit_cpu(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["encode", *SMALL])
