"""The port's test harness itself: every port test file runs torch on one
thread (it imports tests/torch_testing.py), and importing torch_testing
imports no jax, so that files run with --noconftest on the card can use
it."""

import os
import re
import subprocess
import sys

import torch_testing

IMPORTS_IT = re.compile(r"^(import torch_testing\b|from torch_testing import )", re.M)
ONE_THREAD_FIXTURE = re.compile(r"^def one_thread\(", re.M)


def test_every_port_test_runs_on_one_thread():
    # tests/test_torch_cuda.py runs only on the card, with --noconftest.
    files = sorted(p for p in torch_testing.TESTS.glob("test_torch_*.py")
                   if p.name != "test_torch_cuda.py")
    assert len(files) > 40
    missing = [p.name for p in files if not IMPORTS_IT.search(p.read_text())]
    assert not missing, f"no import of torch_testing in {missing}"
    fixtures = [p.name for p in torch_testing.TESTS.rglob("*.py")
                if ONE_THREAD_FIXTURE.search(p.read_text())]
    assert not fixtures, f"a one_thread fixture of its own in {fixtures}"


def test_torch_testing_imports_no_jax():
    code = ("import sys, torch, torch_testing; "
            "assert torch.get_num_threads() == 1, torch.get_num_threads(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))")
    path = os.pathsep.join([str(torch_testing.TESTS.parent), str(torch_testing.TESTS),
                            os.environ.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": path},
                         capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
