"""One torch thread a test, as the benchmark runs: the tests' windows count
frames, and several test processes on one host would otherwise contend for
its cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
