"""The content generator repeats exactly for a seed and differs between
seeds, at the sizes and motion the mix states."""

import torch

from hevcbench import content, run


def _pool(seed):
    _, _, _, mix = run.load_cell("ldp1080_live")
    params = dict(mix["content"], frames=6)
    return content.make_pool(256, 120, 128, params, seed, "cpu")


def test_same_seed_same_pool():
    a, b = _pool(2**31 + 5), _pool(2**31 + 5)
    assert [p.shape for p in a] == [(6, 128, 256), (6, 64, 128), (6, 64, 128)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_seeds_differ_and_frames_differ():
    a, b = _pool(3), _pool(4)
    assert not torch.equal(a[0], b[0])
    y = a[0].to(torch.int32)
    assert all(not torch.equal(y[i], y[i + 1]) for i in range(5))
    # Coded rows past the source's are edge-padded copies of its last row.
    assert torch.equal(a[0][:, 120:], a[0][:, 119:120].expand(-1, 8, -1))
    assert torch.equal(a[1][:, 60:], a[1][:, 59:60].expand(-1, 4, -1))
    assert float(y.float().std()) > 10


def test_ping_pong():
    walk = [content.ping_pong(t, 4) for t in range(10)]
    assert walk == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
