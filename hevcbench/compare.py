"""The comparison that decides ``correct``: the program's outputs against
the reference's, number by number, each against its limit.

Integer outputs (reconstructed samples, MVs, best scores, nnz) are compared
exactly: the number is how many differ, or by how much in all, and its
limit is 0.  PSNR is a float32 that the program rounds from its float64
value; the number is the widest gap to the reference's float64 value in dB,
and its limit lies between what sound runs and the control read
(PERF.md, section 2)."""

from __future__ import annotations

import torch

#: Widest |PSNR gap| in dB that a sound run may show (PERF.md, section 2).
PSNR_LIMIT_DB = 1e-3


class Checks:
    """Numbers compared over every checked answer: exact counts summed,
    gaps at their widest, and the answers checked and found wrong."""

    def __init__(self):
        self.numbers: dict[str, list] = {}
        self.checked = 0
        self.failed = 0

    def _add(self, name: str, value, limit, widest: bool) -> bool:
        old = self.numbers.get(name)
        if old is None:
            self.numbers[name] = [value, limit]
        else:
            old[0] = max(old[0], value) if widest else old[0] + value
        return value <= limit

    def answer(self, got: dict, want: dict, planes: dict, exact: dict, psnr: dict) -> None:
        """One checked answer (a frame): ``planes`` maps a check's name to
        the output keys of sample planes, ``exact`` a name to integer
        output keys, ``psnr`` a name to PSNR keys; keys index got and
        want."""
        ok = True
        for name, keys in planes.items():
            n = sum(int((_long(got, k) != _long(want, k)).sum()) for k in keys)
            ok &= self._add(name, n, 0, False)
        for name, keys in exact.items():
            n = sum(int((_long(got, k) - _long(want, k)).abs().sum()) for k in keys)
            ok &= self._add(name, n, 0, False)
        for name, keys in psnr.items():
            gap = max(abs(float(_get(got, k)) - float(_get(want, k))) for k in keys)
            ok &= self._add(name, gap, PSNR_LIMIT_DB, True)
        self.checked += 1
        self.failed += not ok

    @property
    def correct(self) -> bool:
        return self.checked > 0 and all(v <= lim for v, lim in self.numbers.values())


def _get(d, key):
    """d[key], where a key (name, i) indexes the i-th element of d[name]."""
    if isinstance(key, tuple):
        name, i = key
        return d[name][i]
    return d[key]


def _long(d, key) -> torch.Tensor:
    v = _get(d, key)
    return (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).to(torch.int64).cpu()
