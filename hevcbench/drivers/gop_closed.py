"""Closed-loop 4:2:0 GOPs with a random-access point at each: a call codes
a whole GOP of the mix's length (the I frame, then each P frame from the
previous reconstruction) by encode_gop_closed_loop_yuv, cycling the pool's
consecutive chunks of that length, and reads the GOP's luma PSNRs to the
host at its end.  Set-up codes the mix's warm-up GOPs.  A mix's "entry"
names another entry point with gop_yuv's inputs and outputs ((y, cb, cr)
stacks in; {"recon": stacks, "psnr_y": a value a frame} out) for the
driver to call on both sides.

The check: a sample, drawn from the seed, of the window's GOPs.  The
reference codes each sampled GOP again from its source frames alone, I
frame and the whole chain of P frames, and every frame's reconstruction
and PSNR, as returned and as read to the host, are compared."""

from __future__ import annotations

import random
import time

import torch

from ..compare import Checks


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.entry = ctx.mix.get("entry", "gop_yuv")
        self.code = getattr(ctx.api, self.entry)
        self.length = ctx.mix["gop"]
        self.frames_per_step = self.length
        self.chunks = ctx.pool[0].shape[0] // self.length
        self.rng = random.Random(ctx.seed)
        self.sample: list = []
        self.seen = 0
        self.g = 0
        self.keys = ({"recon_px": [("recon", i) for i in range(3)]}, {},
                     {"psnr_db": ["psnr", "psnr_host"]})

    def frames(self, g: int):
        c = g % self.chunks
        return tuple(p[c * self.length:(c + 1) * self.length] for p in self.ctx.pool)

    def setup(self) -> None:
        for _ in range(self.ctx.mix["warmup_steps"]):
            self.step(None)

    def step(self, spans) -> int:
        frames = self.frames(self.g)
        t0 = time.perf_counter()
        out = self.code(frames)
        t1 = time.perf_counter()
        out["psnr_host"] = torch.as_tensor(out["psnr_y"]).tolist()
        t2 = time.perf_counter()
        if spans is not None:
            spans.append(("call", t0, t1))
            spans.append(("gop", t0, t2))
            self._offer((self.g, out))
        self.g += 1
        return self.length * self.ctx.ctus_per_frame

    def _offer(self, item) -> None:
        """Reservoir sampling of the window's GOPs, from the seed."""
        k = self.ctx.mix["check_gops"]
        if self.seen < k:
            self.sample.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < k:
                self.sample[j] = item
        self.seen += 1

    def release(self) -> None:
        pass

    def _frame(self, out: dict, t: int, host: str) -> dict:
        return {"recon": tuple(p[t] for p in out["recon"]), "psnr": out["psnr_y"][t],
                "psnr_host": out[host][t]}

    def check(self, reference) -> Checks:
        checks = Checks()
        for g, out in sorted(self.sample, key=lambda item: item[0]):
            want = getattr(reference, self.entry)(self.frames(g))
            for t in range(self.length):
                checks.answer(self._frame(out, t, "psnr_host"), self._frame(want, t, "psnr_y"),
                              *self.keys)
        return checks
