"""A live encoder: one closed-loop 4:2:0 stream, a frame a call.

Set-up codes frame 0 as the closed-loop I frame (the closed-loop GOP's I
frame, encode_gop_closed_loop_yuv on one frame) and the mix's warm-up P
frames.  Each step then codes the next frame of the pool's ping-pong walk
as a P frame from the previous frame's reconstruction
(encode_inter_frame_yuv) and reads the outputs an encoder writes, nnz and
the PSNRs, to the host: the frame's latency ends there.  The P
frame of picture order t takes the configuration's QP plus its
``qp_offsets[(t - 1) % len(qp_offsets)]`` (the offsets by position in a
low-delay GOP), or the configuration's QP where it gives none; the mix's
warm-up covers every offset.  A mix's "entry" names another entry point
with inter_yuv's inputs and outputs for the driver to call on both sides.

The check: the I frame against the reference's from the same source, then
a sample, drawn from the seed, of pairs of consecutive window frames (t -
1, t).  The reference codes frame t - 1 from the program's reconstruction
of t - 2 (the program's own state: the closed loop cannot be recomputed
from its start within a run), and frame t from its own reconstruction of
t - 1, so the chaining is checked too."""

from __future__ import annotations

import random
import time

import torch

from .. import content
from ..compare import Checks

# What a window frame's check compares; "_host" keys are the values the
# step read to the host.
PLANES = {"recon_px": [("recon", 0), ("recon", 1), ("recon", 2)]}
P_FRAME = {"planes": PLANES, "exact": {"mv": ["mvs"], "nnz": ["nnz", "nnz_host"]},
           "psnr": {"psnr_db": ["psnr_y", "psnr_cb", "psnr_cr", "psnr_y_host", "psnr_cb_host",
                                "psnr_cr_host"]}}
I_FRAME = {"planes": PLANES, "exact": {}, "psnr": {"psnr_db": ["psnr_y"]}}


def host_values(values) -> list[float]:
    """Read numbers to the host, tensors in one copy."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([v.to(torch.float64) for v in values]).tolist()
    return [float(v) for v in values]


class Driver:
    frames_per_step = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.entry = ctx.mix.get("entry", "inter_yuv")
        self.code = getattr(ctx.api, self.entry)
        self.outs = ("nnz", "psnr_y", "psnr_cb", "psnr_cr")
        self.rng = random.Random(ctx.seed)
        self.sample: list = []
        self.pairs = 0
        self.t = 0
        self.offsets = ctx.config.get("qp_offsets") or []
        self.base_qp = ctx.config["encode"]["qp"]

    def qp(self, t: int) -> int | None:
        """The QP of the P frame of picture order t."""
        if not self.offsets:
            return None
        return self.base_qp + self.offsets[(t - 1) % len(self.offsets)]

    def frame(self, t: int):
        i = content.ping_pong(t, self.ctx.pool[0].shape[0])
        return tuple(p[i] for p in self.ctx.pool)

    def setup(self) -> None:
        self.start = self.ctx.api.intra_seed_yuv(self.frame(0))
        self.prev_ref, self.prev = None, self.start
        self.t = 1
        for _ in range(self.ctx.mix["warmup_steps"]):
            self.step(None)

    def step(self, spans) -> int:
        ref = tuple(self.prev["recon"])
        cur = self.frame(self.t)
        t0 = time.perf_counter()
        out = self.code(cur, ref, self.qp(self.t))
        t1 = time.perf_counter()
        out.update(zip([k + "_host" for k in self.outs],
                       host_values([out[k] for k in self.outs])))
        t2 = time.perf_counter()
        if spans is not None:
            spans.append(("call", t0, t1))
            spans.append(("frame", t0, t2))
            if self.prev_ref is not None:       # frame t - 1 was a P frame
                self._offer((self.t, self.prev_ref, self.prev, out))
        self.prev_ref, self.prev = ref, out
        self.t += 1
        return self.ctx.ctus_per_frame

    def _offer(self, item) -> None:
        """Reservoir sampling of the window's frame pairs, from the seed."""
        k = self.ctx.mix["check_pairs"]
        if self.pairs < k:
            self.sample.append(item)
        else:
            j = self.rng.randrange(self.pairs + 1)
            if j < k:
                self.sample[j] = item
        self.pairs += 1

    def release(self) -> None:
        self.prev_ref = self.prev = None

    def check(self, reference) -> Checks:
        checks = Checks()
        checks.answer(self.start, reference.intra_seed_yuv(self.frame(0)), **I_FRAME)
        code = getattr(reference, self.entry)
        for t, ref2, out1, out2 in sorted(self.sample, key=lambda item: item[0]):
            want1 = self._with_host(code(self.frame(t - 1), ref2, self.qp(t - 1)))
            checks.answer(out1, want1, **P_FRAME)
            want2 = self._with_host(code(self.frame(t), tuple(want1["recon"]), self.qp(t)))
            checks.answer(out2, want2, **P_FRAME)
        return checks

    def _with_host(self, want: dict) -> dict:
        return {**want, **{k + "_host": want[k] for k in self.outs}}
