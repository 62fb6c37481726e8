"""The system under test: hevcasm_tpu_torch's entry points, under the names
the drivers call and the reference also answers to.

Only this module, the program's side of the entry points that a
configuration names (``entries/<name>.py``, found by ``lookup``) and the
kernel metrics' launch counters touch the program; the program is imported
when ``Program`` is built, after the harness has looked for the card."""

from __future__ import annotations

import dataclasses

from . import lookup


class Program:
    """The port's entry points at one configuration.

    encode: the configuration file's "encode" fields (EncodeConfig's);
    tiers: "ALL" runs the CUDA kernels on the card, "REF" the plain
    versions (what the CPU tests run); entries: the configuration's
    "entries", each bound as entry points under its functions' names
    (``lookup.bind``).  A frame entry's ``qp`` replaces the configuration's
    for that frame."""

    def __init__(self, encode: dict, tiers: str = "ALL", entries=(), dirs=lookup.DIRS):
        from hevcasm_tpu_torch.config import Tier
        from hevcasm_tpu_torch.encode import loop, video

        self.cfg = loop.EncodeConfig(**encode)
        self.tiers = Tier[tiers]
        self._video = video
        self._cfgs = {self.cfg.qp: self.cfg}
        lookup.bind(self, entries, "entries", dirs)

    def at(self, qp: int | None):
        """The configuration at a frame's ``qp`` (None: the configuration's)."""
        if qp is None:
            return self.cfg
        if qp not in self._cfgs:
            self._cfgs[qp] = dataclasses.replace(self.cfg, qp=qp)
        return self._cfgs[qp]

    def inter_yuv(self, cur, ref, qp: int | None = None) -> dict:
        yuv = self._video.YuvFrame
        return self._video.encode_inter_frame_yuv(yuv(*cur), yuv(*ref), self.at(qp),
                                                  self.tiers)

    def intra_seed_yuv(self, cur) -> dict:
        """The closed-loop 4:2:0 GOP's I frame: encode_gop_closed_loop_yuv
        on a GOP of one frame."""
        frames = self._video.YuvFrame(*(p[None] for p in cur))
        out = self._video.encode_gop_closed_loop_yuv(frames, self.cfg, self.tiers)
        return {"recon": tuple(p[0] for p in out["recon"]), "psnr_y": out["psnr_y"][0]}

    def gop_yuv(self, frames) -> dict:
        """encode_gop_closed_loop_yuv on (y, cb, cr) stacks of the GOP's
        frames: {"recon": (y, cb, cr) stacks, "psnr_y": (T,)}."""
        out = self._video.encode_gop_closed_loop_yuv(self._video.YuvFrame(*frames), self.cfg,
                                                     self.tiers)
        return {"recon": tuple(out["recon"]), "psnr_y": out["psnr_y"]}
