"""Seeded synthetic video, made on the device in set-up.

A pool of distinct frames, each a window onto a textured canvas:

* the canvas: uniform noise at several scales (octaves), each upsampled
  bilinearly to the canvas and weighted, then smoothed twice by a 3x3 box;
* a global pan at a sub-pel velocity, sampled bilinearly, so that the
  quarter-pel refinement picks non-zero fractions;
* independently moving textured objects, pasted opaque at whole-pel
  positions that reflect off the picture's edges;
* fresh sensor noise on every frame, so that residuals do not quantize to
  zero.

A mix gives its velocities and sizes per 1920 pixels of width; they scale
with the frame.  Chroma planes (4:2:0) have canvases of their own at half
resolution and follow the same motion at half the distance.  Frames are
edge-padded at the bottom to the coded height, as an encoder pads to whole
CTUs.  The same seed gives the same pool on the same device; the sizes and
the amount of motion do not depend on the seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _texture(h: int, w: int, octaves, contrast: float, g: torch.Generator, device):
    """(h, w) float32 texture: weighted noise octaves, smoothed, scaled to
    mean 128 and the given standard deviation."""
    t = torch.zeros((1, 1, h, w), device=device)
    for scale, weight in octaves:
        coarse = torch.rand((1, 1, h // scale + 2, w // scale + 2), generator=g,
                            device=device)
        t += weight * F.interpolate(coarse, size=(h + 2 * scale, w + 2 * scale),
                                    mode="bilinear", align_corners=False)[
            ..., scale:scale + h, scale:scale + w]
    for _ in range(2):
        t = F.avg_pool2d(t, 3, stride=1, padding=1, count_include_pad=False)
    t = (t - t.mean()) / t.std().clamp_min(1e-6)
    return (128 + contrast * t)[0, 0]


def _reflect(p: float, span: int) -> int:
    """A position moving on a line, reflected into [0, span]."""
    if span <= 0:
        return 0
    p = p % (2 * span)
    return int(round(p if p <= span else 2 * span - p))


def make_pool(width: int, height: int, coded_height: int, params: dict, seed: int,
              device) -> list[torch.Tensor]:
    """The 4:2:0 pool: one (frames, coded rows, columns) uint8 tensor per
    plane, luma, cb, cr."""
    frames = params["frames"]
    k = width / 1920
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    host = torch.Generator()
    host.manual_seed(seed)

    def uniform(lo, hi, n):
        return (lo + (hi - lo) * torch.rand(n, generator=host)).tolist()

    vy, vx = (v * k for v in params["pan_px_per_frame"])
    num = params["objects"]
    lo, hi = (s * k for s in params["object_px"])
    sizes = list(zip(uniform(lo, hi, num), uniform(lo, hi, num)))
    starts = list(zip(uniform(0, height, num), uniform(0, width, num)))
    vmax = params["object_speed_px"] * k
    speeds = list(zip(uniform(-vmax, vmax, num), uniform(-vmax, vmax, num)))
    octaves = [(max(1, round(s * k)), wt) for s, wt in params["octaves"]]
    noise = params["noise"]

    pool = []
    for sub in (1, 2, 2):
        h, w, ch = height // sub, width // sub, coded_height // sub
        pvy, pvx = vy / sub, vx / sub
        canvas = _texture(h + math.ceil(abs(pvy) * frames) + 2,
                          w + math.ceil(abs(pvx) * frames) + 2,
                          [(max(1, s // sub), wt) for s, wt in octaves],
                          params["contrast"], g, device)
        objects = []
        for (oh, ow), (sy, sx), (uy, ux) in zip(sizes, starts, speeds):
            oh, ow = max(2, int(oh / sub)), max(2, int(ow / sub))
            tex = _texture(oh, ow, [(max(1, s // (4 * sub)), wt) for s, wt in octaves],
                           params["contrast"], g, device)
            objects.append((tex, sy / sub, sx / sub, uy / sub, ux / sub))
        out = torch.empty((frames, ch, w), dtype=torch.uint8, device=device)
        for f in range(frames):
            oy = pvy * f if pvy >= 0 else abs(pvy) * (frames - f)
            ox = pvx * f if pvx >= 0 else abs(pvx) * (frames - f)
            iy, ix = int(oy), int(ox)
            fy, fx = oy - iy, ox - ix
            c = canvas[iy:iy + h + 1, ix:ix + w + 1]
            img = ((1 - fy) * (1 - fx) * c[:-1, :-1] + (1 - fy) * fx * c[:-1, 1:]
                   + fy * (1 - fx) * c[1:, :-1] + fy * fx * c[1:, 1:])
            for tex, sy, sx, uy, ux in objects:
                th, tw = tex.shape
                y = _reflect(sy + uy * f, h - th)
                x = _reflect(sx + ux * f, w - tw)
                img[y:y + th, x:x + tw] = tex[:h - y, :w - x]
            img = img + torch.randint(-noise, noise + 1, (h, w), generator=g,
                                      device=device)
            plane = img.round().clamp(0, 255).to(torch.uint8)
            out[f, :h] = plane
            out[f, h:] = plane[-1]
        pool.append(out)
    return pool


def ping_pong(t: int, frames: int) -> int:
    """Pool index of stream frame t: forward through the pool, then back,
    so that consecutive frames always differ by continuous motion."""
    period = 2 * (frames - 1)
    k = t % period
    return k if k < frames else period - k
