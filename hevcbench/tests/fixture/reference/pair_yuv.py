"""A test-only entry point, the reference's side of ../entries/pair_yuv.py:
the closed-loop 4:2:0 I frame, then two P frames, each from the previous
reconstruction, the second at the configuration's QP + 1."""

import torch

#: pair_yuv's I frame is the closed-loop GOP's, whose luma is the wavefront:
#: the one intra mode it codes, and a field the reference alone does not.
FIELDS = {"intra_mode": ("wavefront",)}


def pair_yuv(ref, frames) -> dict:
    """frames: (y, cb, cr) stacks of 3 frames.  Returns {"recon": (y, cb, cr)
    stacks, "psnr_y": [3 floats]}."""
    if frames[0].shape[0] != 3:
        raise ValueError(f"pair_yuv codes 3 frames, not {frames[0].shape[0]}")
    out = ref.intra_seed_yuv(tuple(p[0] for p in frames))
    recs, psnrs = [tuple(out["recon"])], [out["psnr_y"]]
    for t, qp in ((1, None), (2, ref.qp + 1)):
        out = ref.inter_yuv(tuple(p[t] for p in frames), recs[-1], qp)
        recs.append(tuple(out["recon"]))
        psnrs.append(out["psnr_y"])
    return {"recon": tuple(torch.stack(p) for p in zip(*recs)), "psnr_y": psnrs}
