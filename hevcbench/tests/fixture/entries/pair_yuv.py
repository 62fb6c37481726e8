"""A test-only entry point, the program's side: the closed-loop 4:2:0 I frame,
then two P frames, each from the previous reconstruction, the second at the
configuration's QP + 1.  The reference's side is ../reference/pair_yuv.py."""

import torch


def pair_yuv(program, frames) -> dict:
    """frames: (y, cb, cr) stacks of 3 frames.  Returns {"recon": (y, cb, cr)
    stacks, "psnr_y": (3,)}."""
    from hevcasm_tpu_torch.encode import video

    if frames[0].shape[0] != 3:
        raise ValueError(f"pair_yuv codes 3 frames, not {frames[0].shape[0]}")
    out = program.intra_seed_yuv(tuple(p[0] for p in frames))
    recs, psnrs = [tuple(out["recon"])], [out["psnr_y"]]
    for t, qp in ((1, None), (2, program.cfg.qp + 1)):
        out = video.encode_inter_frame_yuv(video.YuvFrame(*(p[t] for p in frames)),
                                           video.YuvFrame(*recs[-1]), program.at(qp),
                                           program.tiers)
        recs.append(tuple(out["recon"]))
        psnrs.append(out["psnr_y"])
    return {"recon": tuple(torch.stack(p) for p in zip(*recs)), "psnr_y": torch.stack(psnrs)}
