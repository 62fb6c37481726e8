"""The closed-loop 4:2:0 IBPBP GOP, the program's side: the port's
encode_gop_closed_loop_yuv_b at the configuration and tiers.  The
reference's side is ../reference/gop_yuv_b.py."""


def gop_yuv_b(program, frames) -> dict:
    """frames: (y, cb, cr) stacks of an odd number of frames, display order
    I B P B ... P.  Returns {"recon": (y, cb, cr) stacks in display order,
    "psnr_y": (T,)}."""
    from hevcasm_tpu_torch.encode import video

    out = video.encode_gop_closed_loop_yuv_b(video.YuvFrame(*frames), program.cfg,
                                             program.tiers)
    return {"recon": tuple(out["recon"]), "psnr_y": out["psnr_y"]}
