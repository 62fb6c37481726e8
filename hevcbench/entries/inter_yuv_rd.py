"""The 4:2:0 RD P frame, the program's side: the port's
encode_inter_frame_yuv with its PU decision (pu_decision, pu_layouts) and
TU decision (tu_sizes) at the frame's QP and the tiers.  The reference's
side is ../reference/inter_yuv_rd.py."""


def inter_yuv_rd(program, cur, ref, qp: int | None = None) -> dict:
    """cur, ref: (y, cb, cr) planes.  Returns {"recon": (y, cb, cr), "mvs":
    the MV field (n, k, k, 2) quarter-pel, each PU tile's, "nnz", "psnr_y",
    "psnr_cb", "psnr_cr"}."""
    from hevcasm_tpu_torch.encode import video

    out = video.encode_inter_frame_yuv(video.YuvFrame(*cur), video.YuvFrame(*ref),
                                       program.at(qp), program.tiers)
    return {"recon": tuple(out["recon"]), "mvs": out["mv_field"], "nnz": out["nnz"],
            "psnr_y": out["psnr_y"], "psnr_cb": out["psnr_cb"], "psnr_cr": out["psnr_cr"]}
