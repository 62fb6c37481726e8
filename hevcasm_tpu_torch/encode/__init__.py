"""Encode loop of the port: CTU tiling (ctu), motion search (motion: the
full and the pyramid search, by SSD or SAD), the inter-frame inner loop
and its multi-reference form, the open-loop intra frame and the IPPP GOP
(loop), the closed-loop wavefront intra frame (intra_wavefront), the
PU-layout and TU-size decisions of the RDO frame (partition), the 4:2:0 I,
P and B frames and GOPs, open and closed loop (video), and rate control
(rate)."""

from .ctu import tile_frame, untile_frame, pad_frame
from .loop import (EncodeConfig, config_from_fields, encode_gop, encode_inter_frame,
                   encode_inter_frame_multiref, encode_intra_frame)
from .partition import PU_LAYOUTS, select_pu_layout, select_pu_layout_pruned, select_tu_recon
from .video import YuvFrame, chroma_qp, encode_b_frame_yuv, encode_inter_frame_yuv

__all__ = [
    "tile_frame",
    "untile_frame",
    "pad_frame",
    "EncodeConfig",
    "config_from_fields",
    "encode_inter_frame",
    "encode_inter_frame_multiref",
    "encode_intra_frame",
    "encode_gop",
    "PU_LAYOUTS",
    "select_pu_layout",
    "select_pu_layout_pruned",
    "select_tu_recon",
    "YuvFrame",
    "chroma_qp",
    "encode_inter_frame_yuv",
    "encode_b_frame_yuv",
]
