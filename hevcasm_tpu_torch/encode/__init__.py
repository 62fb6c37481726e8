"""Encode loop of the port: CTU tiling (ctu), motion search (motion) and
the inter-frame inner loop (loop)."""

from .ctu import tile_frame, untile_frame, pad_frame
from .loop import EncodeConfig, config_from_fields, encode_inter_frame

__all__ = [
    "tile_frame",
    "untile_frame",
    "pad_frame",
    "EncodeConfig",
    "config_from_fields",
    "encode_inter_frame",
]
