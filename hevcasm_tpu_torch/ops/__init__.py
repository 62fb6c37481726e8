"""Reference-tier (plain PyTorch, exact integer) ops.

Importing this package registers every REF-tier op with the registry.
"""

from .. import registry
from ..config import Tier

from .ssd import ssd, ssd_grid
from .sad import sad, sad_multiref, sad_grid
from .quantize import quantize, quantize_inverse, reconstruct
from .transform import (
    forward_transform,
    inverse_transform,
    inverse_transform_add,
    add_residual,
)
from .pred_inter import (pred_uni, pred_uni_16, pred_bi, qpel_score, qpel_costmap,
                         refine_qpel_costmap_mxu, refine_qpel)
from .residual import residual_pipeline, residual_pipeline_frame

_REF_OPS = {
    "ssd": ssd,
    "ssd_grid": ssd_grid,
    "sad": sad,
    "sad_multiref": sad_multiref,
    "sad_grid": sad_grid,
    "quantize": quantize,
    "quantize_inverse": quantize_inverse,
    "reconstruct": reconstruct,
    "forward_transform": forward_transform,
    "inverse_transform": inverse_transform,
    "inverse_transform_add": inverse_transform_add,
    "pred_uni": pred_uni,
    "pred_bi": pred_bi,
    "refine_qpel": refine_qpel,
    "residual_pipeline": residual_pipeline,
}

for _name, _fn in _REF_OPS.items():
    registry.register(_name, Tier.REF, _fn)

__all__ = [
    "ssd", "ssd_grid", "sad", "sad_multiref", "sad_grid",
    "quantize", "quantize_inverse", "reconstruct",
    "forward_transform", "inverse_transform", "inverse_transform_add",
    "add_residual",
    "pred_uni", "pred_uni_16", "pred_bi", "qpel_score", "qpel_costmap",
    "refine_qpel_costmap_mxu", "refine_qpel",
    "residual_pipeline", "residual_pipeline_frame",
]
