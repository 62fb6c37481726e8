"""Reference-tier (plain PyTorch, exact integer) ops.

Importing this package registers every REF-tier op with the registry.
"""

from .. import registry
from ..config import Tier

from .ssd import ssd, ssd_grid
from .quantize import quantize, quantize_inverse, reconstruct
from .transform import (
    forward_transform,
    inverse_transform,
    inverse_transform_add,
    add_residual,
)
from .pred_inter import pred_uni, qpel_score, refine_qpel
from .residual import residual_pipeline

_REF_OPS = {
    "ssd": ssd,
    "ssd_grid": ssd_grid,
    "quantize": quantize,
    "quantize_inverse": quantize_inverse,
    "reconstruct": reconstruct,
    "forward_transform": forward_transform,
    "inverse_transform": inverse_transform,
    "inverse_transform_add": inverse_transform_add,
    "pred_uni": pred_uni,
    "refine_qpel": refine_qpel,
    "residual_pipeline": residual_pipeline,
}

for _name, _fn in _REF_OPS.items():
    registry.register(_name, Tier.REF, _fn)

__all__ = [
    "ssd", "ssd_grid",
    "quantize", "quantize_inverse", "reconstruct",
    "forward_transform", "inverse_transform", "inverse_transform_add",
    "add_residual",
    "pred_uni", "qpel_score", "refine_qpel",
    "residual_pipeline",
]
